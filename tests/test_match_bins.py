"""The mapper's sparse match bins (core/mapper.py::MatchBins) against the
dense n x n lists they replace, and the table packer's one extraction of
the indexer's entries a build (ops/index.py::build_packed_index)."""

import copy

import numpy as np
import pytest

from genefuserust_tpu_torch.config import Settings
from genefuserust_tpu_torch.core.indexer import GenePos
from genefuserust_tpu_torch.core.mapper import FusionMapper, MatchBins, ReadMatch
from genefuserust_tpu_torch.core.read import SequenceRead
from genefuserust_tpu_torch.core.scanner import finish_scan
from genefuserust_tpu_torch.io import fasta
from genefuserust_tpu_torch.ops import hashtable as thash
from genefuserust_tpu_torch.ops import index as tindex
from genefuserust_tpu_torch.parallel.engine import TorchEngine
from genefuserust_tpu_torch.utils import spans
from genefuserust_tpu.ops import hashtable as jhash
from gfbench import checks, panel as panels, registry, traffic

from test_torch_index import _assert_equal

SEED = 2**31 + 77
CFG = {**registry.config("oncokb1100"), "genes": 30, "panel_bp": 30 * 12_000}
MIX = {**registry.traffic("pe-targeted"), "pairs_per_sample": 4096, "chimera": 0.02}


class _DenseBins(list):
    """The reference's n x n lists, with the one method finish_scan asks of
    the sparse bins."""

    def kept(self):
        return len(self)


@pytest.fixture(scope="module")
def scanned(tmp_path_factory):
    """A mapper over a 30-gene panel after a CPU scan of a sample with
    planted fusions and random chimeras."""
    d = str(tmp_path_factory.mktemp("bins"))
    p = panels.make_panel(CFG, SEED, d)
    contigs = fasta.read_all(p.fasta, force_upper_case=False)
    settings = Settings(**CFG["settings"])
    pool = traffic.generate(MIX, p.genes, p.exon_starts, p.gene_start, SEED,
                            read_cls=SequenceRead)
    mapper = FusionMapper(contigs, p.csvs[0], settings)
    eng = TorchEngine(settings, batch_size=1024, device="cpu")
    eng.scan_pair_block_multi([mapper], pool)
    eng.flush()
    return d, contigs, p.csvs[0], settings, mapper


def _read(i, seq):
    return SequenceRead(f"@GF:{i} 1:N:0:ACGT", seq, "+", "I" * len(seq))


def _seeded(mapper, n):
    """Matches that land in bins of their own and that a filter empties:
    low complexity, too distant, an indel, each in a bin no scan filled."""
    rng = np.random.default_rng(SEED)
    free = [i for i in range(n * n) if not mapper.fusion_matches._kept.get(i)]
    picks = rng.choice(free, 3, replace=False)
    out = []
    for k, b in enumerate(picks):
        right, left = divmod(int(b), n)
        seq = "".join(rng.choice(list("ACGT"), 150))
        if k == 0:
            seq = "A" * 150
        if k == 2:
            right = left
        m = ReadMatch(_read(900_000 + k, seq), 75, GenePos(left, 1000), GenePos(right, 1020),
                      0, False, 0, 9 if k == 1 else 0)
        m.original_reads = [m.read]
        out.append(m)
    return out


def _strip_times(text):
    return "\n".join(line for line in text.splitlines() if "time" not in line
                     and "GeneFuse " not in line)


def test_bins_answer_as_the_dense_lists():
    bins = MatchBins(9)
    assert len(bins) == 9 and list(bins) == [] and bins.kept() == 0
    bins[7].append("b")
    bins[2].append("a")
    bins[7].append("c")
    assert list(bins) == [["a"], ["b", "c"]] and bins.kept() == 2
    for i in (9, -1):
        with pytest.raises(IndexError):
            bins[i]
    assert bins.kept() == 2


def test_sparse_bins_give_the_dense_outcome_and_reports(scanned, tmp_path):
    d, contigs, csv, settings, scanned_mapper = scanned
    n = len(scanned_mapper.fusion_list)
    matches = [m for fm in scanned_mapper.fusion_matches for m in fm]
    assert len(matches) >= 32 and scanned_mapper.fusion_matches.kept() > 2

    mappers = []
    for dense in (False, True):
        m = FusionMapper(contigs, csv, settings)
        if dense:
            m.fusion_matches = _DenseBins([] for _ in range(n * n))
        for rm in copy.deepcopy(matches):
            m.add_match(rm)
        for rm in _seeded(scanned_mapper, n):
            m.add_match(rm)
        mappers.append(m)
    sparse, dense = mappers
    assert len(sparse.fusion_matches) == len(dense.fusion_matches) == n * n
    assert checks.program_outcome([sparse]) == checks.program_outcome([dense])

    before = dict(spans.REGISTRY.items()).get("report.bins_walked", (0, 0))
    reports = []
    for k, m in enumerate(mappers):
        h, j = str(tmp_path / f"{k}.html"), str(tmp_path / f"{k}.json")
        kept = m.fusion_matches.kept()
        finish_scan(m, h, j, "t", settings)
        reports.append([_strip_times(open(f).read()) for f in (h, j)])
        assert not list(m.fusion_matches) and len(m.fusion_matches) == n * n
        if k == 0:
            walked = dict(spans.REGISTRY.items())["report.bins_walked"]
            assert (walked[0] - before[0], walked[1] - before[1]) == (kept, 1)
            assert kept < n * n
    assert reports[0] == reports[1]
    assert '"fusions":{' in reports[0][1] and len(reports[0][1]) > 500
    # the seeded bins were kept, then each emptied by its filter
    assert isinstance(sparse.fusion_matches, MatchBins)


def test_filters_leave_emptied_bins_walked_in_index_order(scanned):
    _, contigs, csv, settings, scanned_mapper = scanned
    n = len(scanned_mapper.fusion_list)
    m = FusionMapper(contigs, csv, settings)
    seeded = _seeded(scanned_mapper, n)
    for rm in reversed(seeded):
        m.add_match(rm)
    m.remove_by_complexity()
    m.remove_by_distance()
    m.remove_indels()
    assert m.fusion_matches.kept() == 3 and [len(fm) for fm in m.fusion_matches] == [0, 0, 0]
    order = sorted(n * rm.right_gp.contig + rm.left_gp.contig for rm in seeded)
    assert sorted(m.fusion_matches._kept) == order


def _counting(monkeypatch):
    calls = []
    real = tindex._entries_from_indexer

    def counted(ix):
        calls.append(ix)
        return real(ix)

    monkeypatch.setattr(tindex, "_entries_from_indexer", counted)
    return calls


@pytest.mark.parametrize("layout", ["auto", "kv4", "kv8", "kvs", "split", "fall_through"])
def test_one_extraction_a_build_and_the_tables_unchanged(scanned, layout, monkeypatch):
    """Bit-equal to the JAX package's table (and so to the port's before
    the extraction was shared), with `_entries_from_indexer` called once."""
    ix = scanned[-1].indexer
    ask = "auto" if layout == "fall_through" else layout
    exp = jhash.build_packed_index(ix, layout="split" if layout == "fall_through" else ask)
    if layout == "fall_through":
        # every kv layout refused, as a panel past the payload budget is
        monkeypatch.setattr(tindex, "_kv_budget", lambda *a: None)
    calls = _counting(monkeypatch)
    e0 = dict(spans.REGISTRY.items()).get("table.entries", (0, 0))[1]
    attempts = []
    got = tindex.build_packed_index(ix, layout=ask, attempts=attempts)
    assert len(calls) == 1 and calls[0] is ix
    assert dict(spans.REGISTRY.items())["table.entries"][1] == e0 + 1
    if layout == "fall_through":
        assert [a["layout"] for a in attempts] == ["kv2", "kv4", "kv8", "split"]
    assert tindex.layout_name(got) == tindex.layout_name(exp)
    _assert_equal(got, exp)


def test_the_split_packer_frees_the_shared_entries(scanned):
    ix = scanned[-1].indexer
    entries = tindex.Entries(thash._entries_from_indexer(ix))
    got = tindex._pack_split(entries)
    assert entries == [] and tindex.layout_name(got) == "split"
    _assert_equal(got, tindex._pack_split(ix))
