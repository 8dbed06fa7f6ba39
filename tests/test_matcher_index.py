"""The alignability filter's shared genome index (core/matcher.py):
`Matcher.over(GenomeIndex(contigs), seqs)` against a freshly scanned
`Matcher(contigs, seqs)` for several bloom sets, on the native and the
numpy builds; `FusionMapper.remove_alignables` over the shared index
against the JAX package's; one build for every mapper over one contigs
dict, by the registry's counters; and the cache entry gone with the last
mapper."""

import gc

import numpy as np
import pytest

from genefuserust_tpu.config import Settings as JaxSettings
from genefuserust_tpu.core.indexer import GenePos as JaxGenePos
from genefuserust_tpu.core.mapper import FusionMapper as JaxFusionMapper
from genefuserust_tpu.core.mapper import ReadMatch as JaxReadMatch
from genefuserust_tpu.core.read import SequenceRead as JaxSequenceRead
from genefuserust_tpu_torch import native
from genefuserust_tpu_torch.config import Settings
from genefuserust_tpu_torch.core import matcher as port_matcher
from genefuserust_tpu_torch.core.indexer import GenePos
from genefuserust_tpu_torch.core.mapper import FusionMapper, ReadMatch
from genefuserust_tpu_torch.core.matcher import (
    SKIP_THRESHOLD,
    GenomeIndex,
    Matcher,
    genome_index,
)
from genefuserust_tpu_torch.core.read import SequenceRead
from genefuserust_tpu_torch.core.sequence import reverse_complement
from genefuserust_tpu_torch.utils import spans
from genefuserust_tpu_torch.utils.synthetic import make_panel, plant_fusion_pairs

CODES = {"A": 0, "T": 1, "C": 2, "G": 3}


def _random(rng, n, alphabet="ACGT"):
    return rng.choice(np.frombuffer(alphabet.encode(), np.uint8), size=n).tobytes().decode()


def _genome(seed=3, alphabet="ACGT"):
    """Keys 0 and 1 on more than SKIP_THRESHOLD positions (poly-A runs,
    each ended by a T), keys 2 and 3 on a few (contig starts, bases after
    an N or 15 A's); a lowercase contig and one below KMER. With
    alphabet "ATG" no base is C, so key 2 is on no position."""
    rng = np.random.default_rng(seed)
    c = "C" if "C" in alphabet else "G"
    return {
        "chr1": _random(rng, 1500, alphabet) + ("A" * 16 + "T") * 60 + _random(rng, 1500, alphabet),
        "chr2": "G" + _random(rng, 2000, alphabet) + "N" + c + _random(rng, 1000, alphabet)
        + "NN" + "G" + _random(rng, 800, alphabet),
        "chr3": "A" * 15 + c + _random(rng, 600, alphabet) + "A" * 15 + "G" + _random(rng, 300, alphabet),
        "low": _random(rng, 900, alphabet).lower(),
        "tiny": "ACGT",
    }


def _bloom_seqs(codes):
    """Candidate reads whose bloom set is exactly `codes`: one valid base,
    then 15 N's, so only the read's first base seeds it (its reverse
    complement's first 1 base is an N)."""
    return ["ATCG"[k] + "N" * 15 for k in sorted(codes)]


QUERIES = [
    "AT" * 20,  # keys 0 and 1 on both strands: long lists, skipped
    "C" * 40,  # key 2, its reverse complement key 3: short lists
    "G" * 20 + "C" * 20,  # key 3 and key 2 on each strand
    "GATTACA" * 6,
    "ACGTN" * 8 + "GGGG",
    "G" * 15,  # below KMER
]


def _outcome(m, q):
    """-> ("raise", message), ("hit", result) where some position of
    either strand has a key on 1..SKIP_THRESHOLD positions, else ("miss",
    result)."""
    try:
        r = m.do_match(q)
    except RuntimeError as e:
        return "raise", str(e)
    keys = {CODES[b] for s in (q, reverse_complement(q)) for b in s[: len(s) - 15] if b in CODES}
    hit = any(0 < len(m.kmer_positions.get(k, ())) <= SKIP_THRESHOLD for k in keys)
    return ("hit" if hit else "miss"), (None if r is None else vars(r))


@pytest.mark.parametrize("build", ["native", "numpy"])
@pytest.mark.parametrize("bloom, reached", [
    (set(), {"miss"}),
    ({0}, {"miss"}),
    ({1, 3}, {"miss", "hit", "raise"}),
    ({0, 1, 2, 3}, {"miss", "hit"}),
], ids=["empty", "0", "1_3", "0_1_2_3"])
def test_shared_index_view_equals_a_fresh_matcher(build, bloom, reached, monkeypatch):
    if build == "numpy":
        monkeypatch.setattr(native, "matcher_scan", lambda codes, bits: None)
    else:
        assert native.available()
    contigs = _genome()
    seqs = _bloom_seqs(bloom)
    fresh = Matcher(contigs, seqs)
    index = GenomeIndex(contigs)
    shared = Matcher.over(index, seqs)
    assert fresh._bloom_bits == shared._bloom_bits == bloom
    assert len(index.kmer_positions[0]) > SKIP_THRESHOLD < len(index.kmer_positions[1])
    assert 0 < len(index.kmer_positions[2]) <= SKIP_THRESHOLD
    assert 0 < len(index.kmer_positions[3]) <= SKIP_THRESHOLD
    assert shared.contig_names == fresh.contig_names == list(contigs)
    # every list, its order, and the keys' order
    assert list(shared.kmer_positions.items()) == list(fresh.kmer_positions.items())
    assert set(shared.kmer_positions) == bloom
    got = [_outcome(shared, q) for q in QUERIES]
    assert got == [_outcome(fresh, q) for q in QUERIES]
    assert {kind for kind, _ in got} == reached


def _csv(tmp_path, chrom, name):
    path = tmp_path / f"{name}.csv"
    path.write_text(f">{name},{chrom}:100-1100\n1,100,600\n2,700,1100\n")
    return str(path)


def _fill(mapper, match_cls, read_cls, pos_cls, seqs):
    """Spread one ReadMatch a read over the mapper's bins."""
    bins = mapper.fusion_matches
    for i, s in enumerate(seqs):
        r = read_cls(f"r{i}", s, "+", "I" * len(s))
        bins[i % len(bins)].append(match_cls(r, 75, pos_cls(0, 10), pos_cls(0, 900), 0))


def _kept(mapper):
    try:
        mapper.remove_alignables()
    except RuntimeError as e:
        return "raise", str(e)
    return "kept", [[m.read.name for m in fm] for fm in mapper.fusion_matches]


@pytest.mark.parametrize("case", ["panel", "short_lists", "would_panic"])
def test_remove_alignables_equals_jax(case, tmp_path):
    """Over the port's shared index (a second mapper finds it built) the
    filter keeps what the JAX package's keeps, or raises where it does."""
    if case == "panel":
        panel = make_panel()
        contigs = panel.contigs
        csv = tmp_path / "panel.csv"
        csv.write_text(panel.csv_text)
        csv = str(csv)
        seqs = [r.seq for p in plant_fusion_pairs(panel, n_support=6, n_background=20)
                for r in (p.left, p.right)]
    else:
        contigs = _genome(alphabet="ACGT" if case == "short_lists" else "ATG")
        csv = _csv(tmp_path, "chr2", "G1")
        seqs = QUERIES[:5] + [contigs["chr2"][o : o + 150] for o in (10, 400, 2100)]
    port = [FusionMapper(contigs, csv, Settings(), multi_csv_mode=True) for _ in range(2)]
    for m in port:
        _fill(m, ReadMatch, SequenceRead, GenePos, seqs)
    ref = JaxFusionMapper(contigs, csv, JaxSettings(), multi_csv_mode=True)
    _fill(ref, JaxReadMatch, JaxSequenceRead, JaxGenePos, seqs)
    exp = _kept(ref)
    assert [_kept(m) for m in port] == [exp, exp]
    assert port[0].genome_index is port[1].genome_index
    assert exp[0] == {"panel": "kept", "short_lists": "kept", "would_panic": "raise"}[case]


@pytest.fixture
def registry(monkeypatch):
    reg = spans.Registry()
    monkeypatch.setattr(spans, "REGISTRY", reg)
    return reg


def test_sixteen_mappers_over_one_genome_build_once(registry, tmp_path):
    contigs = _genome()
    csv = _csv(tmp_path, "chr2", "G1")
    mappers = [FusionMapper(contigs, csv, Settings(), multi_csv_mode=True) for _ in range(16)]
    for sample in range(3):
        for m in mappers:
            _fill(m, ReadMatch, SequenceRead, GenePos, ["C" * 40, "AT" * 20])
            m.remove_alignables()
    assert registry["report.matcher_index"][1] == 1
    assert tuple(registry["matcher.index_reuse"]) == (16 * 3 - 1, 16 * 3 - 1)
    assert len({id(m.genome_index) for m in mappers}) == 1
    assert mappers[0].genome_index.contigs is contigs

    other = dict(contigs)  # equal, but another object: its own index
    m2 = FusionMapper(other, csv, Settings(), multi_csv_mode=True)
    m2.remove_alignables()
    assert registry["report.matcher_index"][1] == 2
    assert m2.genome_index is not mappers[0].genome_index
    assert m2.genome_index.contigs is other


def test_cache_entry_goes_with_the_last_mapper(tmp_path):
    contigs = _genome()
    csv = _csv(tmp_path, "chr2", "G1")
    mappers = [FusionMapper(contigs, csv, Settings(), multi_csv_mode=True) for _ in range(3)]
    for m in mappers:
        m.remove_alignables()
    assert port_matcher._SHARED[id(contigs)] is mappers[0].genome_index
    assert genome_index(contigs) is mappers[0].genome_index
    del mappers, m
    gc.collect()
    assert id(contigs) not in port_matcher._SHARED
    # a new mapper builds it again
    m = FusionMapper(contigs, csv, Settings(), multi_csv_mode=True)
    m.remove_alignables()
    assert port_matcher._SHARED[id(contigs)] is m.genome_index


@pytest.mark.parametrize("engine, paired", [("cuda", True), ("cuda", False), ("host", True),
                                            ("sharded-index", False)])
def test_a_multi_csv_job_builds_the_genome_index_once(engine, paired, registry, tmp_path):
    """The CLI's multi-CSV mode: paired reads on the torch engine go
    through one scan of every panel, the rest through a Scanner a CSV,
    whose engine may hold no mapper past its CSV; either way one build a
    job."""
    from genefuserust_tpu_torch import cli
    from genefuserust_tpu_torch.utils.synthetic import write_fastq_files, write_panel_files

    panel = make_panel(seed=21)
    ref, csv = write_panel_files(panel, str(tmp_path))
    r1, r2 = write_fastq_files(plant_fusion_pairs(panel, n_support=6, n_background=20, seed=4),
                               str(tmp_path))
    csvs = []
    for k in range(3):
        path = tmp_path / f"panel{k}.csv"
        path.write_text(panel.csv_text)
        csvs.append(str(path))
    (tmp_path / "csvs.txt").write_text("\n".join(csvs) + "\n")
    reads = ["-1", r1] + (["-2", r2] if paired else [])
    assert cli.main([*reads, "-f", str(tmp_path / "csvs.txt"), "-r", ref,
                     "-h", str(tmp_path / "out.html"), "-j", str(tmp_path / "out.json"),
                     "--engine", engine, "--device", "cpu"]) == 0
    assert registry["report.alignable"][1] == 3
    assert registry["report.matcher_index"][1] == 1
    assert tuple(registry["matcher.index_reuse"]) == (2, 2)
    for k in range(3):
        assert '"fusions"' in (tmp_path / f"out_panel{k}.json").read_text()
        assert (tmp_path / f"out_panel{k}.html").exists()
