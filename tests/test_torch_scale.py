"""The port's scale proof (profiling/scale_proof.py) at a small size on the
CPU: a 16 Mbp genome, a 4 Mbp panel (two 2 Mbp genes, on chr1 and chr2,
so the planted junction lies inside both), 4 shards. Its sharded and
one-table reports equal the host oracle's and the JAX package's
ShardedIndexEngine's on a 4-device CPU mesh over the same genome (the JAX
tool's own generator), CSV and pairs; its genome generator and Matcher
equal the JAX tool's. Also the Python side of what the tool relies on at
genome scale: build_packed_index's record of the layouts it tried, the
sharded pack without its build tables, and the large tables that
chip_smoke.py's phase 17 builds on the card (profiling/large_tables.py),
here at a small size."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from genefuserust_tpu_torch.config import Settings as PortSettings
from genefuserust_tpu_torch.core.mapper import FusionMapper as PortMapper
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.index import build_packed_index, index_to_torch
from genefuserust_tpu_torch.parallel.sharded_index import pack_index_sharded
from genefuserust_tpu_torch.profiling import large_tables as lt
from genefuserust_tpu_torch.profiling import scale_proof as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME_MBP, PANEL_MBP, SHARDS = 16, 4, 4
_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ [+-]\d{2}:\d{2}")


def _report(path) -> str:
    with open(path) as f:
        return _TS.sub("<ts>", f.read())


def _jax_tool():
    """tools/scale_proof.py as a module, its main() not run (it writes
    SCALE.md)."""
    spec = importlib.util.spec_from_file_location(
        "jax_scale_proof", os.path.join(REPO, "tools", "scale_proof.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tool's run at the tests' size, its three reports kept."""
    reports = tmp_path_factory.mktemp("reports")
    rec = sp.run(["--genome-mbp", str(GENOME_MBP), "--panel-mbp", str(PANEL_MBP),
                  "--shards", str(SHARDS), "--device", "cpu", "--probe-pairs", "1024",
                  "--reports", str(reports)])
    return rec, reports


def test_scale_reports_equal_host_oracle(run):
    rec, reports = run
    assert sp.check(rec) == []
    assert rec["panel"]["genes"] == 2 and rec["panel"]["bases"] == PANEL_MBP * 10**6
    assert rec["host"]["planted"] == ["G0000", "G0001"] and rec["host"]["planted_found"]
    assert rec["sharded"]["equal_host"] and rec["one_table"]["equal_host"]
    assert rec["sharded"]["shards"] == SHARDS and len(rec["sharded"]["shard_bytes"]) == SHARDS
    host = _report(reports / "host.json")
    assert '"gene_name":"G0000"' in host and '"gene_name":"G0001"' in host
    for arm in ("sharded", "one_table"):
        assert _report(reports / f"{arm}.json") == host
    one = rec["one_table"]
    assert [a["layout"] for a in one["attempts"]] == ["kv2"] and one["layout"] == "kv2"
    assert one["table_bytes"]["total"] == sum(one["table_bytes"][k]
                                              for k in ("table", "vals", "dupes"))
    assert rec["matcher"]["alignable"] == 0 and rec["genome"]["bases"] == GENOME_MBP * 10**6
    p = rec["probe"]
    assert p["rows_needed"] >= p["valid_queries"] > 0 and p["bound_ms"] > 0


def test_scale_reports_equal_jax_sharded_engine(run, tmp_path):
    """The JAX ShardedIndexEngine on a 4-device CPU mesh over the JAX
    tool's genome, the port tool's CSV and pairs, reports as the port's."""
    import jax

    from genefuserust_tpu.config import Settings
    from genefuserust_tpu.core.mapper import FusionMapper
    from genefuserust_tpu.core.read import SequenceRead, SequenceReadPair
    from genefuserust_tpu.core.scanner import finish_scan
    from genefuserust_tpu.parallel.mesh import make_mesh
    from genefuserust_tpu.parallel.sharded_engine import ShardedIndexEngine

    rec, reports = run
    contigs = _jax_tool().gen_genome(GENOME_MBP)
    csv = str(tmp_path / "panel.csv")
    sp.write_panel_csv(contigs, PANEL_MBP, csv)
    pairs = [SequenceReadPair(*(SequenceRead(r.name, r.seq, r.strand, r.quality)
                                for r in (p.left, p.right)))
             for p in sp.make_pairs(contigs)]
    mapper = FusionMapper(contigs, csv, Settings())
    engine = ShardedIndexEngine(Settings(), mesh=make_mesh(jax.devices()[:SHARDS], axis="shard"),
                                batch_size=64)
    engine.scan_pairs(mapper, pairs)
    js = str(tmp_path / "jax.json")
    finish_scan(mapper, "", js, "scale_proof", Settings())
    assert _report(js) == _report(reports / "sharded.json")


def test_gen_genome_equals_jax_tool():
    port, ref = sp.gen_genome(GENOME_MBP), _jax_tool().gen_genome(GENOME_MBP)
    assert list(port) == list(ref)
    for name in ref:
        assert port[name] == ref[name], name
    assert port["chr1"][1000:1400] == "A" * 400


def test_matcher_do_match_equals_jax():
    """Part (a): the port's Matcher and the JAX one on a small genome and
    the tool's 200 candidates plus reads over chr1's poly-A decoy: the same
    genome index (the quirk-faithful matcher keeps poly-A-ish k-mers) and
    the same do_match results (none alignable, as in the reference)."""
    from genefuserust_tpu.core.matcher import Matcher
    from genefuserust_tpu_torch.core.matcher import Matcher as PortMatcher

    contigs = sp.gen_genome(2)
    c1 = contigs["chr1"]
    cands = sp.matcher_candidates(contigs) + [c1[off : off + 150] for off in
                                              (850, 900, 1000, 1200, 1300, 1390)]
    port, ref = PortMatcher(contigs, cands), Matcher(contigs, cands)
    assert port.contig_names == ref.contig_names
    assert port.kmer_positions == ref.kmer_positions and port.kmer_positions
    got = [port.do_match(s) for s in cands[:50] + cands[200:]]
    exp = [ref.do_match(s) for s in cands[:50] + cands[200:]]
    assert [None if g is None else vars(g) for g in got] == \
        [None if e is None else vars(e) for e in exp]


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        sp.main(["--genome-mbp", "1", "--panel-mbp", "0"])
    assert e.value.code == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""


def test_part_a_alone_and_skip_matcher():
    rec = sp.run(["--genome-mbp", "2", "--panel-mbp", "0", "--device", "cpu"])
    assert "panel" not in rec and rec["matcher"]["build_s"] >= 0 and sp.check(rec) == []
    rec = sp.run(["--genome-mbp", "2", "--panel-mbp", "0", "--device", "cpu",
                  "--skip-matcher", "--matcher-note", "run apart"])
    assert rec["matcher"] == {"note": "run apart"}


@pytest.fixture(scope="module")
def small_mapper(tmp_path_factory):
    """Four genes of 120,000 bases over a 4 Mbp genome of the tool's."""
    contigs = sp.gen_genome(4)
    csv = str(tmp_path_factory.mktemp("small") / "panel.csv")
    with open(csv, "w") as f:
        for g, (name, s) in enumerate(list(contigs.items())[:4]):
            f.write(f">S{g},{name}:1-120000\n1,100,400\n2,1000,1400\n")
    return PortMapper(contigs, csv, PortSettings())


def test_layout_attempts_record_the_fallback_chain(small_mapper, monkeypatch):
    from genefuserust_tpu_torch.ops import index as ix

    att = []
    p = build_packed_index(small_mapper.indexer, attempts=att)
    assert [(a["layout"], a["packed"]) for a in att] == [("kv2", True)]
    assert all(a["seconds"] >= 0 for a in att) and ix.layout_name(p) == "kv2"
    # every kv layout refused: kv2, kv4, kv8 tried, then split
    monkeypatch.setattr(ix, "_pack_kv", lambda *a, **k: None)
    att = []
    p = build_packed_index(small_mapper.indexer, attempts=att)
    assert [(a["layout"], a["packed"]) for a in att] == [
        ("kv2", False), ("kv4", False), ("kv8", False), ("split", True)]
    assert ix.layout_name(p) == "split"
    att = []
    build_packed_index(small_mapper.indexer, layout="kvs", attempts=att)
    assert [a["layout"] for a in att] == ["kvs"]


def test_sharded_pack_without_build_tables(small_mapper):
    """build_form=False: the same device form, no (nb, 8, 3) build table."""
    _, full = pack_index_sharded(small_mapper.indexer, 3)
    _, lean = pack_index_sharded(small_mapper.indexer, 3, build_form=False)
    for a, b in zip(full, lean):
        assert b.table is None and a.table is not None
        assert np.array_equal(a.keys_tbl, b.keys_tbl) and np.array_equal(a.vals_tbl, b.vals_tbl)
        assert np.array_equal(a.dupes, b.dupes) and a.empty_key == b.empty_key
        assert b.nbytes == a.nbytes


@pytest.fixture(scope="module")
def kv2_index(small_mapper):
    index = index_to_torch(build_packed_index(small_mapper.indexer, "kv2"), "cpu")
    keys, _ = lt.kv2_entries(index)
    assert keys.shape[0] == int((index.table[:, 1] != 0).sum()) > 0
    return index, keys


@pytest.mark.parametrize("log2_nb", [22, 23])
def test_widen_kv_keeps_the_entries(kv2_index, log2_nb):
    index, keys = kv2_index
    wide, left_out = lt.widen_kv(index, log2_nb)
    assert wide.table.shape == (1 << log2_nb, 2) and wide.shift == 32 - log2_nb
    ones = torch.ones(keys.shape[0], dtype=torch.bool)
    c0, p0 = tm.lookup(index, keys, ones)
    c1, p1 = tm.lookup(wide, keys, ones)
    moved = (c1 != c0) | (p1 != p0)
    # a left-out key misses; every other key keeps its payload
    assert int(moved.sum()) == left_out < keys.shape[0] // 10
    assert bool((c1[moved] == tm.EMPTY).all())
    # each key sits in its h1 row or, where that was taken, its h2 row
    b1, b2 = tm.buckets(keys[~moved], wide.shift)
    ki = tm._i32(keys[~moved])
    in1 = wide.table[b1, 0] == ki
    assert bool((in1 | (wide.table[b2, 0] == ki)).all()) and int((~in1).sum()) > 0


@pytest.mark.parametrize("dupe_base", [0, 5000])
def test_widen_split_moves_the_dupe_rows(kv2_index, dupe_base):
    index, keys = kv2_index
    wide, left_out = lt.widen_split(index, 20, dupe_base)
    assert wide.split and wide.table.shape == (1 << 20, 8) and wide.vals.shape == (8 << 20, 2)
    assert wide.dupes.shape[0] == dupe_base + index.dupes.shape[0]
    ones = torch.ones(keys.shape[0], dtype=torch.bool)
    c0, p0 = tm.lookup(index, keys, ones)
    c1, p1 = tm.lookup(wide, keys, ones)
    # a key past its bucket's 8 slots misses; every other key keeps its
    # entry, a dupe entry's row moved by dupe_base
    out = c1 == tm.EMPTY
    assert int(out.sum()) == left_out < 20
    c0, p0, c1, p1 = c0[~out], p0[~out], c1[~out], p1[~out]
    dupe = c0 == tm.DUPE
    assert int(dupe.sum()) > 0 and torch.equal(c0, c1)
    assert torch.equal(p1, torch.where(dupe, p0 + dupe_base, p0))
    # the same valid candidates through either table's dupe rows
    (a_c, a_p, a_v), (b_c, b_p, b_v) = tm.expand(index, c0, p0), tm.expand(wide, c1, p1)
    assert torch.equal(a_v, b_v) and int(a_v[:, 1:].sum()) > 0
    assert torch.equal(a_c[a_v], b_c[b_v]) and torch.equal(a_p[a_v], b_p[b_v])
    # about half the keys lie in their h2 bucket
    b1, _ = tm.buckets(keys[~out], wide.shift)
    in1 = (wide.table[b1] == tm._i32(keys[~out])[:, None]).any(1)
    assert 0.4 < float(in1.double().mean()) < 0.6
    named = lt.dupe_rows_named(wide, torch.stack([c1, p1], -1))
    assert named["dupe_samples"] == int(dupe.sum())
    assert named["dupe_max_offset"] >= dupe_base * named["dupe_row_bytes"]


def test_rows_probed_counts_the_rows_and_their_offsets(kv2_index):
    """rows_probed against the probe mirror's own count of the rows it
    loads (valid + need2) on reads cut from the panel, kv2 and split."""
    from test_torch_probe import _kernel_probe

    from genefuserust_tpu_torch.core.sequence import encode_bases

    index, _ = kv2_index
    rng = np.random.default_rng(3)
    genes = list(sp.gen_genome(4).values())[:4]
    codes = np.full((32, 160), 255, np.uint8)
    lens = np.full(32, 150, np.int32)
    for r in range(32):
        off = int(rng.integers(0, 119_000))
        codes[r, :150] = encode_bases(genes[r % 4][off : off + 150])
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lens)
    for table in (lt.widen_kv(index, 22)[0], lt.widen_split(index, 20, 77)[0]):
        for stride in (2, 1):
            got = lt.rows_probed(table, tc, tl, stride, indices=True)
            out, rows, _ = _kernel_probe(codes, lens, stride, table)
            assert np.array_equal(out, tm.probe_plain(tc, tl, stride, table).numpy())
            assert got["rows"] == rows == got["row_index"].shape[0] > got["valid"]
            assert got["hits"] == int((torch.from_numpy(out)[..., 0] != tm.EMPTY).sum())
            if table.split:
                assert got["vals_rows"] == got["hits"] == got["vals_index"].shape[0]
            assert 0 < got["max_offset"] < table.table.numel() * 4
            assert got["past_2_31"] == got["past_2_32"] == 0
