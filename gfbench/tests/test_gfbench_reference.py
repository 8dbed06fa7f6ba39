"""The plain reference against the port at small sizes on the CPU: whole
runs of both cells through the port's engine (plain kernels), its pieces
against the port's scalar oracle, and the vectorised merge and k-mer count
of probe_work.py against the reference's scalar merge."""

import time

import numpy as np
import pytest

from gfbench import checks, panel, probe_work, registry, traffic
from gfbench.cell import run_cell


@pytest.mark.parametrize("cell", ["cancer15-pe-targeted", "multicsv16-pe-targeted"])
def test_a_run_on_the_port_cpu_engine_is_correct(cell, small):
    out = run_cell(cell, 2**31 + 5, 0.5, False, time.perf_counter(), device="cpu",
                   sizes=small, say=lambda o: None)
    assert out["correct"], out["checks"]
    assert all(v["value"] == 0 for v in out["checks"].values())
    assert out["attempted"] >= 4096 and out["failed"] == 0
    # without a card no device interval is traced: a metric read from the
    # device's trace finds nothing and is left out
    e2e = registry.metrics_of(cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert set(out["metrics"]) == {m["name"] for m in e2e if m["source"] != "device_trace"}


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(small):
    out = run_cell("cancer15-pe-targeted", 77, 0.1, True, time.perf_counter(), device="cpu",
                   sizes=small, say=lambda o: None)
    assert out["correct"]
    # without a card no device interval is traced: device_idle_share and
    # probe_roofline find nothing to read and are left out
    assert set(out["metrics"]) == {"index_build_s", "table_pack_s",
                                   "merge_pack_ms_per_batch.cancer15",
                                   "producer_wait_share.cancer15", "ed_jobs_per_kpair.cancer15",
                                   "report_s_per_sample.cancer15", "pairs_per_s.cancer15"}
    assert list(out)[-1] == "checks"


def test_reference_matches_equal_the_port_host_oracle(tmp_path, small):
    """Pair by pair, the reference's matches equal those of the port's
    scalar oracle (core/scanner.scan_one_pair) on every chimeric and
    planted pair and a random sample."""
    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.core.mapper import FusionMapper
    from genefuserust_tpu_torch.core.read import SequenceRead, SequenceReadPair
    from genefuserust_tpu_torch.core.scanner import scan_one_pair
    from genefuserust_tpu_torch.io import fasta

    from gfbench.reference import Reference, Settings as RefSettings

    cfg = {**registry.config("multicsv16"), **small["config"]}
    mix = {**registry.traffic("pe-targeted"), **small["traffic"]}
    p = panel.make_panel(cfg, 9, str(tmp_path))
    s = traffic.generate(mix, p.genes, p.exon_starts, p.gene_start, 9, read_cls=SequenceRead)
    pairs = checks.check_set(s, 9)
    contigs = fasta.read_all(p.fasta)
    mappers = [FusionMapper(contigs, c, Settings(), multi_csv_mode=True) for c in p.csvs]
    for i in pairs.tolist():
        for m in mappers:
            scan_one_pair(m, SequenceReadPair(s.left.read_obj(i), s.right.read_obj(i)))
    port = checks.program_outcome(mappers)
    ref_pairs, _ = checks.reference_outcome(Reference(p.fasta, p.csvs, RefSettings()), s, pairs)
    assert sum(len(v) for v in ref_pairs.values()) > 20
    for i in pairs.tolist():
        assert sorted(port.get(i, [])) == sorted(ref_pairs.get(i, [])), i


def test_pieces_equal_the_port():
    from genefuserust_tpu_torch.core.edit_distance import edit_distance as port_ed
    from genefuserust_tpu_torch.core.indexer import GenePos as PG, rolling_kmers as port_rk
    from genefuserust_tpu_torch.core.indexer import segment_mask as port_seg

    from gfbench.reference.edit_distance import edit_distance
    from gfbench.reference.indexer import GenePos, rolling_kmers, segment_mask

    rng = np.random.default_rng(4)
    for n in (0, 15, 16, 17, 151, 302):
        c = rng.integers(0, 4, n).astype(np.uint8)
        c[rng.random(n) < 0.05] = 255
        a, b = rolling_kmers(c), port_rk(c)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    for t in range(4000):
        n = int(rng.integers(1, 260))
        m = np.where(rng.random(n) < (0.3 + 0.6 * (t % 3) / 2), rng.choice([2, 3], n),
                     rng.integers(0, 4, n)).astype(np.uint8)
        got = [(x.seq_start, x.seq_end) for x in segment_mask(m.copy(), n, GenePos(0, 1), GenePos(1, 2))]
        want = [(x.seq_start, x.seq_end) for x in port_seg(m.copy(), n, PG(0, 1), PG(1, 2))]
        assert got == want
    for _ in range(500):
        a = "".join(rng.choice(list("ACGTN"), int(rng.integers(0, 120))))
        b = "".join(rng.choice(list("ACGT"), int(rng.integers(0, 120))))
        assert edit_distance(a, b) == port_ed(a, b)


def test_probe_work_merges_as_the_reference(tmp_path, small):
    from gfbench.reference import SequenceRead, SequenceReadPair
    from gfbench.reference.indexer import rolling_kmers
    from gfbench.reference.sequence import encode_bases

    cfg = {**registry.config("cancer15"), **small["config"]}
    mix = {**registry.traffic("pe-targeted"), **small["traffic"]}
    p = panel.make_panel(cfg, 21, str(tmp_path))
    s = traffic.generate(mix, p.genes, p.exon_starts, p.gene_start, 21, read_cls=SequenceRead)
    L, R = s.left, s.right
    offs = probe_work.merge_offsets(L.seq, L.qual, R.seq, R.qual)
    rows = bases = kmers = 0
    for i in range(len(s)):
        m = SequenceReadPair(L.read_obj(i), R.read_obj(i)).fast_merge()
        assert offs[i] == (-1 if m is None else len(m.seq) - mix["read_len"]), i
        for r in ([m.seq] if m is not None else [L.read_obj(i).seq, R.read_obj(i).seq]):
            _, valid = rolling_kmers(encode_bases(r))
            kmers += int(valid[::2].sum())
            bases += len(r)
            rows += 1
    w = probe_work.pass1_work(L.seq, L.qual, R.seq, R.qual)
    assert (w["rows"], w["bases"], w["kmers"]) == (rows, bases, kmers)
    b = probe_work.probe_bound(L.seq, L.qual, R.seq, R.qual, panels=16)
    assert b["bytes"] == 16 * (bases + 32 * kmers)
