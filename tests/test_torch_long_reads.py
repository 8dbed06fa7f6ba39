"""Reads longer than the scan kernels' main paths take: a 4,200-base read
(past the vote's shared-memory sort, which held 4,096 bases) and a
70,000-base read (past mask+segments' 16-bit chain ends). The port's
engines scan both, single-end and paired, with reports equal to the host
oracle's (and JAX TpuEngine's at 4,200 bases); the plain versions and the
kernels' mirrors equal JAX at those widths. Rows of 240,000 and 300,000
bases (past what the probe could stage when it staged a tile's rows whole)
hold the probe's mirror to plain and the port's map_read to JAX's. All
comparisons are exact."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.read import SequenceRead, SequenceReadPair
from genefuserust_tpu.core.scanner import HostEngine, Scanner
from genefuserust_tpu.core.sequence import encode_bases, reverse_complement
from genefuserust_tpu.utils.synthetic import make_panel, plant_fusion_pairs, write_panel_files
from genefuserust_tpu_torch.config import Settings as PortSettings
from genefuserust_tpu_torch.core.scanner import Scanner as PortScanner
from genefuserust_tpu_torch.ops import cuda
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.index import build_packed_index, index_to_torch
from genefuserust_tpu_torch.parallel.engine import TorchEngine
from genefuserust_tpu_torch.parallel.sharded_engine import ShardedIndexEngine
from genefuserust_tpu_torch.utils.synthetic import long_reads
from test_torch_map_read import (
    _jax_pass2,
    _jax_tables,
    _jax_vote,
    _kernel_mask_segments,
    _kernel_vote,
)
from test_torch_probe import _kernel_probe, split_default_shape, staged_chunks_max

_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def panel_reads():
    """make_panel's two genes, and the two long reads from its planted
    junction (gene-relative 5000 | 6000): the 4,200-base one spans it."""
    panel = make_panel()
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    left = panel.contigs[c1][s1 : s1 + 5001]
    right = panel.contigs[c2][s2 + 6000 : s2 + 9000]
    return panel, long_reads(left, right, seed=5)


def _items(panel, reads, paired):
    """Planted pairs (or their R1) with the long reads among them; a long
    read's mate is the reverse complement of bases 150-300 from its end."""
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=20)
    items = list(pairs) if paired else [p.left for p in pairs]
    for k, r in enumerate(reads):
        read = SequenceRead(f"@long{k}", r, "+", "I" * len(r))
        if paired:
            mate = reverse_complement(r[-300:-150])
            read = SequenceReadPair(read, SequenceRead(f"@long{k}", mate, "+", "I" * 150))
        items.insert(2 + 5 * k, read)
    return items


def _reports(panel, items, tmp_path, engine, tag, paired):
    _, csv = write_panel_files(panel, str(tmp_path))
    html, js = tmp_path / f"{tag}.html", tmp_path / f"{tag}.json"
    port = isinstance(engine, (TorchEngine, ShardedIndexEngine))
    scanner = (PortScanner if port else Scanner)(
        csv, panel.contigs, str(html), str(js), (PortSettings if port else Settings)(),
        engine=engine, command="long-reads")
    (scanner.scan_pairs if paired else scanner.scan_singles)(items)
    return _TS.sub("<ts>", html.read_text()), _TS.sub("<ts>", js.read_text())


@pytest.mark.parametrize("paired", [False, True])
def test_4200_base_read_matches_host_and_jax(tmp_path, panel_reads, paired):
    from genefuserust_tpu.parallel.engine import TpuEngine

    panel, (span, _) = panel_reads
    items = _items(panel, [span], paired)
    host = _reports(panel, items, tmp_path, HostEngine(), "host", paired)
    assert '"fusions":{"' in host[1].replace("\n", "").replace("\t", "")
    for tag, eng in (("torch", TorchEngine(PortSettings(), batch_size=32, device="cpu")),
                     ("sharded", ShardedIndexEngine(PortSettings(), devices=[CPU] * 2,
                                                    batch_size=32)),
                     ("jax", TpuEngine(Settings(), batch_size=32))):
        assert _reports(panel, items, tmp_path, eng, tag, paired) == host, tag


@pytest.mark.parametrize("paired", [False, True])
def test_70000_base_read_matches_host(tmp_path, panel_reads, paired):
    panel, reads = panel_reads
    assert len(reads[1]) > tm.MASK_MAX_WIDTH
    items = _items(panel, reads, paired)
    host = _reports(panel, items, tmp_path, HostEngine(), "host", paired)
    # batches of 8: only the first, which holds both long reads, is wide
    for tag, eng in (("torch", TorchEngine(PortSettings(), batch_size=8, device="cpu")),
                     ("sharded", ShardedIndexEngine(PortSettings(), devices=[CPU] * 3,
                                                    batch_size=8))):
        assert _reports(panel, items, tmp_path, eng, tag, paired) == host, tag


@pytest.fixture(scope="module")
def panel_ix(panel_reads, tmp_path_factory):
    from genefuserust_tpu.core.indexer import Indexer
    from genefuserust_tpu.models.fusion import Fusion

    panel = panel_reads[0]
    _, csv = write_panel_files(panel, str(tmp_path_factory.mktemp("panel")))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv), Settings())
    ix.make_index()
    return ix


def _long_batch(panel, reads, ix, layout):
    """The long reads after a 150-base junction read as one (3, W) batch,
    with the panel's table in `layout`."""
    seqs = [plant_fusion_pairs(panel, n_support=1, n_background=0)[0].left.seq, *reads]
    W = -(-max(map(len, seqs)) // 32) * 32
    codes = np.full((len(seqs), W), 255, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_bases(s)
    lens = np.array([len(s) for s in seqs], np.int32)
    packed = build_packed_index(ix, layout)
    return torch.from_numpy(codes), torch.from_numpy(lens), packed, index_to_torch(packed, CPU)


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_wide_vote_plain_and_mirror_match_jax(panel_reads, panel_ix, layout):
    """The vote at the long reads' widths (NS * D past the 16,384 keys of
    the shared-memory sort): vote_plain and vote_counts_plain against
    JAX's expand + top2_votes + gate; the 4,200-base row (over 256 valid
    keys, the block path) also against the kernel's mirror."""
    panel, reads = panel_reads
    codes, lens, packed, index = _long_batch(panel, reads, panel_ix, layout)
    pr = tm.probe(codes, lens, 2, index)
    assert tm.vote_width(pr.shape[1], index.D) > tm.MAX_VOTE_KEYS
    got = tm.vote(pr, index, 40, 20)
    assert np.array_equal(got.numpy(), _jax_vote(pr.numpy(), packed))
    counts = tm.vote_counts(pr, index)
    assert torch.equal(got[:, 1:3], counts[:, 1:3]) and torch.equal(got[:, 3:5], counts[:, 4:6])
    n = tm.vote_candidates(pr, index)
    assert n[1] > tm.VOTE_WARP_KEYS and n[2] > tm.VOTE_WARP_KEYS
    keys, cv = tm._keys_at(index, pr, 2)
    P = pr.shape[1] * index.D
    for b in (0, 1):
        valid = keys[b].reshape(-1)[cv[b].reshape(-1)].tolist()
        assert _kernel_vote(valid, P) == got[b].tolist()
    assert got[1:, 0].all()  # the long reads pass the gate


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_wide_mask_plain_and_mirror_match_jax(panel_reads, panel_ix, layout):
    """Pass 2 on the 70,000-base batch: mask_segments_plain against JAX
    map_read_pass2 (unjitted, its lookup given the probe results), and the
    kernel's mirror with the wide path's 64-bit chain keys; the same from
    flag words (mask_from_flags_plain). Chains end past 65,535 bases."""
    panel, reads = panel_reads
    codes, lens, packed, index = _long_batch(panel, reads, panel_ix, layout)
    gp = tm.vote(tm.probe(codes, lens, 2, index), index, 40, 20)[:, 1:5].contiguous()
    pr = tm.probe(codes, lens, 1, index)
    NK = pr.shape[1]
    assert NK + 15 > tm.MASK_MAX_WIDTH
    exp = _jax_pass2(pr, lens, gp, packed)
    got = tm.mask_segments(pr, lens, gp, index, 10).numpy()
    assert np.array_equal(got, exp)
    assert (got[:, 4] > tm.MASK_MAX_WIDTH).any() and got[1, 0] == 1
    assert np.array_equal(_kernel_mask_segments(pr, lens, gp, index, wide=True), exp)
    words = tm.shard_flags([pr], lens, gp, [index])
    assert np.array_equal(tm.mask_from_flags(words, lens, gp, NK, 10).numpy(), exp)


# the probe's default launch shape (PROBE_THREADS, PROBE_Q in csrc/probe.cu)
# and the shared memory a block may take on the H100 (227 KB)
PROBE_T, PROBE_Q, BLOCK_SMEM = 256, 4, 232448


def _very_long_batch(panel, lengths, seed):
    """(len(lengths), W) code rows: a 150-base junction read, then rows of
    `lengths[1:]` bases, each 2,000 bases of one gene, random bases with a
    non-ACGT base every ~10,000, 2,000 bases of the other gene, random
    bases."""
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    left = panel.contigs[c1][s1 : s1 + 5001]
    right = panel.contigs[c2][s2 + 6000 : s2 + 9000]
    seqs = [plant_fusion_pairs(panel, n_support=1, n_background=0)[0].left.seq]
    seqs += [long_reads(left, right, seed=seed + k, wide=n)[1] for k, n in enumerate(lengths[1:])]
    W = -(-max(map(len, seqs)) // 32) * 32
    codes = np.full((len(seqs), W), 255, np.uint8)
    rng = np.random.default_rng(seed)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_bases(s)
        if len(s) > 10000:
            codes[i, rng.integers(2000, len(s) - 4000, len(s) // 10000)] = 255
    return codes, np.array([len(s) for s in seqs], np.int32)


@pytest.mark.parametrize("layout", ["kv2", "split"])
@pytest.mark.parametrize("stride", [2, 1])
def test_probe_mirror_matches_plain_on_rows_past_the_old_staging_limit(panel_reads, panel_ix,
                                                                        stride, layout):
    """The kernel's mirror at its launch shape (kv2: probe_kernel's; split:
    probe_split_kernel's) on rows of 150, 240,000 and 300,000 bases:
    bit-equal to plain, table rows loaded as needed, and each tile's staged
    span inside the launch's shared memory, which fits a block, where
    staging the rows a tile crosses whole would not."""
    from test_torch_probe import _rows_needed

    panel = panel_reads[0]
    codes, lens = _very_long_batch(panel, [150, 240_000, 300_000], seed=17)
    index = index_to_torch(build_packed_index(panel_ix, layout), CPU)
    T, Q = (PROBE_T, PROBE_Q) if layout == "kv2" else split_default_shape()[::-1]
    got, loaded, _ = _kernel_probe(codes, lens, stride, index, T, Q)
    plain = tm.probe(torch.from_numpy(codes), torch.from_numpy(lens), stride, index)
    assert np.array_equal(got, plain.numpy())
    assert loaded == _rows_needed(index, codes, lens, stride)
    hits = plain[..., 0] >= 0
    assert hits[1].any() and hits[2].any() and (plain[2, :, 0] == tm.EMPTY).any()
    W = codes.shape[1]
    NQ = (W - 16 + stride) // stride
    rows_max = (T * Q - 1) // NQ + 2
    assert staged_chunks_max(W, NQ, stride, T, Q) * 8 + rows_max * 4 <= BLOCK_SMEM
    assert rows_max * W > BLOCK_SMEM


def test_240000_base_read_map_read_matches_jax(panel_reads, panel_ix):
    """The port's map_read_batch (plain versions, on the CPU) against JAX
    map_read_batch on the kv2 table, on a batch of a 150-base junction
    read, the 4,200-base read and a 240,000-base read."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    panel, (span, _) = panel_reads
    codes, lens = _very_long_batch(panel, [150, 240_000], seed=23)
    row = np.full((1, codes.shape[1]), 255, np.uint8)
    row[0, : len(span)] = encode_bases(span)
    codes = np.concatenate([codes[:1], row, codes[1:]])
    lens = np.array([lens[0], len(span), lens[1]], np.int32)
    packed = build_packed_index(panel_ix, "kv2")
    t1, t2, dupes, kw = _jax_tables(packed)
    st = Settings()
    reqs = (st.major_gene_key_requirement, st.minor_gene_key_requirement, st.mismatch_threshold)
    exp = jm.map_read_batch(jnp.asarray(codes), jnp.asarray(lens), t1, t2, dupes,
                            packed.shift, packed.max_dupe, *reqs, **kw)
    got = tm.map_read_batch(torch.from_numpy(codes), torch.from_numpy(lens),
                            index_to_torch(packed, CPU), *reqs)
    for g, e in zip(got, exp):
        assert np.array_equal(g.numpy(), np.asarray(e))
    assert got.seg_valid[1].all()  # the 4,200-base read maps across the junction
    assert (got.seg_end[2] > 0).any()


def _smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_captures_the_wide_calls(tmp_path, panel_reads, monkeypatch):
    """chip_smoke.py phase 13's helpers on the CPU. The largest sharded
    map_read of a scan with the long reads is captured and each sharded
    step's wrapper equals its plain version there (on the CPU the wrappers
    run the plain versions; the phase holds the kernels on the card). The
    launch capture keeps the largest wide gated vote and wide
    mask+segments and passes every launch on."""
    smoke = _smoke_module()

    def untimed(name, kernel_fn, plain_fn, exp=None, reps=20, plain_reps=3):
        # a step may return a tuple of tensors (the merge's gate and keys)
        got, ref = kernel_fn(), plain_fn() if exp is None else exp
        gs, rs = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        assert len(gs) == len(rs) and all(torch.equal(g, r) for g, r in zip(gs, rs)), name
        return got, 0, 1.0, 1.0

    monkeypatch.setattr(smoke, "_timed_pair", untimed)
    panel, reads = panel_reads
    eng = ShardedIndexEngine(PortSettings(), devices=[CPU] * 3, batch_size=8)
    with smoke.largest_sharded_call() as calls:
        _reports(panel, _items(panel, reads, False), tmp_path, eng, "sharded", False)
    codes, lens, indexes = calls[0]
    assert codes.shape[1] >= len(reads[1]) and len(indexes) == 3
    rec, aux = smoke.sharded_kernels(codes, lens, indexes)
    assert set(rec) == set(smoke.SHARD_KERNELS)
    assert int(aux["seg"][:, 4:6].max()) > tm.MASK_MAX_WIDTH

    seen = []
    monkeypatch.setattr(cuda, "launch_vote", lambda *a: seen.append(("vote", a[0].shape[0])))
    monkeypatch.setattr(cuda, "launch_mask_segments",
                        lambda *a: seen.append(("mask", a[0].shape[0])))
    pr, pr1, gp, ix = aux["prs"][0], aux["pr1s"][0], aux["gp"], indexes[0]
    B, NS, NK, wide = pr.shape[0], pr.shape[1], pr1.shape[1], torch.zeros(1)
    with smoke.largest_wide_launches() as got:
        cuda.launch_vote(pr[:1].clone(), 1, NS, ix, 2, 40, 20, 1, None, False, wide)
        cuda.launch_vote(pr, B, NS, ix, 2, 40, 20, 1, None, False, wide)
        cuda.launch_vote(pr, B, NS, ix, 2, 0, 0, 1, None, True, wide)  # counts mode
        cuda.launch_vote(pr[:1].clone(), 1, NS, ix, 2, 40, 20, 1, None, False, None)
        cuda.launch_mask_segments(pr1, lens, gp, B, NK, ix, 10, None, wide)
        cuda.launch_mask_segments(pr1, lens, gp, B, NK, ix, 10, None, None)  # narrow
    assert seen == [("vote", 1), ("vote", B), ("vote", B), ("vote", 1), ("mask", B), ("mask", B)]
    assert torch.equal(got["vote"][0], pr) and got["vote"][1:] == (ix, 40, 20)
    assert torch.equal(got["mask_segments"][0], pr1) and got["mask_segments"][3:] == (ix, 10)


# ---------------- the wide paths on the card ----------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [2, 1])
def test_probe_kernel_matches_plain_past_the_old_staging_limit(panel_reads, panel_ix, stride,
                                                               cuda_device):
    """The probe on the card on rows of 150, 240,000 and 300,000 bases:
    bit-equal to plain (its launch no longer refused for shared memory)."""
    codes, lens = _very_long_batch(panel_reads[0], [150, 240_000, 300_000], seed=17)
    packed = build_packed_index(panel_ix, "kv2")
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lens)
    got = tm.probe(ct.to(cuda_device), lt.to(cuda_device), stride,
                   index_to_torch(packed, cuda_device))
    assert torch.equal(got.cpu(), tm.probe(ct, lt, stride, index_to_torch(packed, CPU)))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_wide_kernels_match_plain(panel_reads, panel_ix, layout, cuda_device):
    """The vote's wide path (both modes), mask+segments' wide path and
    mask+segments from flags at the long reads' widths, bit-equal to plain."""
    panel, reads = panel_reads
    codes, lens, packed, cpu = _long_batch(panel, reads, panel_ix, layout)
    dev = index_to_torch(packed, cuda_device)
    cd, ld = codes.to(cuda_device), lens.to(cuda_device)
    pr = tm.probe(codes, lens, 2, cpu)
    assert torch.equal(tm.probe(cd, ld, 2, dev).cpu(), pr)
    prd = pr.to(cuda_device)
    assert torch.equal(tm.vote(prd, dev, 40, 20).cpu(), tm.vote_plain(pr, cpu, 40, 20))
    assert torch.equal(tm.vote_counts(prd, dev).cpu(), tm.vote_counts_plain(pr, cpu))
    gp = tm.vote_plain(pr, cpu, 40, 20)[:, 1:5].contiguous()
    pr1 = tm.probe(codes, lens, 1, cpu)
    NK = pr1.shape[1]
    exp = tm.mask_segments_plain(pr1, lens, gp, cpu, 10)
    got = tm.mask_segments(pr1.to(cuda_device), ld, gp.to(cuda_device), dev, 10)
    assert torch.equal(got.cpu(), exp)
    words = tm.shard_flags([pr1.to(cuda_device)], ld, gp.to(cuda_device), [dev])
    assert torch.equal(words.cpu(), tm.shard_flags_plain(pr1, gp, cpu))
    assert torch.equal(tm.mask_from_flags(words, ld, gp.to(cuda_device), NK, 10).cpu(), exp)


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True])
def test_cuda_engines_scan_long_reads(tmp_path, panel_reads, paired, cuda_device):
    panel, reads = panel_reads
    items = _items(panel, reads, paired)
    host = _reports(panel, items, tmp_path, HostEngine(), "host", paired)
    for tag, eng in (("torch", TorchEngine(PortSettings(), batch_size=32, device="cuda")),
                     ("sharded", ShardedIndexEngine(PortSettings(), devices=[cuda_device] * 3,
                                                    batch_size=32))):
        assert _reports(panel, items, tmp_path, eng, tag, paired) == host, tag
