"""The gather-floor probe's plain version, and a mirror of its kernel's
slicing and combine, against the JAX package's TPU kernel in interpret
mode (tools/profiling/profile_dma_ring.py), on table values that make the
int32 tile sums wrap. Integer outputs: bit-equal."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from genefuserust_tpu_torch.profiling import gather_floor as gf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dma_ring():
    path = os.path.join(REPO, "tools", "profiling", "profile_dma_ring.py")
    spec = importlib.util.spec_from_file_location("profile_dma_ring", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(nb, W, tiles, seed):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(-2**31, 2**31, (nb, W), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, nb, tiles * gf.TILE).astype(np.int32)
    idx[:3] = [0, nb - 1, 0]
    return idx, tbl


# ---------------- a mirror of csrc/gather_sum.cu ----------------

CU = os.path.join(REPO, "genefuserust_tpu_torch", "csrc", "gather_sum.cu")


def _cu_shape():
    """The kernel's default launch shape (its -D macros, without the
    GATHER_ prefix) and its most threads a block, read from the source."""
    src = open(CU).read()
    shape = {k: int(v) for k, v in re.findall(r"#define GATHER_(\w+) (\d+)", src)}
    shape["MAX_THREADS"] = int(re.search(r"constexpr int MAX_THREADS = (\d+);", src).group(1))
    return shape


def _kernel_gather(idx, tbl, lanes, shape):
    """gf_gather_tile_sums step for step in uint32: each tile's cluster of
    C blocks, each block's slice of 1024 / C rows, its row groups (U rows
    a group a round, Lr lanes a row), warp, block and cluster sums ->
    (out, times each table element of each index was added)."""
    nb, W = tbl.shape
    t32 = tbl.view(np.uint32)
    tiles = len(idx) // gf.TILE
    added = np.zeros((len(idx), W), np.int64)
    out = np.zeros((tiles, lanes), np.uint32)
    kind = "WIDE" if W % 4 == 0 else "NARROW"
    C, U = shape[f"{kind}_BLOCKS"], shape[f"{kind}_LOADS"]
    V = 4 if W % 4 == 0 else 2 if W % 2 == 0 else 1
    nv, Lr = W // V, 1
    while Lr * 2 <= nv and Lr * 2 <= 32:
        Lr *= 2
    n = gf.TILE // C
    threads = min(shape["MAX_THREADS"], max(32, -(-(Lr * n // U) // 32) * 32))
    G = threads // Lr
    with np.errstate(over="ignore"):  # uint32 sums wrap, as the kernel's do
        for tile in range(tiles):
            block_sums = []
            for rank in range(C):
                base = tile * gf.TILE + rank * n
                lane_acc = np.zeros(threads, np.uint32)
                for tid in range(threads):
                    lane, grp = tid % Lr, tid // Lr
                    for r0 in range(grp, n, G * U):
                        for r in range(r0, min(n, r0 + U * G), G):
                            for j in range(lane, nv, Lr):
                                lane_acc[tid] += t32[idx[base + r], j * V : j * V + V].sum(
                                    dtype=np.uint32)
                                added[base + r, j * V : j * V + V] += 1
                block_sums.append(lane_acc.sum(dtype=np.uint32))
            out[tile] = np.array(block_sums, np.uint32).sum(dtype=np.uint32)
    return out.view(np.int32)[:, 0] if lanes == 1 else out.view(np.int32), added


@pytest.fixture(scope="module")
def ring_outputs():
    """profile_dma_ring.py's kernel in interpret mode at W 1, 2, 8 and 128
    (NFLIGHT 4), on 2 tiles of a 512-row table -> {W: (idx, tbl, sums)}."""
    import jax.numpy as jnp

    ring = _dma_ring()
    res = {}
    for W in (1, 2, 8, 128):
        idx, tbl = _inputs(512, W, 2, seed=40 + W)
        res[W] = idx, tbl, np.asarray(ring.build(512, W, 4, 2, interpret=True)(
            jnp.asarray(idx), jnp.asarray(tbl)))
    return res


# the default shape, then shapes of `chip_smoke.py --gather-sweep`'s grid
# (blocks a tile x row loads a thread), for wide and narrow rows alike
SWEEP_SHAPES = [{}] + [{f"{k}_{x}": v for k in ("WIDE", "NARROW") for x, v in
                        (("BLOCKS", c), ("LOADS", u))}
                       for c, u in ((1, 4), (1, 32), (2, 8), (4, 16), (8, 4), (8, 32))]


@pytest.mark.parametrize("over", SWEEP_SHAPES)
@pytest.mark.parametrize("lanes", [1, 128])
@pytest.mark.parametrize("W", [1, 2, 8, 128])
def test_kernel_mirror_matches_dma_ring_kernel(ring_outputs, W, lanes, over):
    idx, tbl, exp = ring_outputs[W]
    wide = tbl.astype(np.int64)[idx].reshape(2, -1).sum(1)
    assert (np.abs(wide) > 2**31).any()  # the sums wrap
    got, added = _kernel_gather(idx, tbl, lanes, {**_cu_shape(), **over})
    assert (added == 1).all()  # every element of every row, once
    want = exp if lanes == 1 else np.broadcast_to(exp[:, None], (2, 128))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nflight", [1, 4])
@pytest.mark.parametrize("W", [2, 8, 128])
def test_tile_row_sums_match_dma_ring_kernel(W, nflight):
    import jax.numpy as jnp

    ring = _dma_ring()
    nb, tiles = 512, 2
    idx, tbl = _inputs(nb, W, tiles, seed=W + nflight)
    run = ring.build(nb, W, nflight, tiles, interpret=True)
    exp = np.asarray(run(jnp.asarray(idx), jnp.asarray(tbl)))
    got = gf.tile_row_sums(torch.from_numpy(idx), torch.from_numpy(tbl))
    assert got.dtype == torch.int32 and got.shape == (tiles,)
    assert np.array_equal(got.numpy(), exp)
    # the sums wrapped: their int64 values lie outside int32
    wide = tbl.astype(np.int64)[idx].reshape(tiles, -1).sum(1)
    assert (np.abs(wide) > 2**31).any()
    assert np.array_equal(got.numpy(), ring.ref_sums(idx, tbl, tiles))


def test_lanes_128_is_the_dma_ring_sum_broadcast():
    # profile_pallas_gather.py's kernel has no CPU entry: its main() puts a
    # 2^22 x 128 table on the default device and takes no interpret flag.
    # It writes each tile's sum broadcast over 128 lanes (its line 79), so
    # lanes=128 is held against the DMA-ring kernel's interpret output,
    # broadcast the same way.
    import jax.numpy as jnp

    ring = _dma_ring()
    nb, W, tiles = 512, 128, 2
    idx, tbl = _inputs(nb, W, tiles, seed=5)
    exp = np.asarray(ring.build(nb, W, 2, tiles, interpret=True)(jnp.asarray(idx),
                                                                   jnp.asarray(tbl)))
    got = gf.gather_tile_sums(torch.from_numpy(idx), torch.from_numpy(tbl), lanes=128)
    assert got.shape == (tiles, 128)
    assert np.array_equal(got.numpy(), np.broadcast_to(exp[:, None], (tiles, 128)))


def test_wrapper_checks_inputs():
    idx, tbl = _inputs(64, 2, 1, seed=0)
    i, t = torch.from_numpy(idx), torch.from_numpy(tbl)
    with pytest.raises(ValueError, match="whole tiles"):
        gf.gather_tile_sums(i[:1000], t)
    with pytest.raises(ValueError, match="lanes"):
        gf.gather_tile_sums(i, t, lanes=8)
    with pytest.raises(ValueError, match="int32"):
        gf.gather_tile_sums(i.long(), t)
    assert torch.equal(gf.gather_tile_sums(i, t), gf.tile_row_sums(i, t))


def test_rates_count_sectors():
    r = gf.rates(rows=1000, width=2, ms=1.0)
    assert r["requested_bytes_per_s"] == 1000 * 8 * 1e3
    assert r["sector_bytes_per_s"] == 1000 * 32 * 1e3
    assert gf.rates(1000, 128, 1.0)["sector_bytes_per_s"] == 1000 * 512 * 1e3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 128])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 8, 12, 64, 128, 256, 1024])
def test_gather_kernel_matches_plain(W, lanes, cuda_device):
    idx, tbl = _inputs(1 << 12, W, 5, seed=W)
    i, t = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(tbl).to(cuda_device)
    got = gf.gather_tile_sums(i, t, lanes)
    assert torch.equal(got.cpu(), gf.tile_row_sums(i.cpu(), t.cpu(), lanes))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1024, 1028, 1030, 12800])
def test_gather_kernel_matches_plain_at_wide_rows(W, cuda_device):
    # rows of 4 KB and more, of whole 16 bytes (1024, 1028) and not
    idx, tbl = _inputs(64, W, 2, seed=W)
    i, t = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(tbl).to(cuda_device)
    for lanes in (1, 128):
        got = gf.gather_tile_sums(i, t, lanes)
        assert torch.equal(got.cpu(), gf.tile_row_sums(i.cpu(), t.cpu(), lanes))
