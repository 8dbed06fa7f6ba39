"""The gather-floor probe's plain version against the JAX package's TPU
kernel in interpret mode (tools/profiling/profile_dma_ring.py), on table
values that make the int32 tile sums wrap. Integer outputs: bit-equal."""

import importlib.util
import os

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
@pytest.mark.parametrize("W", [1, 2, 3, 8, 12, 128, 256])
def test_gather_kernel_matches_plain(W, lanes, cuda_device):
    idx, tbl = _inputs(1 << 12, W, 5, seed=W)
    i, t = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(tbl).to(cuda_device)
    got = gf.gather_tile_sums(i, t, lanes)
    assert torch.equal(got.cpu(), gf.tile_row_sums(i.cpu(), t.cpu(), lanes))
