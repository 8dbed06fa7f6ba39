"""The port's `fused_scan_lanes` against the JAX package's, on 1 to 3 code
lanes of unequal widths with non-ACGT exceptions (some out of range, which
must be dropped) and with more vote survivors than the cap."""

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.core.sequence import BASE_CODE_LUT
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.ops.hashtable import pack_index, pack_index_kv
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch.ops.fused import fused_scan_lanes
from genefuserust_tpu_torch.ops.index import index_to_torch


@pytest.fixture(scope="module")
def panel_ix(tmp_path_factory):
    panel = make_panel(seed=5)
    _, csv_path = write_panel_files(panel, str(tmp_path_factory.mktemp("panel")))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), Settings())
    ix.make_index()
    return panel, ix


def _lane_reads(panel, n, seed):
    """n reads: a third junction reads (vote survivors), the rest in-gene
    or random; some with N / lowercase bases."""
    rng = np.random.default_rng(seed)
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    fused = (panel.contigs[c1][s1 + 4600 : s1 + 5001]
             + panel.contigs[c2][s2 + 6000 : s2 + 6400])
    reads = []
    for k in range(n):
        ln = int(rng.integers(60, 151))
        if k % 3 == 0:
            ln = max(ln, 100)
            off = int(rng.integers(431 - ln, 372))
            s = fused[off : off + ln]
        else:
            g = panel.contigs[(c1, c2)[k % 2]]
            off = int(rng.integers(0, len(g) - ln))
            s = g[off : off + ln]
        b = bytearray(s.encode())
        for p in rng.integers(0, ln, size=int(rng.integers(0, 3))):
            b[int(p)] = ord("N") if rng.random() < 0.7 else ord("a")
        reads.append(bytes(b))
    return reads


def _pack_lane(reads, P, W):
    """-> (P, W/4) 2-bit rows, (P,) lengths, [(row, col)] exceptions."""
    codes = np.zeros((P, W), np.uint8)
    lens = np.zeros(P, np.int32)
    exc = []
    for i, r in enumerate(reads):
        c = BASE_CODE_LUT[np.frombuffer(r, np.uint8)]
        exc += [(i, int(j)) for j in np.nonzero(c == 255)[0]]
        codes[i, : len(c)] = np.where(c == 255, 0, c)
        lens[i] = len(c)
    packed = (codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4)
              | (codes[:, 3::4] << 6)).astype(np.uint8)
    return packed, lens, exc


def _lanes(panel, spec, seed):
    """spec: [(rows, live rows, width)] -> bufs, lens, exc (E, 2)."""
    bufs, lens, exc = [], [], []
    off = 0
    for k, (P, n, W) in enumerate(spec):
        b, ln, e = _pack_lane(_lane_reads(panel, n, seed + k), P, W)
        bufs.append(b)
        lens.append(ln)
        exc += [(r + off, c) for r, c in e]
        off += P
    N = off
    # pad entries past every lane, and entries in range for the row space
    # but past the lane's width (both dropped)
    exc += [(N, 0), (N + 5, 3), (0, spec[0][2] + 7), (N - 1, 10_000)]
    return bufs, lens, np.array(exc, np.int32)


def _run_both(ix, packed, bufs, lens, exc, widths, cap):
    import jax.numpy as jnp

    from genefuserust_tpu.ops import fused as jf

    st = ix.settings
    reqs = dict(major_req=st.major_gene_key_requirement,
                minor_req=st.minor_gene_key_requirement,
                mismatch_thr=st.mismatch_threshold)
    if hasattr(packed, "kv_tbl"):
        tabs = (jnp.asarray(packed.kv_tbl), jnp.zeros((1, 2), jnp.int32))
        kw = dict(kv=True, cbits=packed.cbits, pos_bias=packed.pos_bias)
    else:
        tabs = (jnp.asarray(packed.keys_tbl), jnp.asarray(packed.vals_tbl))
        kw = {}
    out_j, okw_j = jf.fused_scan_lanes(
        tuple(jnp.asarray(b) for b in bufs), tuple(jnp.asarray(x) for x in lens),
        jnp.asarray(exc), *tabs, jnp.asarray(packed.dupes), widths=widths, cap=cap,
        shift=packed.shift, max_dupe=packed.max_dupe, **reqs, **kw,
    )
    out_t, okw_t = fused_scan_lanes(
        tuple(torch.from_numpy(b) for b in bufs), tuple(torch.from_numpy(x) for x in lens),
        torch.from_numpy(exc), index_to_torch(packed, "cpu"), widths=widths, cap=cap,
        **reqs,
    )
    return (np.asarray(out_j), np.asarray(okw_j)), (out_t.numpy(), okw_t.numpy())


CASES = {
    # name: (lanes [(rows, live rows, width)], cap)
    "one_lane": ([(48, 40, 160)], 64),
    "two_lanes": ([(64, 50, 192), (40, 33, 160)], 64),
    "three_lanes_over_cap": ([(70, 60, 256), (8, 8, 224), (45, 30, 160)], 5),
}


@pytest.mark.parametrize("layout", ["kv2", "split"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_scan_lanes_matches_jax(panel_ix, case, layout):
    panel, ix = panel_ix
    spec, cap = CASES[case]
    packed = (pack_index(ix) if layout == "split"
              else pack_index_kv(ix, target_load=0.5, slots=1))
    bufs, lens, exc = _lanes(panel, spec, seed=len(case))
    widths = tuple(w for _, _, w in spec)
    (out_j, okw_j), (out_t, okw_t) = _run_both(ix, packed, bufs, lens, exc, widths, cap)
    assert out_t.shape == out_j.shape == (cap + 1, 13)
    n = int(out_j[-1, 0])
    assert n > 0
    if case == "three_lanes_over_cap":
        assert n > cap
    # what the engine reads: the survivor rows [0, min(n, cap)), the count
    # row and the bitmap. Rows past the survivor count are JAX artifacts
    # (pass 2 over non-survivors) and are not part of the contract.
    m = min(n, cap)
    assert (out_t[:m] == out_j[:m]).all()
    assert (out_t[-1] == out_j[-1]).all()
    assert okw_t.dtype == np.int32 and (okw_t == okw_j).all()
    assert (out_j[:m, 2] & out_j[:m, 3]).any()  # some two-segment hits


@pytest.mark.parametrize("L", [16, 150, 161])
def test_unpack_seq2_matches_jax(L):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.pack import pack_q2, unpack_seq2_jnp
    from genefuserust_tpu_torch.ops.pack import unpack_seq2

    codes = np.random.default_rng(L).integers(0, 4, (37, L), dtype=np.uint8)
    packed = pack_q2(codes)
    exp = np.asarray(unpack_seq2_jnp(jnp.asarray(packed), L))
    got = unpack_seq2(torch.from_numpy(packed), L).numpy()
    assert got.dtype == np.uint8 and (got == exp).all() and (got == codes).all()


def test_okwords_bit_31_wraps_like_jax(panel_ix):
    """Row 31 of a word sets bit 31: the uint32 OR is stored as a negative
    int32, exactly as JAX stores it (no saturation)."""
    panel, ix = panel_ix
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    junction = (panel.contigs[c1][s1 + 4925 : s1 + 5001]
                + panel.contigs[c2][s2 + 6000 : s2 + 6074]).encode()
    lane = ([b"ACGT" * 20] * 31 + [junction]) * 2
    b, ln, e = _pack_lane(lane, 64, 160)
    exc = np.array(e + [(64, 0)], np.int32)
    packed = pack_index_kv(ix, target_load=0.5, slots=1)
    (out_j, okw_j), (out_t, okw_t) = _run_both(ix, packed, [b], [ln], exc, (160,), 8)
    assert (okw_j < 0).all() and (okw_t == okw_j).all()
