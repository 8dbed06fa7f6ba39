"""The port's `fused_scan_lanes` against the JAX package's, on 1 to 3 code
lanes of unequal widths with non-ACGT exceptions (some out of range, which
must be dropped, and some at negative columns, which count from the row's
end as in JAX), with more vote survivors than the cap, none, every row a
survivor, fewer rows than the cap, and lane boundaries inside a 32-row
word of the bitmap."""

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.core.sequence import BASE_CODE_LUT
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.ops.hashtable import (
    pack_index,
    pack_index_kv,
    pack_index_kv16,
    pack_index_kvs,
)
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch.ops.fused import fused_scan_lanes
from genefuserust_tpu_torch.ops.index import index_to_torch

from test_torch_map_read import jax_kv


@pytest.fixture(scope="module")
def panel_ix(tmp_path_factory):
    panel = make_panel(seed=5)
    _, csv_path = write_panel_files(panel, str(tmp_path_factory.mktemp("panel")))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), Settings())
    ix.make_index()
    return panel, ix


def _lane_reads(panel, n, seed, kind="mixed"):
    """n reads: "mixed", a third junction reads (vote survivors) and the
    rest in-gene; "genic", all in-gene; "junction", all 150-base junction
    reads centred on the junction (every one a survivor). Some with N /
    lowercase bases."""
    rng = np.random.default_rng(seed)
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    fused = (panel.contigs[c1][s1 + 4600 : s1 + 5001]
             + panel.contigs[c2][s2 + 6000 : s2 + 6400])
    reads = []
    for k in range(n):
        ln = int(rng.integers(60, 151))
        if kind == "junction":
            ln = 150
            off = int(rng.integers(316, 337))
            s = fused[off : off + ln]
        elif kind == "mixed" and k % 3 == 0:
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


def _lanes(panel, spec, seed, negative=False):
    """spec: [(rows, live rows, width[, reads kind])] -> bufs, lens, exc
    (E, 2). `negative`: add entries at negative columns: -1, -W_i and
    -W_i - 1 (dropped) on every other live row, and -W_i + j for the first
    24 bases of every third, which JAX sets to 255 (columns j)."""
    bufs, lens, exc = [], [], []
    off = 0
    for k, (P, n, W, *kind) in enumerate(spec):
        b, ln, e = _pack_lane(_lane_reads(panel, n, seed + k, *kind), P, W)
        bufs.append(b)
        lens.append(ln)
        exc += [(r + off, c) for r, c in e]
        if negative:
            exc += [(r + off, c) for r in range(0, n, 2) for c in (-1, -W, -W - 1)]
            exc += [(r + off, j - W) for r in range(1, n, 3) for j in range(24)]
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
        kw = dict(kv=jax_kv(packed), cbits=packed.cbits, pos_bias=packed.pos_bias)
    else:
        tabs = (jnp.asarray(packed.keys_tbl), jnp.asarray(packed.vals_tbl))
        kw = {}
    out_j, okw_j = jf.fused_scan_lanes(
        tuple(jnp.asarray(b) for b in bufs), tuple(jnp.asarray(x) for x in lens),
        jnp.asarray(exc), *tabs, jnp.asarray(packed.dupes), widths=widths, cap=cap,
        shift=packed.shift, max_dupe=packed.max_dupe, **reqs, **kw,
    )
    out_t, okw_t = fused_scan_lanes(
        tuple(torch.from_numpy(b) for b in bufs), torch.from_numpy(np.concatenate(lens)),
        torch.from_numpy(exc), index_to_torch(packed, "cpu"), widths=widths, cap=cap,
        **reqs,
    )
    return (np.asarray(out_j), np.asarray(okw_j)), (out_t.numpy(), okw_t.numpy())


CASES = {
    # name: (lanes [(rows, live rows, width[, reads kind])], cap)
    "one_lane": ([(48, 40, 160)], 64),
    "two_lanes": ([(64, 50, 192), (40, 33, 160)], 64),
    "three_lanes_over_cap": ([(70, 60, 256), (8, 8, 224), (45, 30, 160)], 5),
    # exceptions at negative columns (_lanes(negative=True))
    "negative_exc_cols": ([(64, 50, 192), (40, 33, 160)], 64),
    "zero_survivors": ([(64, 60, 160, "genic"), (32, 30, 192, "genic")], 64),
    "n_below_cap": ([(40, 30, 160)], 64),
    "all_survivors_over_cap": ([(64, 64, 160, "junction"), (40, 40, 192, "junction")], 40),
    # lane 1 starts at row 40, inside the bitmap's word of rows 32-63
    "lane_boundary_mid_word": ([(40, 36, 192), (21, 21, 160)], 64),
    # no row placed: the second pass runs on none
    "cap_zero": ([(64, 50, 192), (40, 33, 160)], 0),
}


PACKERS = {
    "kv2": lambda ix: pack_index_kv(ix, target_load=0.5, slots=1),
    "kvs": pack_index_kvs,
    "kv16": pack_index_kv16,
    "split": pack_index,
}


@pytest.mark.parametrize("layout", sorted(PACKERS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_scan_lanes_matches_jax(panel_ix, case, layout):
    panel, ix = panel_ix
    spec, cap = CASES[case]
    packed = PACKERS[layout](ix)
    bufs, lens, exc = _lanes(panel, spec, seed=len(case), negative=case == "negative_exc_cols")
    widths = tuple(w for _, _, w, *_ in spec)
    (out_j, okw_j), (out_t, okw_t) = _run_both(ix, packed, bufs, lens, exc, widths, cap)
    assert out_t.shape == out_j.shape == (cap + 1, 13)
    N = sum(P for P, *_ in spec)
    n = int(out_j[-1, 0])
    if case == "zero_survivors":
        assert n == 0
    else:
        assert n > 0
    if case in ("three_lanes_over_cap", "all_survivors_over_cap"):
        assert n > cap
    if case == "all_survivors_over_cap":
        assert n == N
    if case == "cap_zero":
        assert n > cap == 0
    if case == "n_below_cap":
        assert N < cap
    # what the engine reads: the survivor rows [0, min(n, cap)), the count
    # row and the bitmap. Rows past the survivor count are JAX artifacts
    # (pass 2 over non-survivors) and are not part of the contract, but
    # their sidx and svalid are (the stable compaction), and rows from
    # min(cap, N) on are zero.
    m, c = min(n, cap), min(cap, N)
    assert (out_t[:m] == out_j[:m]).all()
    assert (out_t[:c, :2] == out_j[:c, :2]).all()
    assert (out_t[c:cap] == out_j[c:cap]).all() and not out_t[c:cap].any()
    # the count row; its columns 1-2 are the port's row counter of the vote
    # (JAX's hold zeros): every row voted on the warp path, none sorted
    assert out_t[cap, 0] == out_j[cap, 0] and (out_t[cap, 3:] == out_j[cap, 3:]).all()
    assert out_t[cap, 1] == N and out_t[cap, 2] == 0
    assert okw_t.dtype == np.int32 and (okw_t == okw_j).all()
    if m:
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(PACKERS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_scan_lanes_card_matches_cpu(panel_ix, case, layout, cuda_device):
    # the whole call on the card (the glue kernels, the probe, the vote and
    # mask+segments) against the CPU's plain versions, every row
    from genefuserust_tpu_torch.ops import cuda

    panel, ix = panel_ix
    spec, cap = CASES[case]
    packed = PACKERS[layout](ix)
    bufs, lens, exc = _lanes(panel, spec, seed=len(case), negative=case == "negative_exc_cols")
    widths = tuple(w for _, _, w, *_ in spec)

    def run(dev):
        return fused_scan_lanes(
            tuple(torch.from_numpy(b).to(dev) for b in bufs),
            torch.from_numpy(np.concatenate(lens)).to(dev), torch.from_numpy(exc).to(dev),
            index_to_torch(packed, dev), widths=widths, cap=cap)

    out_c, okw_c = run("cpu")
    before = dict(cuda.LAUNCHES)
    out_d, okw_d = run(cuda_device)
    assert torch.equal(out_d.cpu(), out_c) and torch.equal(okw_d.cpu(), okw_c)
    glue = ("lane_unpack", "lane_exceptions", "compact_count", "compact_place", "survivor_rows")
    ran = {k: cuda.LAUNCHES[k] - before[k] for k in glue}
    # one launch of each a batch; the place launch copies the survivors'
    # code rows (at most 8 lanes: no survivor_rows launch)
    assert ran == {**dict.fromkeys(glue[:4], 1), "survivor_rows": 0}
    # the single-probe tables go through the probe's variant
    probe = {"kvs": "probe_kvs", "kv16": "probe_kv16"}.get(layout, "probe")
    assert cuda.LAUNCHES[probe] > before[probe]
