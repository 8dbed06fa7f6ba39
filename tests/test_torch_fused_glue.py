"""The glue kernels of `fused_scan_lanes` (csrc/fused_glue.cu): Python
mirrors of their steps, held to the plain versions (ops/fused.py) and to
the JAX pieces they replace (`unpack_seq2_jnp` with the exception
scatter, the argsort compaction and the okwords sum, the gather of the
padded lanes), bit for bit. The `cuda`-marked tests hold each kernel to
its plain version on the card."""

import numpy as np
import pytest
import torch

from genefuserust_tpu_torch.ops import fused as tf

# mirrors of the launch constants of csrc/fused_glue.cu
UNPACK_THREADS = 512
UNPACK_MAX_BLOCKS = 264
COMPACT_WARPS = 32
COMPACT_WORDS = 8
ROWS_THREADS = 256
ROWS_MAX_BLOCKS = 132 * 16

# rows of the three lanes at each N: lane offsets that are not multiples of
# 32, so lane boundaries fall inside okwords' words
LANE_ROWS = {123: (70, 8, 45), 1023: (500, 8, 515), 1025: (513, 37, 475),
             65568: (40000, 5, 25563)}
WIDTHS = (192, 150, 161)
SIZES = sorted(LANE_ROWS)


def _caps(N):
    return (5, 1024, N + 7)


def _lanes(N, seed):
    """Three lanes of 2-bit rows (widths 192, 150, 161; the packed rows
    one byte wider than needed for 150 and 161) and an exception list in
    the concatenated row space: random entries, and negative, past-the-width
    and out-of-lane columns at every lane's edges."""
    rng = np.random.default_rng(seed)
    bufs, exc, off = [], [], 0
    for P, W in zip(LANE_ROWS[N], WIDTHS):
        bufs.append(rng.integers(0, 256, (P, (W + 3) // 4 + (W % 4 > 0)), dtype=np.uint8))
        for r in (off, off + P - 1, off + P // 2):
            exc += [(r, c) for c in (0, W - 1, W, -1, -W, -W - 1, -2 * W, 2**31 - 1, -2**31)]
        off += P
    E = 4 * N
    exc += list(zip(rng.integers(-5, N + 5, E).tolist(), rng.integers(-200, 200, E).tolist()))
    return bufs, np.array(exc, np.int32)


def _votes(N, density, seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(-2**31, 2**31, (N, 5), dtype=np.int64).astype(np.int32)
    v[:, 0] = (rng.random(N) < density) * rng.integers(1, 3, N)
    lens = rng.integers(0, 300, N).astype(np.int32)
    return v, lens


# ---------------- mirrors of the kernels ----------------


def _kernel_lane_unpack(buf, W, exc, off):
    """lane_unpack_kernel: blocks of UNPACK_THREADS own contiguous ranges of
    16-byte chunks of the flat (P, W) output; a chunk's bytes step through
    the rows (a row end moves to the next packed row); after the barrier a
    block sets the entries whose flat position lies in its range."""
    P, Wb = buf.shape
    total = P * W
    out = np.zeros(total, np.uint8)
    chunks = (total + 15) // 16
    if chunks == 0:
        return out.reshape(P, W)
    grid = min(UNPACK_MAX_BLOCKS, -(-chunks // UNPACK_THREADS))
    per_block = -(-chunks // grid)
    flat_buf = buf.reshape(-1)
    r = exc[:, 0].astype(np.int64) - off
    ecol = exc[:, 1].astype(np.int64)
    col = np.where(ecol < 0, ecol + W, ecol)
    keep = (r >= 0) & (r < P) & (col >= 0) & (col < W)
    at = (r * W + col)[keep]
    for b in range(grid):
        c0, c1 = b * per_block, min(chunks, b * per_block + per_block)
        lo, hi = 16 * c0, min(total, 16 * c1)
        if lo >= hi:
            continue
        j = np.arange(lo, hi)
        row, cc = j // W, j % W
        out[lo:hi] = (flat_buf[row * Wb + (cc >> 2)] >> (2 * (cc & 3))) & 3
        out[at[(at >= lo) & (at < hi)]] = 255
    return out.reshape(P, W)


def _kernel_compact(v, lens, cap):
    """compact_kernel: one block of COMPACT_WARPS warps walks the rows in
    steps; warp w ballots COMPACT_WORDS words of 32 rows (the bitmap's
    words), the block scans the warps' popcounts, and a row's slot is the
    walk's first slot + the running count + the warp's prefix + the
    popcounts of its earlier words + the bits below its lane. The second
    walk over rows [0, c) places the non-survivors after the S survivors."""
    N = v.shape[0]
    c = min(cap, N)
    out = np.zeros((cap + 1, 13), np.int32)
    slens = np.zeros(c, np.int32)
    gp = np.zeros((c, 4), np.int32)
    nw = (N + 31) // 32
    words = np.zeros(nw, np.uint32)
    ok = v[:, 0] != 0
    step = COMPACT_WARPS * COMPACT_WORDS * 32
    lane_bit = np.uint32(1) << np.arange(32, dtype=np.uint32)

    def walk(limit, want, first, write_words):
        carry = 0
        for base in range(0, limit, step):
            i = base + np.arange(step).reshape(COMPACT_WARPS, COMPACT_WORDS, 32)
            take = (i < limit) & (ok[np.minimum(i, N - 1)] == want)
            m = (take * lane_bit).sum(2, dtype=np.uint32)  # the ballots
            if write_words:
                wi = (base >> 5) + np.arange(COMPACT_WARPS * COMPACT_WORDS)
                words[wi[wi < nw]] = m.reshape(-1)[wi < nw]
            pop = np.vectorize(lambda x: bin(int(x)).count("1"))(m)
            cnt = pop.sum(1)
            s = np.cumsum(cnt)  # the warps' inclusive scan
            at = first + carry + (s - cnt)[:, None] + np.cumsum(pop, 1) - pop
            below = np.cumsum(take, 2) - take  # popc(m & below) of each lane
            slot = at[:, :, None] + below
            sel = take & (slot < c)
            rows, slots = i[sel], slot[sel]
            out[slots, 0] = rows
            out[slots, 1] = int(want)
            slens[slots] = lens[rows] if want else 0
            gp[slots] = v[rows, 1:5]
            carry += int(s[-1])
        return carry

    S = walk(N, True, 0, True)
    out[cap, 0] = S
    if S < c:
        walk(c, False, S, False)
    return out, slens, gp, words.view(np.int32)


def _kernel_survivor_rows(lanes, sidx, Wmax):
    """survivor_rows_kernel: thread t of the grid-stride loop takes chunk
    (r, j) = divmod(t, ceil(Wmax / 16)) of the output, finds the lane that
    holds row sidx[r] and copies 16 bytes of it, 255 past its width."""
    c = len(sidx)
    out = np.zeros((c, Wmax), np.uint8)
    cw = -(-Wmax // 16)
    total = c * cw
    offs = np.cumsum([0] + [t.shape[0] for t in lanes])
    threads = min(ROWS_MAX_BLOCKS, -(-total // ROWS_THREADS)) * ROWS_THREADS
    for t0 in range(0, total, threads):
        t = np.arange(t0, min(total, t0 + threads))
        r, j = t // cw, 16 * (t % cw)
        s = sidx[r].astype(np.int64)
        for q, codes in enumerate(lanes):
            mine = (s >= offs[q]) & (s < offs[q + 1])
            Wi = codes.shape[1]
            for k in range(16):
                jj = j[mine] + k
                inside = jj < Wmax
                rr, sr, jj = r[mine][inside], s[mine][inside] - offs[q], jj[inside]
                out[rr, jj] = np.where(jj < Wi, codes[sr, np.minimum(jj, Wi - 1)], 255)
    return out


# ---------------- the JAX pieces ----------------


def _jax_lane_codes(buf, W, exc, off):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.pack import unpack_seq2_jnp

    P = buf.shape[0]
    erow, ecol = jnp.asarray(exc[:, 0]), jnp.asarray(exc[:, 1])
    ci = unpack_seq2_jnp(jnp.asarray(buf), W).astype(jnp.uint8)
    ri = jnp.where((erow >= off) & (erow < off + P), erow - off, P)
    inv = jnp.full(erow.shape, 255, jnp.uint8)
    return np.asarray(ci.at[ri, ecol].set(inv, mode="drop"))


def _jax_compact(v, lens, cap):
    """fused_scan_lanes' compaction and bitmap (genefuserust_tpu/ops/
    fused.py), on the concatenated vote rows."""
    import jax
    import jax.numpy as jnp

    N = v.shape[0]
    ok = jnp.asarray(v[:, 0]) != 0
    iota = jax.lax.iota(jnp.int32, N)
    order = jnp.argsort(jnp.where(ok, iota, N + iota))
    c = min(cap, N)
    sidx = order[:c]
    svalid = jnp.take(ok, sidx)
    slens = jnp.where(svalid, jnp.take(jnp.asarray(lens), sidx), 0)
    gp = jnp.stack([jnp.take(jnp.asarray(v[:, k]), sidx) for k in range(1, 5)], axis=1)
    nw = (N + 31) // 32
    okp = jnp.zeros(nw * 32, jnp.uint32).at[:N].set(ok.astype(jnp.uint32))
    weights = jnp.uint32(1) << jax.lax.iota(jnp.int32, 32).astype(jnp.uint32)
    okwords = (okp.reshape(nw, 32) * weights[None, :]).sum(axis=1).astype(jnp.int32)
    return (np.asarray(sidx), np.asarray(svalid), np.asarray(slens), np.asarray(gp),
            int(ok.sum()), np.asarray(okwords))


def _jax_survivor_rows(lanes, sidx, Wmax):
    import jax.numpy as jnp

    padded = [jnp.concatenate([jnp.asarray(a), jnp.full((a.shape[0], Wmax - a.shape[1]), 255,
                                                        jnp.uint8)], axis=1)
              if a.shape[1] < Wmax else jnp.asarray(a) for a in lanes]
    return np.asarray(jnp.take(jnp.concatenate(padded, axis=0), jnp.asarray(sidx), axis=0))


# ---------------- mirrors against plain and JAX ----------------


@pytest.mark.parametrize("N", SIZES)
def test_lane_unpack_mirror_matches_plain_and_jax(N):
    bufs, exc = _lanes(N, seed=N)
    off = 0
    for buf, W in zip(bufs, WIDTHS):
        got = _kernel_lane_unpack(buf, W, exc, off)
        plain = tf.lane_codes(torch.from_numpy(buf), W, torch.from_numpy(exc), off).numpy()
        assert np.array_equal(got, plain)
        assert np.array_equal(got, _jax_lane_codes(buf, W, exc, off))
        assert (got == 255).any() and (got[:, -1] == 255).any() and (got[:, 0] == 255).any()
        off += buf.shape[0]


def _check_compact(v, lens, cap):
    N = v.shape[0]
    c = min(cap, N)
    out, slens, gp, okw = _kernel_compact(v, lens, cap)
    p_out, p_slens, p_gp, p_okw = (t.numpy() for t in tf.compact(
        torch.from_numpy(v), torch.from_numpy(lens), cap))
    for a, b in ((out, p_out), (slens, p_slens), (gp, p_gp), (okw, p_okw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    sidx, svalid, jslens, jgp, count, jokw = _jax_compact(v, lens, cap)
    assert np.array_equal(out[:c, 0], sidx) and np.array_equal(out[:c, 1], svalid)
    assert np.array_equal(slens, jslens) and np.array_equal(gp, jgp)
    assert out[cap, 0] == count and np.array_equal(okw, jokw)
    assert not out[:, 2:].any() and not out[c:cap].any() and not out[cap, 1:].any()
    return count


@pytest.mark.parametrize("cap_at", range(3))
@pytest.mark.parametrize("N", SIZES)
def test_compact_mirror_matches_plain_and_jax(N, cap_at):
    cap = _caps(N)[cap_at]
    v, lens = _votes(N, 0.3, seed=N + cap)
    count = _check_compact(v, lens, cap)
    assert 0 < count < N


@pytest.mark.parametrize("density", [0.0, 1.0])
@pytest.mark.parametrize("cap", [5, 1032])
def test_compact_mirror_no_and_all_survivors(cap, density):
    v, lens = _votes(1025, density, seed=cap)
    assert _check_compact(v, lens, cap) == (0 if density == 0 else 1025)


@pytest.mark.parametrize("cap_at", range(3))
@pytest.mark.parametrize("N", SIZES)
def test_survivor_rows_mirror_matches_plain_and_jax(N, cap_at):
    cap = _caps(N)[cap_at]
    bufs, exc = _lanes(N, seed=N + 1)
    lanes, off = [], 0
    for buf, W in zip(bufs, WIDTHS):
        lanes.append(tf.lane_codes(torch.from_numpy(buf), W, torch.from_numpy(exc), off))
        off += buf.shape[0]
    v, lens = _votes(N, 0.3, seed=N + cap)
    out = tf.compact(torch.from_numpy(v), torch.from_numpy(lens), cap)[0]
    c = min(cap, N)
    sidx = out[:c, 0]  # a strided column, as fused_scan_lanes passes it
    Wmax = max(WIDTHS)
    plain = tf.survivor_rows(lanes, sidx, Wmax).numpy()
    lanes_np = [t.numpy() for t in lanes]
    got = _kernel_survivor_rows(lanes_np, sidx.numpy(), Wmax)
    assert plain.shape == (c, Wmax) and np.array_equal(got, plain)
    assert np.array_equal(got, _jax_survivor_rows(lanes_np, sidx.numpy(), Wmax))


def test_survivor_rows_more_lanes_than_a_launch_takes():
    # more lanes than one launch's table (cuda.MAX_LANES): the plain version
    # and the mirror over every lane
    from genefuserust_tpu_torch.ops import cuda

    rng = np.random.default_rng(3)
    lanes = [rng.integers(0, 4, (int(rng.integers(1, 40)), int(rng.integers(16, 70))),
                          dtype=np.uint8) for _ in range(cuda.MAX_LANES + 3)]
    N = sum(a.shape[0] for a in lanes)
    sidx = rng.permutation(N)[: N // 2].astype(np.int32)
    plain = tf.survivor_rows([torch.from_numpy(a) for a in lanes], torch.from_numpy(sidx),
                             80).numpy()
    assert np.array_equal(plain, _kernel_survivor_rows(lanes, sidx, 80))
    assert np.array_equal(plain, _jax_survivor_rows(lanes, sidx, 80))


def test_wrappers_refuse_bad_shapes():
    buf = torch.zeros((4, 10), dtype=torch.uint8)
    exc = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tf.lane_codes(buf, 41, exc, 0)  # 10 packed bytes hold 40 bases
    with pytest.raises(ValueError):
        tf.lane_codes(buf, 40, exc.long(), 0)
    with pytest.raises(ValueError):
        tf.compact(torch.zeros((8, 4), dtype=torch.int32), torch.zeros(8, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        tf.survivor_rows([buf], torch.zeros(2, dtype=torch.int32), 8)  # lane wider than Wmax


# ---------------- the kernels on the card ----------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N", SIZES)
def test_glue_kernels_match_plain(N, cuda_device):
    from genefuserust_tpu_torch.ops import cuda

    bufs, exc = _lanes(N, seed=N)
    exc_d = torch.from_numpy(exc).to(cuda_device)
    lanes_c, lanes_d, off = [], [], 0
    for buf, W in zip(bufs, WIDTHS):
        b = torch.from_numpy(buf)
        lanes_c.append(tf.lane_codes(b, W, torch.from_numpy(exc), off))
        n0 = cuda.LAUNCHES["lane_unpack"]
        lanes_d.append(tf.lane_codes(b.to(cuda_device), W, exc_d, off))
        assert cuda.LAUNCHES["lane_unpack"] == n0 + 1
        assert torch.equal(lanes_d[-1].cpu(), lanes_c[-1])
        off += buf.shape[0]
    for cap in _caps(N):
        for density in (0.0, 0.3, 1.0):
            v, lens = _votes(N, density, seed=N + cap)
            exp = tf.compact(torch.from_numpy(v), torch.from_numpy(lens), cap)
            got = tf.compact(torch.from_numpy(v).to(cuda_device),
                             torch.from_numpy(lens).to(cuda_device), cap)
            for g, e in zip(got, exp):
                assert torch.equal(g.cpu(), e)
            c = min(cap, N)
            rows_c = tf.survivor_rows(lanes_c, exp[0][:c, 0], max(WIDTHS))
            rows_d = tf.survivor_rows(lanes_d, got[0][:c, 0], max(WIDTHS))
            assert torch.equal(rows_d.cpu(), rows_c)


@pytest.mark.cuda
def test_survivor_rows_kernel_more_lanes_than_a_launch_takes(cuda_device):
    # two launches, each copying the rows its lanes hold
    from genefuserust_tpu_torch.ops import cuda

    rng = np.random.default_rng(3)
    lanes = [torch.from_numpy(rng.integers(0, 4, (int(rng.integers(1, 40)),
                                                  int(rng.integers(16, 70))), dtype=np.uint8))
             for _ in range(cuda.MAX_LANES + 3)]
    N = sum(t.shape[0] for t in lanes)
    sidx = torch.from_numpy(rng.permutation(N)[: N // 2].astype(np.int32))
    n0 = cuda.LAUNCHES["survivor_rows"]
    got = tf.survivor_rows([t.to(cuda_device) for t in lanes], sidx.to(cuda_device), 80)
    assert cuda.LAUNCHES["survivor_rows"] == n0 + 2
    assert torch.equal(got.cpu(), tf.survivor_rows(lanes, sidx, 80))
