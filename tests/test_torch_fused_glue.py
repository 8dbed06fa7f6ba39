"""The glue kernels of `fused_scan_lanes` (csrc/fused_glue.cu): Python
mirrors of their steps, held to the plain versions (ops/fused.py) and to
the JAX pieces they replace (`unpack_seq2_jnp` with the exception
scatter, the argsort compaction and the okwords sum, the gather of the
padded lanes), bit for bit: the batched unpack (its 32-bit fast path at
widths that are multiples of 16, the general path at others, more lanes
than a launch takes) and its exception pass; the tiled compaction at
sizes around the tile, with caps inside and past the first tile and
every survivor past it. The `cuda`-marked tests hold each kernel to its
plain version on the card."""

import numpy as np
import pytest
import torch

from genefuserust_tpu_torch.ops import fused as tf

# mirrors of the launch constants of csrc/fused_glue.cu
MAX_LANES = 8
COMPACT_WARPS = 8
COMPACT_TILE = 256  # GLUE_COMPACT_TILE's default
ROWS_THREADS = 256
ROWS_MAX_BLOCKS = 132 * 16

# rows of the three lanes at each N: lane offsets that are not multiples of
# 32, so lane boundaries fall inside okwords' words
LANE_ROWS = {123: (70, 8, 45), 1023: (500, 8, 515), 1025: (513, 37, 475),
             65568: (40000, 5, 25563)}
WIDTHS = (192, 150, 161)
# the engine's lane widths for 150-base pairs: multiples of 16 (fast path)
MAIN_WIDTHS = (192, 256, 160)
SIZES = sorted(LANE_ROWS)


def _caps(N):
    return (5, 1024, N + 7)


def _lanes(N, seed, widths=WIDTHS, rows=None):
    """Three lanes of 2-bit rows (widths 192, 150, 161 by default; the
    packed rows one byte wider than needed for widths not a multiple of 4)
    and an exception list in the concatenated row space: random entries,
    and negative, past-the-width and out-of-lane columns at every lane's
    edges."""
    rng = np.random.default_rng(seed)
    bufs, exc, off = [], [], 0
    for P, W in zip(rows or LANE_ROWS[N], widths):
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


def _popc(x):
    return np.bitwise_count(np.asarray(x, np.uint32)).astype(np.int64)


def _kernel_lanes_unpack(bufs, widths, exc, off=0):
    """lanes_unpack_kernel then lane_exceptions_kernel, a launch of each
    for every MAX_LANES lanes. Unpack: the chunks of 16 output bytes of the
    group's lanes run on; chunk t goes to the last lane whose first chunk
    is <= t. Where W % 16 == 0 (and the packed row a multiple of 4 bytes) a
    chunk is one row's 4 packed bytes read as a little-endian uint32 and
    spread into 16 codes; else its bytes step through the rows. Then each
    entry tests every lane of the group: row in [off, off + P), column (a
    negative one + W) in [0, W) -> 255."""
    outs, rows = [], off
    for g in range(0, len(bufs), MAX_LANES):
        gb, gw = bufs[g : g + MAX_LANES], widths[g : g + MAX_LANES]
        offs = rows + np.cumsum([0] + [b.shape[0] for b in gb])[:-1]
        rows += sum(b.shape[0] for b in gb)
        chunk0 = np.cumsum([0] + [-(-b.shape[0] * W // 16) for b, W in zip(gb, gw)])
        flat = [np.full(b.shape[0] * W, 77, np.uint8) for b, W in zip(gb, gw)]
        t = np.arange(chunk0[-1])
        lane = np.searchsorted(chunk0[:-1], t, side="right") - 1
        for q, (b, W) in enumerate(zip(gb, gw)):
            P, Wb = b.shape
            j = 16 * (t[lane == q] - chunk0[q])
            src = b.reshape(-1)
            if W % 16 == 0 and Wb % 4 == 0:
                at = (j // W) * Wb + (j % W) // 4
                p = src[at[:, None] + np.arange(4)].astype(np.uint32) @ (
                    np.uint32(1) << np.arange(0, 32, 8, dtype=np.uint32))
                for k in range(16):
                    flat[q][j + k] = (p >> np.uint32(2 * k)) & 3
            else:
                for k in range(16):
                    jj = j + k
                    jj = jj[jj < P * W]
                    col = jj % W
                    flat[q][jj] = (src[(jj // W) * Wb + (col >> 2)] >> (2 * (col & 3))) & 3
        for e_row, e_col in exc.astype(np.int64):
            for q, (b, W) in enumerate(zip(gb, gw)):
                r, col = e_row - offs[q], (e_col + W if e_col < 0 else e_col)
                if 0 <= r < b.shape[0] and 0 <= col < W:
                    flat[q][r * W + col] = 255
        outs += [f.reshape(b.shape[0], W) for f, b, W in zip(flat, gb, gw)]
    return outs


def _kernel_compact(v, lens, cap, tile=COMPACT_TILE, lanes=None, Wmax=0):
    """compact_count_kernel then compact_place_kernel over tiles of `tile`
    rows, a block of COMPACT_WARPS warps a tile, each warp tile / 256
    words of 32 rows. Count: the ballots (the bitmap's words) and each
    tile's survivors. Place: pre(i) = the earlier tiles' counts + the
    tile's earlier warps' counts + the warp's earlier words + the bits
    below the lane; a survivor takes slot pre(i), any other row S + i -
    pre(i); rows with a slot below c = min(cap, N) are written. The outputs
    start as garbage (torch.empty): the zeros are written too. Given the
    code `lanes` (numpy), the placed rows' codes too (`_place_rows`), as a
    sixth output."""
    N = v.shape[0]
    c = min(cap, N)
    nw, nt = (N + 31) // 32, -(-N // tile)
    wpw = tile // (32 * COMPACT_WARPS)
    ok = v[:, 0] != 0
    # count launch
    okp = np.zeros(nt * tile, bool)
    okp[:N] = ok
    lane_bit = np.uint32(1) << np.arange(32, dtype=np.uint32)
    words = (okp.reshape(-1, 32) * lane_bit).sum(1, dtype=np.uint32)  # the ballots
    pop = _popc(words).reshape(nt, COMPACT_WARPS, wpw)
    tile_cnt = pop.sum((1, 2))
    # place launch
    S = int(tile_cnt.sum())
    before = np.cumsum(tile_cnt) - tile_cnt
    warp_cnt = pop.sum(2)
    warp_pre = np.cumsum(warp_cnt, 1) - warp_cnt
    word_pre = np.cumsum(pop, 2) - pop
    base = before[:, None, None] + warp_pre[:, :, None] + word_pre  # (nt, warps, wpw)
    i = np.arange(nt * tile).reshape(nt, COMPACT_WARPS, wpw, 32)
    bit = okp.reshape(nt, COMPACT_WARPS, wpw, 32)
    pre = base[..., None] + np.cumsum(bit, 3) - bit  # + popc(m & below)
    slot = np.where(bit, pre, S + i - pre)
    sel = (i < N) & (slot < c)
    rows, slots = i[sel], slot[sel]
    out = np.full((cap + 1, 13), -7, np.int32)
    r, col = np.divmod(np.arange((cap + 1) * 13), 13)
    zero = ~(((r < c) & (col < 2)) | ((r == cap) & (col == 0)))
    out.reshape(-1)[zero] = 0
    out[cap, 0] = S
    out[slots, 0] = rows
    out[slots, 1] = ok[rows]
    slens = np.full(c, -7, np.int32)
    slens[slots] = np.where(ok[rows], lens[rows], 0)
    gp = np.full((c, 4), -7, np.int32)
    gp[slots] = v[rows, 1:5]
    res = (out, slens, gp, words[:nw].view(np.int32), tile_cnt.astype(np.int32))
    if lanes is None:
        return res
    return (*res, _place_rows(lanes, rows, slots, c, Wmax, res[3], res[4], tile))


def _spread_rows(okw, tile_cnt, c, N, tile):
    """The place launch's slot -> row, as a block finds it: block b of
    the ntiles takes slots [b * per, (b + 1) * per), per = ceil(c /
    ntiles); the tile counts' exclusive sums cs give tile t the survivor
    slots [cs, cs + n) and the other slots [cn, cn + rows - n), cn = S +
    t * tile - cs; a slot's rank there is found among the tile's words
    (their complement for another row, bits past N masked) -> the row of
    each slot [0, c)."""
    nt = len(tile_cnt)
    per = -(-c // max(nt, 1))
    blocks = [(b * per, min(c, (b + 1) * per)) for b in range(max(nt, 1)) if b * per < c]
    assert sum(hi - lo for lo, hi in blocks) == c  # each slot in one block
    n = tile_cnt.astype(np.int64)
    S = int(n.sum())
    cs = np.cumsum(n) - n
    t_all = np.arange(nt)
    nrows = np.minimum(tile, N - t_all * tile)
    cn = S + t_all * tile - cs
    s = np.arange(c)
    surv = s < S
    t = np.where(surv, np.searchsorted(cs + n, s, side="right"),
                 np.searchsorted(cn + nrows - n, s, side="right"))
    rank = np.where(surv, s - cs[t], s - cn[t])
    wpt = tile // 32
    words = np.zeros(nt * wpt, np.uint32)
    words[: len(okw)] = okw.view(np.uint32)
    m = words.reshape(nt, wpt)[t]
    m = np.where(surv[:, None], m, ~m)
    wi = t[:, None] * wpt + np.arange(wpt)[None, :]
    keep = np.clip(N - 32 * wi, 0, 32)  # rows of the word below N
    low = ((np.uint64(1) << keep.astype(np.uint64)) - 1).astype(np.uint32)
    m = np.where(keep >= 32, m, m & low)
    inc = np.cumsum(_popc(m), 1)
    w = np.argmax(inc > rank[:, None], 1)
    before = np.take_along_axis(inc, w[:, None], 1)[:, 0] - _popc(m[s, w])
    bits = (m[s, w][:, None] >> np.arange(32, dtype=np.uint32)) & 1
    bit = np.argmax(np.cumsum(bits, 1) > (rank - before)[:, None], 1)
    return 32 * (t * wpt + w) + bit


def _place_rows(lanes, rows, slots, c, Wmax, okw, tile_cnt, tile):
    """The code rows of compact_place_kernel's placed rows (row rows[k] to
    slot slots[k]), then survivor_rows_kernel's for the lanes past the
    first MAX_LANES. The place launch copies a row that one of its first
    MAX_LANES lanes holds: 16-byte chunks of the row, 255 past its lane's
    width, the last one cut at Wmax. The slots spread over the blocks,
    each slot's row found from the tile counts and the bitmap
    (`_spread_rows`, which must give the placed row); a half-warp a slot,
    lane t its chunks t, t + 16, ... Every byte of a copied row is
    written exactly once; the rows of later lanes are left to the
    survivor_rows launches, one for each further MAX_LANES lanes -> (c,
    Wmax) uint8."""
    out = np.full((c, Wmax), 77, np.uint8)
    writes = np.zeros((c, Wmax), np.int64)
    offs = np.cumsum([0] + [t.shape[0] for t in lanes])
    cw = -(-Wmax // 16)
    src = np.full((offs[-1], 16 * cw), 255, np.uint8)  # each row padded with 255
    for q, t in enumerate(lanes):
        src[offs[q] : offs[q + 1], : t.shape[1]] = t
    held = offs[min(len(lanes), MAX_LANES)]
    found = _spread_rows(okw, tile_cnt, c, offs[-1], tile)
    placed = np.full(c, -1, np.int64)
    placed[slots] = rows
    assert np.array_equal(found, placed)
    r_slots = np.arange(c)[found < held]
    r_rows = found[found < held]
    for jc in range(cw):
        # lane jc % 16 of the slot's half-warp copies chunk jc
        j = 16 * jc
        n = min(16, Wmax - j)
        out[r_slots, j : j + n] = src[r_rows, j : j + n]
        writes[r_slots, j : j + n] += 1
    assert (writes[r_slots] == 1).all() and not writes[np.setdiff1d(np.arange(c), r_slots)].any()
    sidx = np.full(c, -1, np.int64)
    sidx[slots] = rows
    for g in range(MAX_LANES, len(lanes) if c else 0, MAX_LANES):
        # survivor_rows_kernel over the group's lanes: thread t of the grid
        # stride loop takes chunk (r, j) = divmod(t, cw), row sidx[r] if the
        # group holds it
        lo, hi = offs[g], offs[min(len(lanes), g + MAX_LANES)]
        total = c * cw
        threads = min(ROWS_MAX_BLOCKS, -(-total // ROWS_THREADS)) * ROWS_THREADS
        for t0 in range(0, total, threads):
            t = np.arange(t0, min(total, t0 + threads))
            r, j = t // cw, 16 * (t % cw)
            mine = (sidx[r] >= lo) & (sidx[r] < hi)
            for k in range(16):
                jj = j[mine] + k
                inside = jj < Wmax
                out[r[mine][inside], jj[inside]] = src[sidx[r[mine][inside]], jj[inside]]
    return out


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


def _check_lanes_unpack(bufs, widths, exc, off=0):
    got = _kernel_lanes_unpack(bufs, widths, exc, off)
    plain = [t.numpy() for t in tf.lanes_codes([torch.from_numpy(b) for b in bufs], widths,
                                               torch.from_numpy(exc), off)]
    assert len(got) == len(plain) == len(bufs)
    for buf, W, g, p in zip(bufs, widths, got, plain):
        assert g.shape == p.shape == (buf.shape[0], W) and np.array_equal(g, p)
        if buf.shape[0]:  # JAX's unpack_seq2_jnp cannot reshape an empty lane
            assert np.array_equal(g, _jax_lane_codes(buf, W, exc, off))
        # the one-lane wrapper is the same call
        one = tf.lane_codes(torch.from_numpy(buf), W, torch.from_numpy(exc), off).numpy()
        assert np.array_equal(g, one)
        off += buf.shape[0]
    return got


@pytest.mark.parametrize("N", SIZES)
def test_lane_unpack_mirror_matches_plain_and_jax(N):
    bufs, exc = _lanes(N, seed=N)
    for got in _check_lanes_unpack(bufs, WIDTHS, exc):
        assert (got == 255).any() and (got[:, -1] == 255).any() and (got[:, 0] == 255).any()


@pytest.mark.parametrize("N", SIZES)
def test_lanes_unpack_mirror_engine_widths(N):
    # widths that are multiples of 16: every chunk on the 32-bit fast path
    bufs, exc = _lanes(N, seed=N + 2, widths=MAIN_WIDTHS)
    assert all(W % 16 == 0 and b.shape[1] % 4 == 0 for b, W in zip(bufs, MAIN_WIDTHS))
    for got in _check_lanes_unpack(bufs, MAIN_WIDTHS, exc, off=3):
        assert (got == 255).any() and (got[:, -1] == 255).any()


def _many_lanes(seed):
    """11 lanes (two launches of each unpack kernel): widths on the fast
    and the general path, an empty lane in each group, and 600 entries
    over every lane and past them."""
    rng = np.random.default_rng(seed)
    spec = [(16, 20), (150, 7), (16, 0), (256, 25), (33, 3), (160, 29), (48, 1), (7, 12),
            (192, 9), (64, 0), (161, 17)]
    bufs = [rng.integers(0, 256, (P, -(-W // 4)), dtype=np.uint8) for W, P in spec]
    N = sum(P for _, P in spec)
    exc = np.stack([rng.integers(-2, N + 2, 600), rng.integers(-300, 300, 600)], 1)
    return bufs, [W for W, _ in spec], exc.astype(np.int32)


def test_lanes_unpack_more_lanes_than_a_launch_takes():
    bufs, widths, exc = _many_lanes(11)
    assert len(bufs) > MAX_LANES
    _check_lanes_unpack(bufs, widths, exc)


def test_lanes_unpack_pad_only_exceptions():
    # the engine pads the list with entries at row N, past every lane
    bufs, _ = _lanes(123, seed=5, widths=MAIN_WIDTHS)
    N = sum(b.shape[0] for b in bufs)
    exc = np.array([(N, 256)] * 32, np.int32)
    got = _check_lanes_unpack(bufs, MAIN_WIDTHS, exc)
    assert not any((g == 255).any() for g in got)


def _check_compact(v, lens, cap):
    N = v.shape[0]
    c = min(cap, N)
    out, slens, gp, okw, tile_cnt = _kernel_compact(v, lens, cap)
    p_out, p_slens, p_gp, p_okw = (t.numpy() for t in tf.compact(
        torch.from_numpy(v), torch.from_numpy(lens), cap))
    for a, b in ((out, p_out), (slens, p_slens), (gp, p_gp), (okw, p_okw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    p_okw2, p_cnt = (t.numpy() for t in tf.compact_count_plain(torch.from_numpy(v),
                                                               COMPACT_TILE))
    assert np.array_equal(okw, p_okw2) and np.array_equal(tile_cnt, p_cnt)
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
@pytest.mark.parametrize("N", [COMPACT_TILE - 1, COMPACT_TILE, COMPACT_TILE + 1,
                               3 * COMPACT_TILE + 5])
def test_compact_mirror_at_tile_edges(N, cap_at):
    cap = _caps(N)[cap_at]
    v, lens = _votes(N, 0.3, seed=N + cap_at)
    count = _check_compact(v, lens, cap)
    assert 0 < count < N


@pytest.mark.parametrize("cap", [1024, 12 * COMPACT_TILE + 12])
def test_compact_mirror_survivors_past_the_first_tile(cap):
    # no survivor in the first tile, more survivors than cap 1024; at a cap
    # past N the first tile's rows are the non-survivors placed first
    N = 12 * COMPACT_TILE + 5
    v, lens = _votes(N, 0.5, seed=9)
    v[:COMPACT_TILE, 0] = 0
    count = _check_compact(v, lens, cap)
    assert count > 1024
    out = _kernel_compact(v, lens, cap)[0]
    if cap > N:
        assert np.array_equal(out[count : count + COMPACT_TILE, 0], np.arange(COMPACT_TILE))


def _code_lanes(N, widths, seed):
    """Code lanes of N rows in all at `widths`, a lane a width -> numpy.
    Three widths: lanes_codes of `_lanes`' 2-bit rows with their
    exceptions set, LANE_ROWS' rows or (N // 2, 3, the rest); more: N cut
    at random into that many lanes, one of them empty."""
    if len(widths) == 3:
        rows = LANE_ROWS.get(N, (N // 2, 3, N - N // 2 - 3))
        bufs, exc = _lanes(N, seed, widths=widths, rows=rows)
        codes = tf.lanes_codes([torch.from_numpy(b) for b in bufs], list(widths),
                               torch.from_numpy(exc))
        return [t.numpy() for t in codes]
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, N + 1, len(widths) - 1))
    cuts[len(cuts) // 2] = cuts[len(cuts) // 2 - 1]  # an empty lane
    rows = np.diff(np.concatenate([[0], cuts, [N]]))
    return [rng.choice(np.array([0, 1, 2, 3, 255], np.uint8), (P, W)) for P, W in zip(rows, widths)]


def _check_compact_rows(v, lens, cap, lanes):
    """compact with the code lanes: the mirror against
    compact's plain version, survivor_rows_plain and JAX's take of the
    padded lanes, every placed row (non-survivors too)."""
    N = v.shape[0]
    c = min(cap, N)
    Wmax = max(t.shape[1] for t in lanes)
    got = _kernel_compact(v, lens, cap, lanes=lanes, Wmax=Wmax)
    plain = [t.numpy() for t in tf.compact(torch.from_numpy(v), torch.from_numpy(lens), cap,
                                           [torch.from_numpy(t) for t in lanes], Wmax)]
    assert len(plain) == 5
    for a, b in zip(got[:4] + got[5:], plain):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    sidx = plain[0][:c, 0]
    assert plain[4].shape == (c, Wmax)
    assert np.array_equal(plain[4], tf.survivor_rows_plain(
        [torch.from_numpy(t) for t in lanes], torch.from_numpy(sidx), Wmax).numpy())
    assert np.array_equal(plain[4], _jax_survivor_rows(lanes, sidx, Wmax))
    return plain


@pytest.mark.parametrize("cap_at", range(4))
@pytest.mark.parametrize("N", [123, 1023, 1025, COMPACT_TILE - 1, COMPACT_TILE + 1, 65568])
def test_compact_rows_mirror_matches_plain_and_jax(N, cap_at):
    """The place launch's row copy at the fused glue's sizes and the
    tile's edges, caps 0 (no row placed), below, at and past the
    survivors; lanes of widths 192, 150 and 161 (the latter two not
    multiples of 16: misaligned rows and a cut last chunk)."""
    cap = (0, *_caps(N))[cap_at]
    widths = WIDTHS if N in LANE_ROWS else (150, 100, 161)
    lanes = _code_lanes(N, widths, seed=N + cap_at)
    v, lens = _votes(N, 0.3, seed=N + cap)
    out = _check_compact_rows(v, lens, cap, lanes)[0]
    assert 0 < out[cap, 0] < N


@pytest.mark.parametrize("nlanes", [11, 12])
def test_compact_rows_past_the_place_launchs_lanes(nlanes):
    """More lanes than the place launch's table: the rows of lanes 8 on
    come from survivor_rows launches; widths on and off multiples of 16,
    an empty lane, every row placed (cap past N) and cap 100."""
    widths = [192, 150, 256, 100, 160, 16, 33, 161, 64, 150, 7, 48][:nlanes]
    lanes = _code_lanes(900, widths, seed=nlanes)
    assert any(t.shape[0] == 0 for t in lanes)
    for cap in (100, 907):
        v, lens = _votes(900, 0.3, seed=cap + nlanes)
        rows = _check_compact_rows(v, lens, cap, lanes)[4]
        offs = np.cumsum([0] + [t.shape[0] for t in lanes])
        assert (rows == 255).any() and offs[8] < 900


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


def _launches(cuda, before=None):
    """The launch counts now, or (given the counts before) the kernels
    launched since, with their numbers."""
    now = dict(cuda.LAUNCHES)
    if before is None:
        return now
    return {k: n - before[k] for k, n in now.items() if n != before[k]}


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
        n0 = _launches(cuda)
        lanes_d.append(tf.lane_codes(b.to(cuda_device), W, exc_d, off))
        assert _launches(cuda, n0) == {"lane_unpack": 1, "lane_exceptions": 1}
        assert torch.equal(lanes_d[-1].cpu(), lanes_c[-1])
        off += buf.shape[0]
    # the batch at once: one launch of each
    n0 = _launches(cuda)
    batch = tf.lanes_codes([torch.from_numpy(b).to(cuda_device) for b in bufs], WIDTHS, exc_d)
    assert _launches(cuda, n0) == {"lane_unpack": 1, "lane_exceptions": 1}
    assert all(torch.equal(g.cpu(), e) for g, e in zip(batch, lanes_c))
    assert all(t.data_ptr() % 16 == 0 and t.is_contiguous() for t in batch)
    for cap in _caps(N):
        for density in (0.0, 0.3, 1.0):
            v, lens = _votes(N, density, seed=N + cap)
            exp = tf.compact(torch.from_numpy(v), torch.from_numpy(lens), cap)
            n0 = _launches(cuda)
            got = tf.compact(torch.from_numpy(v).to(cuda_device),
                             torch.from_numpy(lens).to(cuda_device), cap)
            assert _launches(cuda, n0) == {"compact_count": 1, "compact_place": 1}
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


@pytest.mark.cuda
def test_lanes_unpack_kernels_widths_lanes_and_pads(cuda_device):
    # the fast path at the engine's widths, 11 lanes (two launches of
    # each kernel), and a list of pad entries only
    from genefuserust_tpu_torch.ops import cuda

    bufs, exc = _lanes(1025, seed=4, widths=MAIN_WIDTHS)
    N = sum(b.shape[0] for b in bufs)
    many = _many_lanes(12)
    for bufs, widths, exc, launches in (
            (bufs, MAIN_WIDTHS, exc, 1), (*many, 2),
            (bufs, MAIN_WIDTHS, np.array([(N, 256)] * 32, np.int32), 1)):
        exp = tf.lanes_codes([torch.from_numpy(b) for b in bufs], widths, torch.from_numpy(exc))
        n0 = _launches(cuda)
        got = tf.lanes_codes([torch.from_numpy(b).to(cuda_device) for b in bufs], widths,
                             torch.from_numpy(exc).to(cuda_device))
        assert _launches(cuda, n0) == {"lane_unpack": launches, "lane_exceptions": launches}
        assert all(torch.equal(g.cpu(), e) for g, e in zip(got, exp))


@pytest.mark.cuda
def test_compact_kernels_at_tile_edges(cuda_device):
    # N around the library's own tile, caps inside the first tile and past
    # N, and every survivor past the first tile
    from genefuserust_tpu_torch.ops import cuda

    T = cuda.compact_tile()
    for N in (T - 1, T, T + 1, 3 * T + 5):
        for cap in (5, 1024, N + 7):
            for first_tile_empty in (False, True):
                v, lens = _votes(N, 0.5, seed=N + cap)
                if first_tile_empty:
                    v[:T, 0] = 0
                exp = tf.compact(torch.from_numpy(v), torch.from_numpy(lens), cap)
                got = tf.compact(torch.from_numpy(v).to(cuda_device),
                                 torch.from_numpy(lens).to(cuda_device), cap)
                for g, e in zip(got, exp):
                    assert torch.equal(g.cpu(), e)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [123, 1025, 65568])
def test_compact_rows_kernels_match_plain(N, cuda_device):
    """The place launch with the code lanes, bit-equal to plain at caps 0
    (no row placed: an empty rows tensor), below, at and past the
    survivors; 3 lanes of widths on and off multiples of 16 (count +
    place, no survivor_rows launch) and 12 lanes (one survivor_rows launch
    more where a row is placed)."""
    from genefuserust_tpu_torch.ops import cuda

    widths_12 = [192, 150, 256, 100, 160, 16, 33, 161, 64, 150, 7, 48]
    for widths in (MAIN_WIDTHS, (150, 100, 161), widths_12):
        lanes = [torch.from_numpy(t) for t in _code_lanes(N, widths, seed=N)]
        lanes_d = [t.to(cuda_device) for t in lanes]
        Wmax = max(widths)
        for cap in (0, *_caps(N)):
            v, lens = _votes(N, 0.3, seed=N + cap)
            exp = tf.compact(torch.from_numpy(v), torch.from_numpy(lens), cap, lanes, Wmax)
            vd, ld = torch.from_numpy(v).to(cuda_device), torch.from_numpy(lens).to(cuda_device)
            n0 = _launches(cuda)
            got = tf.compact(vd, ld, cap, lanes_d, Wmax)
            more = -(-len(lanes) // MAX_LANES) - 1 if cap else 0
            assert _launches(cuda, n0) == {"compact_count": 1, "compact_place": 1,
                                           **({"survivor_rows": more} if more else {})}
            for g, e in zip(got, exp):
                assert torch.equal(g.cpu(), e)

