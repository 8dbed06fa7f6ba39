"""The port's map_read (plain versions of kernels 1-3 and the two passes)
against the JAX package's `ops/map_read.py`, bit for bit."""

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.core.sequence import encode_bases, reverse_complement
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.ops.hashtable import (
    pack_index,
    pack_index_kv,
    pack_index_kv16,
    pack_index_kvs,
)
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.hashtable import DUPE, EMPTY, HIGH
from genefuserust_tpu_torch.ops.index import index_to_torch

LAYOUTS = {
    "split": None,
    "kv2": dict(target_load=0.5, slots=1),
    "kv4": dict(target_load=0.6, slots=2),
    "kv8": dict(),
    "kvs": None,  # the single-probe layouts, at their packers' defaults
    "kv16": None,
}
MOTIF = "ACGTTGCAACGGTTACGATCCAGTTACG"


# ---------------- units ----------------


def test_compute_kmers_with_invalid_codes():
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import compute_kmers

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (64, 70), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.05] = 255
    codes[0, :] = 255
    codes[1, :] = 3  # all-T rows give k-mers >= 2^31
    lengths = rng.integers(0, 71, 64).astype(np.int32)
    lengths[:2] = 70
    km_j, ok_j = compute_kmers(jnp.asarray(codes), jnp.asarray(lengths))
    km, ok = tm.compute_kmers(torch.from_numpy(codes), torch.from_numpy(lengths))
    assert (km.numpy() == np.asarray(km_j).astype(np.int64)).all()
    assert (ok.numpy() == np.asarray(ok_j)).all()
    assert km.max() >= 2**31 and (~ok).any() and ok.any()


def _top2_cases():
    """(hi, lo, valid) candidate rows: count ties, key 0, unsigned lo
    order, a single key, no key, only key 0, and random rows."""
    rows = [
        [(1, 100)] * 3 + [(1, 50)] * 3 + [(2, 5)],  # tie -> smaller key first
        [(0, 0)] * 5 + [(0, 1)] * 2 + [(3, -5)] * 2 + [(3, 5)] * 2,  # key 0 skipped
        [(7, -1)] * 4,  # one voted key only
        [],  # nothing valid
        [(0, 0)] * 6,  # key 0 only
        [(2, -1), (1, -1), (1, 0), (0, -2)] * 2 + [(1, -1)],  # lo 0xFFFFFFFF order
    ]
    P = 16
    rng = np.random.default_rng(1)
    for _ in range(40):
        n = int(rng.integers(0, P + 1))
        rows.append([(int(rng.integers(0, 3)), int(rng.integers(-2, 3))) for _ in range(n)])
    hi = np.zeros((len(rows), P), np.int32)
    lo = np.zeros((len(rows), P), np.int32)
    valid = np.zeros((len(rows), P), bool)
    for r, row in enumerate(rows):
        perm = rng.permutation(P)[: len(row)]
        for (h, l), p in zip(row, perm):
            hi[r, p], lo[r, p], valid[r, p] = h, l, True
    hi[~valid] = rng.integers(-5, 5, (~valid).sum())  # junk under invalid
    return hi, lo, valid


def test_top2_votes_ties_and_key_zero():
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import top2_votes

    hi, lo, valid = _top2_cases()
    exp = [np.asarray(x) for x in top2_votes(jnp.asarray(hi), jnp.asarray(lo),
                                              jnp.asarray(valid))]
    keys = tm.gplong(torch.from_numpy(hi), torch.from_numpy(lo))
    g1, c1, g2, c2 = tm.top2_votes(keys, torch.from_numpy(valid))
    h1, l1 = tm._hi_lo(g1)
    h2, l2 = tm._hi_lo(g2)
    # exact everywhere, including the (count 0) fill-in keys
    for got, want in zip((h1, l1, c1, h2, l2, c2), exp):
        assert (got.numpy() == want).all()
    assert exp[2][0] == 3 and (exp[0][0], exp[1][0]) == (1, 50)
    assert (exp[0][1], exp[1][1], exp[3][1], exp[4][1]) == (0, 1, 3, 5)


def test_gplong_pm1_matches_jax_across_contig_boundary():
    """JAX forms pos - i in wrapping int32 with no borrow into the contig;
    the port's packed key must order and compare (+-1) exactly the same,
    including lo crossing 0 / 0xFFFFFFFF at a contig boundary."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import _eq_pm1

    edge = np.array([0, 1, 2, -1, -2, 2**31 - 1, -(2**31), 5], np.int32)
    hi, lo = np.meshgrid(np.array([0, 1, 2], np.int32), edge, indexing="ij")
    hi, lo = hi.ravel(), lo.ravel()
    gh, gl = hi[:, None], lo[:, None]
    exp = np.asarray(_eq_pm1(jnp.asarray(hi[None, :]), jnp.asarray(lo[None, :]),
                             jnp.asarray(gh), jnp.asarray(gl)))
    k = tm.gplong(torch.from_numpy(hi), torch.from_numpy(lo))
    got = ((k[None, :] - k[:, None]).abs() <= 1).numpy()
    assert (got == exp).all()
    # (1, 0xFFFFFFFF) and (2, 0) are neighbours; (1, 0) - 1 is (0, 0xFFFFFFFF)
    assert exp.sum() > len(hi)
    # pos - i below 0 keeps the contig: pos 1 sampled at i = 4 is (c, -3)
    pos = torch.tensor([[1]], dtype=torch.int32)
    assert tm.gplong(torch.tensor([[2]]), pos.to(torch.int64) - 4).item() == (2 << 32) | 0xFFFFFFFD


# ---------------- a mirror of the mask+segments kernel ----------------
#
# csrc/mask_segments.cu step for step: one warp a read, 32-bit words of
# per-base bits (bit j of word w is base 32w + j), ballots of the k-mer
# flags a chunk of 32 at a time, the 16-wide window as four shift-ORs of
# (this word, previous word), the chain rules as ALLOWED_GAP shift steps on
# two words, chain heads carried by a warp max-scan, and the longest chain
# by a warp max over keys packed as (length + 1, 0xFFFF - end).

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


def _ballots(bits, nw):
    """(n,) bool -> nw 32-bit words, one ballot per chunk of 32 lanes."""
    padded = np.zeros(nw * 32, bool)
    padded[: len(bits)] = bits
    w = padded.reshape(nw, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)
    return [int(x) for x in w.sum(1)]


def _window16(f, pf):
    """Mask word of one flag bitmap: base t is set when one of the 16
    k-mers t-15..t is, from k-mer words (this, previous)."""
    v = (f << 32) | pf
    for s in (1, 2, 4, 8):
        v |= v << s
    return (v >> 32) & M32


def _below(w, lim):
    """Word w's bits of the bases t < lim."""
    lo = 32 * w
    return M32 if lim >= lo + 32 else (1 << (lim - lo)) - 1 if lim > lo else 0


def _linked(ok, pok, blk, pblk):
    """This word's ok bases with an ok base at most ALLOWED_GAP before and
    no blocked base between, from (this, previous) words."""
    o, b, z = (ok << 32) | pok, (blk << 32) | pblk, 0
    for _ in range(10):
        z = ((o | (z & ~b)) << 1) & M64
    return ok & (z >> 32)


def _next_linked(lk, nlk, ok, nok):
    """This word's bases whose next ok base is a linked one, from (this,
    next) words of the linked and ok bits."""
    lv, ov, n = (nlk << 32) | lk, (nok << 32) | ok, 0
    for _ in range(10):
        n = (lv | (n & ~ov)) >> 1
    return n & M32


def _heads_ends(m3, m2, length, L, target):
    """Per word of the row's mask words (m3: mask 3, m2: mask >= 2): the
    chain heads and chain ends of `target` (linked bases from (this,
    previous) words, ends from (this, next))."""
    nw = len(m3)
    lim = min(length, L)

    def ok_blk(w):
        if w < 0 or w >= nw:
            return 0, 0
        inb = _below(w, lim)
        if target == 3:
            return m3[w] & inb, 0
        return m2[w] & ~m3[w] & inb, m3[w] & inb

    lk = [_linked(ok_blk(w)[0], ok_blk(w - 1)[0], ok_blk(w)[1], ok_blk(w - 1)[1])
          for w in range(nw)] + [0]
    heads, ends = [], []
    for w in range(nw):
        ok, nok = ok_blk(w)[0], ok_blk(w + 1)[0]
        h = ok & ~lk[w] & _below(w, length - 1)
        heads.append(h)
        ends.append((lk[w] | h) & ~_next_linked(lk[w], lk[w + 1], ok, nok))
    return heads, ends


def _word_chains(w, h, e, before, sh, maxe):
    """The best chain key over word w's ends e: an end's head is the last
    head of h at or before it, else `before`."""
    best = 0
    while e:
        b = (e & -e).bit_length() - 1
        e &= e - 1
        hb = h & (M32 >> (31 - b))
        head = 32 * w + hb.bit_length() - 1 if hb else before
        n = 32 * w + b - head
        best = max(best, ((n + 1) << sh) | (maxe - (32 * w + b)))
    return best


def _segment(best, sh, maxe):
    if best == 0:
        return 0, -1, 0
    n, end = (best >> sh) - 1, maxe - (best & maxe)
    return int(n > 20), end - n, end


def _last_head(w, h):
    return 32 * w + h.bit_length() - 1 if h else -1


def _kernel_segments(m3, m2, length, L, target, wide=False):
    """One read's (valid, start, end) for `target` from its mask words
    (m3: mask 3, m2: mask >= 2), as the kernel's segment step runs in one
    warp: a word a lane, the heads carried over chunks of 32 words by a
    warp max-scan; `wide` packs the chain keys as the wide path does,
    (length + 1) << 32 | (0xFFFFFFFF - end), for rows past 65,535 bases."""
    sh, maxe = (32, M32) if wide else (16, 0xFFFF)
    nw = len(m3)
    heads, ends = _heads_ends(m3, m2, length, L, target)
    best, carry = 0, -1
    for w0 in range(0, nw, 32):
        last = [_last_head(w, heads[w]) if w < nw else -1 for w in range(w0, w0 + 32)]
        scan = last[:]
        for o in (1, 2, 4, 8, 16):
            scan = [max(scan[i], scan[i - o]) if i >= o else scan[i] for i in range(32)]
        for lane in range(32):
            w = w0 + lane
            if w < nw:
                before = max(carry, scan[lane - 1] if lane else -1)
                best = max(best, _word_chains(w, heads[w], ends[w], before, sh, maxe))
        carry = max(carry, scan[31])
    return _segment(best, sh, maxe)


def _block_segments(m3, m2, length, L, target, threads=32 * tm.MASK_WIDE_WARPS):
    """block_segments of the wide launch: a long row's segments for
    `target` by a block of `threads`, a word a thread in rounds of
    `threads` words; a word's `before` head is a block exclusive max-scan
    over the round's earlier threads and the carry of earlier rounds."""
    sh, maxe = 32, M32
    nw = len(m3)
    heads, ends = _heads_ends(m3, m2, length, L, target)
    best, carry = 0, -1
    for w0 in range(0, nw, threads):
        last = [_last_head(w, heads[w]) for w in range(w0, min(nw, w0 + threads))]
        excl = np.maximum.accumulate([-1] + last)[:-1]
        for t, w in enumerate(range(w0, min(nw, w0 + threads))):
            best = max(best, _word_chains(w, heads[w], ends[w], max(carry, int(excl[t])), sh,
                                          maxe))
        carry = max([carry] + last)
    return _segment(best, sh, maxe)


def _mask_route(length, L, smem_cap=None):
    """Where the wide launch keeps a row's words: "warp" (its warp's slice),
    "block" (the block's shared memory) or "global" (the block's scratch),
    as csrc/mask_segments.cu's wide_launch and block_words decide."""
    nwr = -(-min(length, L) // 32)
    if nwr <= tm.MASK_WARP_WORDS:
        return "warp"
    cap = tm.WIDE_SMEM_BYTES if smem_cap is None else smem_cap
    row = 16 * -(-L // 32)
    smem = max(tm.MASK_SLICE_BYTES, row) if row <= cap else tm.MASK_SLICE_BYTES
    return "block" if 16 * nwr <= smem else "global"


def _row_words(m3, m2, length, L, mismatch_thr, wide, route="warp"):
    """(v3, v2, s3, s2, e3, e2) of a row from its mask words, by a warp
    (route "warp") or by the block step (any other route)."""
    lim = min(length, L)
    miss = sum(bin(~m2[c] & _below(c, lim)).count("1") for c in range(len(m3)))
    ok = int(miss <= mismatch_thr)
    seg = _kernel_segments if route == "warp" else _block_segments
    kw = dict(wide=wide) if route == "warp" else {}
    (v3, s3, e3), (v2, s2, e2) = (seg(m3, m2, length, L, t, **kw) for t in (3, 2))
    return [v3 & ok, v2 & ok, s3, s2, e3, e2]


def _kmer_flags(pr, gp, index):
    """(B, NK) flags 3 and >= 2 of probe results: a candidate within +-1
    of the top key, of either key, over the k-mer's candidates."""
    keys, cv = tm._keys_at(index, pr, 1)
    g1 = tm.gplong(gp[:, 0], gp[:, 1])[:, None, None]
    g2 = tm.gplong(gp[:, 2], gp[:, 3])[:, None, None]
    f3 = (cv & ((keys - g1).abs() <= 1)).any(-1).numpy()
    f2 = f3 | (cv & ((keys - g2).abs() <= 1)).any(-1).numpy()
    return f3, f2


def _kernel_mask_rows(pr, lengths, gp, index, mismatch_thr=10):
    """The wide launch on (B, NK, 2) probe results -> (B, 10) int32 rows. A
    row's work stops at its own last word, ceil(min(len, L) / 32): its
    chunks of 32 k-mers are balloted (on the block step each warp takes a
    range, and the raw ballots are then windowed a word a thread: the same
    words), and a row past tm.MASK_WARP_WORDS words runs the block step
    (_mask_route; shared memory or global scratch hold the same words)."""
    B, NK = pr.shape[:2]
    L = NK + 15
    out = np.zeros((B, 10), np.int32)
    for b in range(B):
        n = int(lengths[b])
        nwr = -(-min(n, L) // 32)
        f3, f2 = _kmer_flags(pr[b : b + 1, : min(NK, 32 * nwr)], gp[b : b + 1], index)
        F3, F2 = _ballots(f3[0], nwr), _ballots(f2[0], nwr)
        m3 = [_window16(F3[c], F3[c - 1] if c else 0) for c in range(nwr)]
        m2 = [_window16(F2[c], F2[c - 1] if c else 0) for c in range(nwr)]
        out[b] = _row_words(m3, m2, n, L, mismatch_thr, True, _mask_route(n, L)) + \
            gp[b, [0, 2, 1, 3]].tolist()
    return out


def _kernel_mask_segments(pr, lengths, gp, index, mismatch_thr=10, wide=False):
    """The kernel on (B, NK, 2) probe results -> (B, 10) int32 rows. A
    k-mer's flag (3 on a candidate within +-1 of the top key, else 2 within
    +-1 of the second) is its candidates' max, as the kernel forms it from
    the probe row and the dupe row it names; the rest runs on words.
    `wide`: the wide launch (_kernel_mask_rows: each row's own extent, the
    block step for long rows, the wide path's chain keys)."""
    if wide:
        return _kernel_mask_rows(pr, lengths, gp, index, mismatch_thr)
    B, NK = pr.shape[:2]
    L = NK + 15
    nw = -(-L // 32)
    f3, f2 = _kmer_flags(pr, gp, index)
    out = np.zeros((B, 10), np.int32)
    for b in range(B):
        n = int(lengths[b])
        F3, F2 = _ballots(f3[b], nw), _ballots(f2[b], nw)
        m3 = [_window16(F3[c], F3[c - 1] if c else 0) for c in range(nw)]
        m2 = [_window16(F2[c], F2[c - 1] if c else 0) for c in range(nw)]
        out[b] = _row_words(m3, m2, n, L, mismatch_thr, False) + gp[b, [0, 2, 1, 3]].tolist()
    return out


def _mask_bits(mask):
    """(L,) mask values 0/2/3 -> the kernel's (m3, m2) words."""
    nw = -(-len(mask) // 32)
    return _ballots(mask == 3, nw), _ballots(mask >= 2, nw)


def _segment_masks():
    rng = np.random.default_rng(2)
    B, L = 400, 90
    runs = rng.choice([0, 2, 3], p=[0.3, 0.3, 0.4], size=(B, L // 6))
    mask = np.repeat(runs, 6, axis=1).astype(np.int32)
    noise = rng.random(mask.shape) < 0.05
    mask[noise] = rng.choice([0, 2, 3], size=noise.sum())
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    # ties: two equal 25-long target-3 chains (first wins)
    mask[0] = 0
    mask[0, 5:30] = 3
    mask[0, 50:75] = 3
    lengths[0] = L
    # a target at the last in-bounds base cannot start a chain
    mask[1] = 0
    mask[1, 40:66] = 2
    lengths[1] = 66
    mask[2] = 0
    mask[2, 65] = 3
    lengths[2] = 66
    # a higher flag between blocks a link; the gap bound is 10
    mask[3] = 0
    mask[3, 0:20] = 2
    mask[3, 22] = 3
    mask[3, 24:50] = 2
    mask[3, 60:71] = 2
    lengths[3] = L
    return mask, lengths


def test_extract_segments_ties_and_last_position():
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import extract_segments

    mask, lengths = _segment_masks()
    for target in (3, 2):
        ev, es, ee = (np.asarray(x) for x in extract_segments(
            jnp.asarray(mask), jnp.asarray(lengths), target))
        gv, gs, ge = (x.numpy() for x in tm.extract_segments(
            torch.from_numpy(mask), torch.from_numpy(lengths), target))
        assert (gv == ev).all() and (gs == es).all() and (ge == ee).all()
        words = np.array([_kernel_segments(*_mask_bits(m), int(n), mask.shape[1], target)
                          for m, n in zip(mask, lengths)])
        assert (words[:, 0] == ev).all() and (words[:, 1] == es).all()
        assert (words[:, 2] == ee).all()
        assert ev.any() and (~ev).any()
    ev, es, ee = (np.asarray(x) for x in extract_segments(
        jnp.asarray(mask[:2]), jnp.asarray(lengths[:2]), 3))
    assert (es[0], ee[0]) == (5, 29)  # the first of two equal chains


def _edge_masks(L, seed):
    """Masks of width L: random runs, and at every word edge and at the
    warp-chunk edge (base 1024) chains of one target spaced 9-12 apart,
    targets blocked by a higher flag in each gap, lengths on both sides
    of word and chunk edges."""
    rng = np.random.default_rng(seed)
    runs = rng.choice([0, 2, 3], p=[0.35, 0.35, 0.3], size=(48, -(-L // 7)))
    mask = np.repeat(runs, 7, axis=1)[:, :L].astype(np.int32)
    noise = rng.random(mask.shape) < 0.03
    mask[noise] = rng.choice([0, 2, 3], size=noise.sum())
    edges = [0, 1, 31, 32, 33, 63, 64, 65, 1023, 1024, 1025, L - 1, L]
    lengths = np.resize(np.array([e for e in edges if e <= L], np.int32), len(mask))
    rows, lens = [mask], [lengths]
    centre = 1024 if L > 1024 else L // 64 * 32  # a word edge, the chunk edge past 1024
    for gap in (9, 10, 11, 12):
        for target, between in ((3, 0), (2, 0), (2, 3)):
            m = np.zeros(L, np.int32)
            for t in range(max(0, centre - 5 * gap), L, gap):
                m[t] = target
                if between and t + gap // 2 < L:
                    m[t + gap // 2] = between
            rows.append(m[None])
            lens.append(np.array([L], np.int32))
    return np.concatenate(rows), np.concatenate(lens)


@pytest.mark.parametrize("L", [31, 32, 33, 63, 64, 65, 192, 1056, 1100])
def test_kernel_segments_mirror_matches_jax_at_word_edges(L):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import extract_segments

    mask, lengths = _edge_masks(L, seed=L)
    for target in (3, 2):
        ev, es, ee = (np.asarray(x) for x in extract_segments(
            jnp.asarray(mask), jnp.asarray(lengths), target))
        got = np.array([_kernel_segments(*_mask_bits(m), int(n), L, target)
                        for m, n in zip(mask, lengths)])
        assert (got[:, 0] == ev).all() and (got[:, 1] == es).all()
        assert (got[:, 2] == ee).all()
    if L >= 192:
        assert ev.any() and (~ev).any()


# ---------------- the pass-1 vote on hand-built rows ----------------


def _jax_vote(pr, packed, major_req=40, minor_req=20):
    """map_read_pass1's vote after the probe, in JAX: expand, (contig,
    pos - 2s), top2_votes and the gate -> (B, 5) [ok, h1, l1, h2, l2]."""
    import jax.numpy as jnp

    from genefuserust_tpu.config import PASS1_STEP
    from genefuserust_tpu.ops import map_read as jm

    c, p = jnp.asarray(pr[..., 0]), jnp.asarray(pr[..., 1])
    if hasattr(packed, "kv_tbl"):
        cc, cp, cv = jm.expand_candidates_kv(c, p, jnp.asarray(packed.dupes), packed.max_dupe,
                                             packed.cbits, packed.pos_bias)
    else:
        cc, cp, cv = jm.expand_candidates(c, p, jnp.asarray(packed.dupes), packed.max_dupe)
    B, NS, D = cc.shape
    i_idx = jnp.arange(NS, dtype=jnp.int32)[None, :, None] * PASS1_STEP
    h1, l1, c1, h2, l2, c2 = jm.top2_votes(cc.reshape(B, -1), (cp - i_idx).reshape(B, -1),
                                           cv.reshape(B, -1))
    ok = (c1 * PASS1_STEP >= major_req) & (c2 * PASS1_STEP >= minor_req)
    return np.stack([np.asarray(x).astype(np.int32) for x in (ok, h1, l1, h2, l2)], axis=1)


PAD_KEY = 2**63 - 1


def _votable(k):
    return k != 0 and (k >> 32) != 0x7FFFFFFF


def _kernel_vote(keys, P, step=2, major_req=40, minor_req=20, counts=False):
    """The vote kernel (csrc/vote.cu) on one row's n valid keys, step for
    step: for n <= 256 the warp path (bitonic network over K registers x
    32 lanes, run ends from the ballot masks of run starts), else the
    block path (sort, run lengths by binary search) -> [ok, h1, l1, h2,
    l2], or with `counts` [c1, h1, l1, c2, h2, l2]."""
    n = len(keys)
    if n <= tm.VOTE_WARP_KEYS:
        K = next(k for k in (1, 2, 4, 8) if 32 * k >= n)
        N = 32 * K
        v = [[PAD_KEY] * 32 for _ in range(K)]
        for e, key in enumerate(keys):
            v[e // 32][e % 32] = key
        for ls in range(1, N.bit_length()):
            for lj in range(ls - 1, -1, -1):
                size, j = 1 << ls, 1 << lj
                if j >= 32:
                    jr = j >> 5
                    for k in range(K):
                        if k & jr:
                            continue
                        asc = (k * 32) & size == 0
                        for lane in range(32):
                            a, b = v[k][lane], v[k | jr][lane]
                            v[k][lane], v[k | jr][lane] = (min(a, b), max(a, b)) if asc \
                                else (max(a, b), min(a, b))
                else:
                    new = [row[:] for row in v]
                    for k in range(K):
                        for lane in range(32):
                            other, e = v[k][lane ^ j], k * 32 + lane
                            keep_min = ((e & size) == 0) == ((e & j) == 0)
                            new[k][lane] = min(v[k][lane], other) if keep_min \
                                else max(v[k][lane], other)
                    v = new
        start = [[(v[k][lane - 1] != v[k][lane]) if lane else
                  (k == 0 or v[k - 1][31] != v[k][0]) for lane in range(32)] for k in range(K)]
        starts = [sum(1 << lane for lane in range(32) if start[k][lane]) for k in range(K)]
        sc = {}
        for k in range(K):
            for lane in range(32):
                if start[k][lane] and _votable(v[k][lane]):
                    e, nxt = k * 32 + lane, N
                    for kk in range(K - 1, k, -1):
                        if starts[kk]:
                            nxt = kk * 32 + (starts[kk] & -starts[kk]).bit_length() - 1
                    above = starts[k] & ~((2 << lane) - 1) & 0xFFFFFFFF
                    if above:
                        nxt = k * 32 + (above & -above).bit_length() - 1
                    sc[e] = ((nxt - e) << 32) | (N - 1 - e)
        flat = [v[e // 32][e % 32] for e in range(N)]
    else:
        N = 1 << (n - 1).bit_length()
        flat = sorted(keys) + [PAD_KEY] * (N - n)
        sc = {}
        for i in range(n):
            if (i == 0 or flat[i - 1] != flat[i]) and _votable(flat[i]):
                cnt = sum(1 for x in flat[i:n] if x == flat[i])
                sc[i] = (cnt << 32) | (N - 1 - i)
    best1 = max(sc.values(), default=-1)
    e1 = N - 1 - (best1 & 0xFFFFFFFF) if best1 >= 0 else 0
    best2 = max((x for e, x in sc.items() if e != e1), default=-1)
    e2 = N - 1 - (best2 & 0xFFFFFFFF) if best2 >= 0 else 0
    smin = _slot_min(flat[0] if n else 0, n, P)
    c1, g1 = (best1 >> 32, flat[e1]) if best1 >= 0 else (0, smin)
    c2, g2 = (best2 >> 32, flat[e2]) if best2 >= 0 else (0, smin)
    return _vote_row(c1, g1, c2, g2, step, major_req, minor_req, counts)


def _slot_min(first, n, P):
    """The smallest key over a row's P = NS * D slots (empty ones hold
    INVALID_KEY) from its smallest valid key."""
    return tm.INVALID_KEY if n == 0 else (min(first, tm.INVALID_KEY) if n < P else first)


def _vote_row(c1, g1, c2, g2, step, major_req, minor_req, counts):
    def i32(x):
        return (x + 2**31) % 2**32 - 2**31

    if counts:
        return [int(c1), i32(g1 >> 32), i32(g1), int(c2), i32(g2 >> 32), i32(g2)]
    return [int(c1 * step >= major_req and c2 * step >= minor_req),
            i32(g1 >> 32), i32(g1), i32(g2 >> 32), i32(g2)]


VOTE_WIDE_THREADS = 1024  # a wide row's block (csrc/vote.cu)
VOTE_WALK_MAX = 2048  # samples a warp of vote_kernel walks on the wide path


def _counted_bitonic(keys):
    """block_sort: a bitonic network over next_pow2(n) slots whose
    comparators all put the smaller key at the lower index (a merge starts
    by comparing mirrored halves); the slots past n are +inf and never
    stored, so a comparator that reaches one does nothing."""
    k = np.array(keys, np.int64)
    n = len(k)
    Pn = 1 << max(0, n - 1).bit_length()
    q = np.arange(Pn >> 1)
    size = 2
    while size <= Pn:
        j = size >> 1
        while j:
            flip = size - 1 if j == size >> 1 else j
            i = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            p = i ^ flip
            i, p = i[p < n], p[p < n]
            a, c = k[i], k[p]
            swap = a > c
            k[i[swap]], k[p[swap]] = c[swap], a[swap]
            j >>= 1
        size <<= 1
    return k


def _wide_block_vote(keys, P, threads=VOTE_WIDE_THREADS):
    """vote_wide_kernel's vote of one row from its n valid keys: the
    counted sort, then each thread a tile of ceil(n / threads) sorted keys;
    a run's start reaches later tiles by a block exclusive max-scan of the
    tiles' last starts, a run scores at its last key as (count << 32) | (n
    - 1 - start), each thread keeps its best two, and two block maxima give
    the top two -> (c1, g1, c2, g2)."""
    k = _counted_bitonic(keys)
    n = len(k)
    assert sorted(keys) == k.tolist()
    if n == 0:
        return 0, tm.INVALID_KEY, 0, tm.INVALID_KEY
    per = -(-n // threads)
    start = np.ones(n, bool)
    start[1:] = k[1:] != k[:-1]
    tiles = [(min(n, t * per), min(n, t * per + per)) for t in range(threads)]
    last = [max((i for i in range(a, b) if start[i]), default=-1) for a, b in tiles]
    carry = np.maximum.accumulate([-1] + last)[:-1]
    bests = []
    for (a, b), s in zip(tiles, carry):
        b1 = b2 = -1
        s = int(s)
        for i in range(a, b):
            if start[i]:
                s = i
            if (i + 1 == n or k[i + 1] != k[i]) and _votable(int(k[i])):
                sc = ((i + 1 - s) << 32) | (n - 1 - s)
                b1, b2 = (sc, b1) if sc > b1 else (b1, max(b2, sc))
        bests.append((b1, b2))
    best1 = max(b1 for b1, _ in bests)
    best2 = max(b2 if b1 == best1 else b1 for b1, b2 in bests)
    smin = _slot_min(int(k[0]), n, P)
    e1 = n - 1 - (best1 & M32) if best1 >= 0 else 0
    e2 = n - 1 - (best2 & M32) if best2 >= 0 else 0
    c1, g1 = (best1 >> 32, int(k[e1])) if best1 >= 0 else (0, smin)
    c2, g2 = (best2 >> 32, int(k[e2])) if best2 >= 0 else (0, smin)
    return c1, g1, c2, g2


def _row_samples(length, NS, step=2):
    """row_samples: the samples inside a row, s * step <= min(len, L) - 16."""
    return 0 if length < 16 else min(NS, (length - 16) // step + 1)


def _wide_row_keys(pr_row, ns, index, step=2):
    """A wide row's valid keys as the kernels compact them: its first ns
    samples chunk by chunk of 32 (the warps' ranges are whole chunks, in
    order); in a chunk the regular hits by lane, then each DUPE sample's
    valid slots."""
    cc, cp, cv = (x.numpy() for x in tm.expand(index, pr_row[:ns, 0], pr_row[:ns, 1]))
    cc, cp = cc.astype(np.int64), cp.astype(np.int64)
    kind = pr_row[:ns, 0].numpy()[:, None]
    s, d = np.arange(ns)[:, None], np.arange(cc.shape[1])[None, :]
    keys = (cc << 32) | ((cp - s * step) & M32)
    dupe = (kind == DUPE) & (index.D > 1)
    take = ((kind >= 0) & (d == 0)) | (dupe & cv)
    order = np.lexsort(tuple(np.broadcast_to(x, cc.shape)[take]
                             for x in (d, s, dupe, s // 32)))
    return keys[take][order].tolist()


def _vote_routes(pr, lengths, index, smem_cap=None):
    """Where the wide path votes each row: "warp" (vote_kernel: at most
    VOTE_WALK_MAX samples inside the row and 256 valid keys), else the
    block with its keys in shared memory ("shared") or, past smem_cap // 8
    keys, global scratch ("global")."""
    cap = (tm.WIDE_SMEM_BYTES if smem_cap is None else smem_cap) // 8
    n = tm.vote_candidates(pr, index).tolist()
    ns = [_row_samples(int(x), pr.shape[1]) for x in lengths]
    return ["warp" if s <= VOTE_WALK_MAX and k <= tm.VOTE_WARP_KEYS else
            "global" if k > cap else "shared" for s, k in zip(ns, n)]


def _kernel_vote_rows(pr, lengths, index, counts=False, major_req=40, minor_req=20):
    """The wide path of the vote on (B, NS, 2) probe results -> (B, 5), or
    with `counts` (B, 6), int32 rows: vote_kernel walks a row of at most
    VOTE_WALK_MAX samples up to its length and votes it in its warp if it
    holds at most 256 valid keys; any other row goes to vote_wide_kernel
    (_vote_routes; shared memory or global scratch hold the same keys)."""
    B, NS = pr.shape[:2]
    P = NS * index.D
    rows = []
    for b, route in enumerate(_vote_routes(pr, lengths, index)):
        keys = _wide_row_keys(pr[b], _row_samples(int(lengths[b]), NS), index)
        if route == "warp":
            rows.append(_kernel_vote(keys, P, 2, major_req, minor_req, counts))
        else:
            rows.append(_vote_row(*_wide_block_vote(keys, P), 2, major_req, minor_req, counts))
    return np.array(rows, np.int32).reshape(B, 6 if counts else 5)


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_vote_plain_matches_jax_on_edge_rows(layout):
    """vote_plain against JAX's top2_votes + gate on vote_edge_rows, and
    the kernel's algorithm (mirrored in Python) against both."""
    from genefuserust_tpu_torch.utils.synthetic import vote_edge_rows

    pr, packed, names = vote_edge_rows(seed=5, layout=layout)
    index = index_to_torch(packed, "cpu")
    got = tm.vote_plain(pr, index, 40, 20).numpy()
    exp = _jax_vote(pr.numpy(), packed)
    assert (got == exp).all(), [names[i] for i in np.nonzero((got != exp).any(1))[0]]
    keys, cv = tm._keys_at(index, pr, 2)
    B, P = pr.shape[0], pr.shape[1] * index.D
    for b in range(B):
        valid = keys[b].reshape(-1)[cv[b].reshape(-1)].tolist()
        assert _kernel_vote(valid, P) == got[b].tolist(), names[b]
    n = tm.vote_candidates(pr, index)
    assert (n > tm.VOTE_WARP_KEYS).any() and (n == 0).any()
    assert got[:, 0].any() and not got[:, 0].all()
    # key 0 only: both entries missing, filled with the smallest key, 0
    assert got[names.index("only_key_0")].tolist() == [0, 0, 0, 0, 0]
    assert got[names.index("no_valid")].tolist() == [0] + [tm.INT32_MAX] * 4


# ---------------- the passes on a panel with dupes ----------------


@pytest.fixture(scope="module")
def panel_ix(tmp_path_factory):
    panel = make_panel(seed=11)
    for (_, chrom, start, _), offs in zip(
        panel.genes, ([1000, 3000, 7000], [500 + 1100 * k for k in range(8)])
    ):
        s = panel.contigs[chrom]
        for off in offs:
            s = s[: start + off] + MOTIF + s[start + off + len(MOTIF) :]
        panel.contigs[chrom] = s
    _, csv_path = write_panel_files(panel, str(tmp_path_factory.mktemp("panel")))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), Settings())
    ix.make_index()
    assert ix.kmer_dupe and ix.kmer_high
    return panel, ix


def _reads(panel):
    rng = np.random.default_rng(3)
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    g1, g2 = panel.contigs[c1], panel.contigs[c2]
    fused = g1[s1 + 4700 : s1 + 5001] + g2[s2 + 6000 : s2 + 6300]
    reads = [fused[160 + 11 * k : 310 + 11 * k] for k in range(8)]
    for _ in range(24):
        s = (g1, g2)[int(rng.integers(2))]
        off = int(rng.integers(0, len(s) - 150))
        reads.append(s[off : off + 150])
    reads += [reverse_complement(r) for r in reads[:4]]
    for k in range(4):
        r = list(reads[k])
        for p in rng.integers(0, 150, size=3):
            r[int(p)] = "N"
        reads.append("".join(r))
    # dupe motifs, a chimera through a dupe motif, reads overhanging a
    # gene start (pos - i crosses 0), a short read and an all-N read
    reads += [g1[s1 + 990 : s1 + 1140], g2[s2 + 490 : s2 + 640],
              g1[s1 + 2950 : s1 + 3030] + g2[s2 + 5000 : s2 + 5070],
              g1[s1 - 40 : s1 + 110], g2[s2 - 70 : s2 + 80],
              g1[s1 - 30 : s1 + 50] + g2[s2 + 7000 : s2 + 7070],
              "ACGT" * 5, "N" * 150]
    return reads


def _batch(reads, L=160):
    codes = np.full((len(reads), L), 255, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, s in enumerate(reads):
        c = encode_bases(s)
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    return codes, lengths


def _packed(ix, layout):
    if layout == "split":
        return pack_index(ix)
    if layout in ("kvs", "kv16"):
        p = (pack_index_kvs if layout == "kvs" else pack_index_kv16)(ix)
    else:
        p = pack_index_kv(ix, **LAYOUTS[layout])
    assert p is not None
    return p


def jax_kv(packed):
    """The JAX engine's `kv` static of a kv table: 2 for kv16 (16-wide
    rows), 3 for kvs (the `single_probe` marker), else True."""
    if packed.kv_tbl.shape[1] == 16:
        return 2
    return 3 if getattr(packed, "single_probe", False) else True


def _jax_tables(packed):
    import jax.numpy as jnp

    if hasattr(packed, "kv_tbl"):
        return (jnp.asarray(packed.kv_tbl), jnp.zeros((1, 2), jnp.int32),
                jnp.asarray(packed.dupes),
                dict(kv=jax_kv(packed), cbits=packed.cbits, pos_bias=packed.pos_bias))
    return (jnp.asarray(packed.keys_tbl), jnp.asarray(packed.vals_tbl),
            jnp.asarray(packed.dupes), {})


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_map_read_passes_match_jax(panel_ix, layout):
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    panel, ix = panel_ix
    st = ix.settings
    packed = _packed(ix, layout)
    index = index_to_torch(packed, "cpu")
    t1, t2, dupes, kw = _jax_tables(packed)
    codes, lengths = _batch(_reads(panel))
    cj, lj = jnp.asarray(codes), jnp.asarray(lengths)
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lengths)
    reqs = (st.major_gene_key_requirement, st.minor_gene_key_requirement)

    p1_j = [np.array(x) for x in jm.map_read_pass1(
        cj, lj, t1, t2, dupes, packed.shift, packed.max_dupe, *reqs, **kw)]
    p1_t = [x.numpy() for x in tm.map_read_pass1(ct, lt, index, *reqs)]
    for got, want in zip(p1_t, p1_j):
        assert (got == want).all()
    assert p1_j[0].any() and not p1_j[0].all()

    h = [jnp.asarray(x) for x in p1_j[1:]]
    r_j = jm.map_read_pass2(cj, lj, *h, t1, t2, dupes, packed.shift,
                            packed.max_dupe, st.mismatch_threshold, **kw)
    r_t = tm.map_read_pass2(ct, lt, *(torch.from_numpy(x) for x in p1_j[1:]),
                            index, st.mismatch_threshold)
    for got, want in zip(r_t, r_j):
        assert (got.numpy() == np.asarray(want)).all()

    b_j = jm.map_read_batch(cj, lj, t1, t2, dupes, packed.shift, packed.max_dupe,
                            *reqs, st.mismatch_threshold, **kw)
    b_t = tm.map_read_batch(ct, lt, index, *reqs, st.mismatch_threshold)
    for got, want in zip(b_t, b_j):
        assert (got.numpy() == np.asarray(want)).all()
    assert np.asarray(b_j.seg_valid).all(axis=1).sum() >= 4  # junction reads


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lookup_expand_matches_jax(panel_ix, layout):
    """Probe + dupe expansion: regular hits, dupe rows and high dupes."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    panel, ix = panel_ix
    packed = _packed(ix, layout)
    t1, t2, dupes, kw = _jax_tables(packed)
    codes, lengths = _batch(_reads(panel))
    km, kv = jm.compute_kmers(jnp.asarray(codes), jnp.asarray(lengths))
    exp = jm.lookup_expand(t1, t2, dupes, packed.shift, packed.max_dupe,
                           kw.get("kv", False), kw.get("cbits", 0), kw.get("pos_bias", 0),
                           km, kv)
    got = tm.lookup_expand(index_to_torch(packed, "cpu"),
                           torch.from_numpy(np.asarray(km).astype(np.int64)),
                           torch.from_numpy(np.array(kv)))
    for g, e in zip(got, exp):
        assert g.shape == e.shape and (g.numpy() == np.asarray(e)).all()
    cv = got[2].numpy()
    assert cv.shape[-1] > 1 and cv[..., 1:].any()  # some dupe rows expanded


# ---------------- pass 2 on hand-built probe results ----------------

MASK_WIDTHS = [31, 32, 33, 46, 47, 48, 63, 64, 65, 78, 79, 80, 192, 320, 1100]
EDGE_LENGTHS = [0, 1, 31, 32, 33, 63, 64, 65]


def _mask_edge_rows(index, L, seed):
    """Pass-2 probe results built by hand at code width L -> (pr (B, NK, 2)
    int32, lengths (B,) int32, gp (B, 4) int32 [h1, l1, h2, l2], names).

    A k-mer flagged 3 holds a hit within +-1 of the top key, flagged 2 one
    of the second key; an unflagged k-mer a miss, a high dupe, a hit 2-10
    off the top key or a dupe row that matches neither. Rows: two equal
    chains, a target at the last in-bounds base, gaps of 10 and 11 for both
    targets, a higher flag inside a gap, two segments, 10 and 11
    mismatches, keys met only in dupe rows (slot 0 and a later slot), no
    flag, all flagged, and random runs at lengths on word edges."""
    NK = L - 15
    rng = np.random.default_rng(seed)
    nd = index.dupes.shape[0]
    cc, cp, cv = (x.numpy() for x in tm.expand(
        index, torch.full((nd,), DUPE, dtype=torch.int32), torch.arange(nd, dtype=torch.int32)))
    multi = np.nonzero(cv[:, 1])[0]
    ra, rb, rc = (int(multi[k]) for k in (0, -1, len(multi) // 2))
    plain = ((1, 5000), (2, 2**31 - 3))  # the second key's pos + i wraps int32
    h, t = NK // 2, NK // 3
    i0, i1 = min(5, NK - 2), min(h + 3, NK - 1)
    dupe_keys = ((int(cc[ra, 1]), int(cp[ra, 1]) - i0), (int(cc[rb, 0]), int(cp[rb, 0]) - i1))
    # (first k-mer, last k-mer, flag) spans: a k-mer flags bases i..i+15
    designs = [
        ("equal_chains", [(0, 9, 3), (40, 49, 3), (10, 39, 2), (50, NK - 1, 2)], L, plain, ()),
        ("last_base", [(0, 20, 3), (50, 50, 3)], 51, plain, ()),
        ("gap_10", [(0, 19, 3), (44, NK - 1, 3)], L, plain, ()),
        ("gap_11", [(0, 19, 3), (45, NK - 1, 3)], L, plain, ()),
        ("gap_10_second", [(0, 19, 2), (44, NK - 1, 2)], L, plain, ()),
        ("gap_11_second", [(0, 19, 2), (45, NK - 1, 2)], L, plain, ()),
        ("higher_in_gap", [(0, 19, 2), (30, 30, 3), (40, NK - 1, 2)], L, plain, ()),
        ("two_segments", [(0, h - 16, 3), (h, NK - 1, 2)], L, plain, ()),
        ("mismatch_10", [(0, t, 3), (t + 26, NK - 1, 3)], L, plain, ()),
        ("mismatch_11", [(0, t, 3), (t + 27, NK - 1, 3)], L, plain, ()),
        ("dupe_keys", [(0, h - 16, 3), (h, NK - 1, 2)], L, dupe_keys,
         ((i0, ra), (i0 + 1, ra), (i1, rb))),
        ("no_flag", [], L, plain, ()),
        ("all_3", [(0, NK - 1, 3)], L, dupe_keys, ((i0, ra),)),
    ]
    for k in range(12):
        spans, a = [], 0
        while a < NK:
            n = int(rng.integers(1, 40))
            spans.append((a, a + n - 1, int(rng.choice([0, 2, 3], p=[0.4, 0.3, 0.3]))))
            a += n
        n = EDGE_LENGTHS[k % len(EDGE_LENGTHS)] if k < len(EDGE_LENGTHS) else L - k % 2
        designs.append((f"random_{k}", spans, n, dupe_keys if k % 2 else plain,
                        ((i0, ra),) if k % 2 else ()))
    pr = np.zeros((len(designs), NK, 2), np.int64)
    pr[..., 0] = EMPTY
    lengths, gp, names = [], [], []
    for r, (name, spans, n, (g1, g2), dupes_at) in enumerate(designs):
        flag = np.zeros(NK, np.int64)
        for a, b, f in spans:
            flag[max(a, 0) : min(b, NK - 1) + 1] = f
        for i, f in enumerate(flag):
            if f:
                c, lo = g1 if f == 3 else g2
                pr[r, i] = (c, lo + i + int(rng.integers(-1, 2)))
            else:
                pr[r, i] = [(EMPTY, 0), (HIGH, 0), (g1[0], g1[1] + i + int(rng.integers(2, 11))),
                            (DUPE, rc)][int(rng.integers(4))]
        for i, row in dupes_at:
            pr[r, i] = (DUPE, row)
        lengths.append(min(n, L))
        gp.append((g1[0], g1[1], g2[0], g2[1]))
        names.append(name)
    wrap = np.vectorize(lambda x: (x + 2**31) % 2**32 - 2**31)
    return (torch.from_numpy(wrap(pr).astype(np.int32)),
            torch.tensor(lengths, dtype=torch.int32),
            torch.from_numpy(wrap(np.array(gp, np.int64)).astype(np.int32)), names)


def _jax_pass2(pr, lengths, gp, packed, mismatch_thr=10):
    """JAX map_read_pass2, unjitted, on given probe results: its k-mer
    build and table lookup return `pr`; the dupe expansion, `_eq_pm1`, the
    mask, the mismatch count and `extract_segments` run as they are ->
    (B, 10) int32 rows in the kernel's column order."""
    from unittest import mock

    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    B, NK = pr.shape[:2]
    t1, t2, dupes, kw = _jax_tables(packed)
    found = (jnp.asarray(pr[..., 0].numpy()), jnp.asarray(pr[..., 1].numpy()))
    kmers = (jnp.zeros((B, NK), jnp.uint32), jnp.ones((B, NK), bool))
    with mock.patch.object(jm, "compute_kmers", lambda *_: kmers), \
            mock.patch.object(jm, "kv_lookup", lambda *_: found), \
            mock.patch.object(jm, "hash_lookup", lambda *_: found):
        r = jm.map_read_pass2.__wrapped__(
            jnp.zeros((B, NK + 15), jnp.uint8), jnp.asarray(lengths.numpy()),
            *(jnp.asarray(gp[:, k].numpy()) for k in range(4)), t1, t2, dupes,
            packed.shift, packed.max_dupe, mismatch_thr, **kw)
    return np.concatenate([np.asarray(r.seg_valid).astype(np.int32), *(
        np.asarray(x) for x in (r.seg_start, r.seg_end, r.seg_contig, r.seg_pos))], axis=1)


@pytest.fixture(scope="module")
def mask_cases(panel_ix):
    """Per layout (kv2, split): the packed panel, its CPU index, and per
    width of MASK_WIDTHS the edge rows with JAX's rows for them. JAX runs
    once a layout, on every width's rows with their k-mers padded to the
    widest as misses: a miss flags no base, and no base at or past a
    row's width is within its length, so the padding changes no output."""
    cases = {}
    for layout in ("kv2", "split"):
        packed = _packed(panel_ix[1], layout)
        index = index_to_torch(packed, "cpu")
        rows = {L: _mask_edge_rows(index, L, seed=L) for L in MASK_WIDTHS}
        NK = max(MASK_WIDTHS) - 15
        pad = [torch.cat([pr, torch.tensor([EMPTY, 0], dtype=torch.int32).expand(
            pr.shape[0], NK - pr.shape[1], 2)], 1) for pr, *_ in rows.values()]
        exp = _jax_pass2(torch.cat(pad), *(torch.cat([r[k] for r in rows.values()])
                                          for k in (1, 2)), packed)
        ends = np.cumsum([0] + [r[0].shape[0] for r in rows.values()])
        cases[layout] = packed, index, {L: (*rows[L], exp[a:b]) for L, a, b in
                                        zip(rows, ends[:-1], ends[1:])}
    return cases


@pytest.mark.parametrize("L", MASK_WIDTHS)
@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_mask_mirror_matches_jax_pass2_on_edge_rows(mask_cases, layout, L):
    """The kernel's steps (mirrored in Python) and mask_segments_plain
    against JAX map_read_pass2 after its lookup, on hand-built rows."""
    _, index, rows = mask_cases[layout]
    pr, lengths, gp, names, exp = rows[L]
    plain = tm.mask_segments_plain(pr, lengths, gp, index, 10).numpy()
    bad = [names[i] for i in np.nonzero((plain != exp).any(1))[0]]
    assert not bad, f"mask_segments_plain differs from JAX on {bad}"
    got = _kernel_mask_segments(pr, lengths, gp, index)
    bad = [names[i] for i in np.nonzero((got != exp).any(1))[0]]
    assert not bad, f"the kernel mirror differs from JAX on {bad}"
    if L >= 192:
        row = dict(zip(names, exp))
        assert row["equal_chains"][[0, 2, 4]].tolist() == [1, 0, 24]
        assert row["last_base"][4] == 35 and row["no_flag"][[0, 2, 4]].tolist() == [0, -1, 0]
        assert row["gap_10"][[0, 2, 4]].tolist() == [1, 0, L - 1]
        assert row["gap_11"][[0, 2, 4]].tolist() == [1, 45, L - 1]
        assert row["gap_10_second"][[1, 3, 5]].tolist() == [1, 0, L - 1]
        assert row["gap_11_second"][[1, 3, 5]].tolist() == [1, 45, L - 1]
        assert row["higher_in_gap"][[1, 3, 5]].tolist() == [1, 46, L - 1]
        assert row["two_segments"][:2].tolist() == [1, 1]
        assert row["dupe_keys"][:2].tolist() == [1, 1]
        assert row["mismatch_10"][0] == 1 and row["mismatch_11"][0] == 0


# ---------------- kernels 2 and 3 on the card ----------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_vote_and_mask_kernels_match_plain(panel_ix, layout, cuda_device):
    panel, ix = panel_ix
    packed = _packed(ix, layout)
    cpu, dev = index_to_torch(packed, "cpu"), index_to_torch(packed, cuda_device)
    codes, lengths = _batch(_reads(panel) * 8, L=256)
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lengths)
    cd, ld = ct.to(cuda_device), lt.to(cuda_device)
    pr = tm.probe(ct, lt, 2, cpu)
    exp_v = tm.vote(pr, cpu, 40, 20)
    got_v = tm.vote(pr.to(cuda_device), dev, 40, 20)
    assert torch.equal(got_v.cpu(), exp_v)
    gp = exp_v[:, 1:5].contiguous()
    pr1 = tm.probe(ct, lt, 1, cpu)
    exp_m = tm.mask_segments(pr1, lt, gp, cpu, 10)
    got_m = tm.mask_segments(pr1.to(cuda_device), ld, gp.to(cuda_device), dev, 10)
    assert torch.equal(got_m.cpu(), exp_m)
    assert exp_m[:, 0].any()
    got_b = tm.map_read_batch(cd, ld, dev)
    exp_b = tm.map_read_batch(ct, lt, cpu)
    for g, e in zip(got_b, exp_b):
        assert torch.equal(g.cpu(), e)
    # hand-built rows: the warp path's register widths and the block path
    from genefuserust_tpu_torch.utils.synthetic import vote_edge_rows

    epr, epacked, _ = vote_edge_rows(seed=5, layout=layout)
    eidx = index_to_torch(epacked, "cpu")
    assert torch.equal(tm.vote(epr.to(cuda_device), index_to_torch(epacked, cuda_device),
                               40, 20).cpu(), tm.vote_plain(epr, eidx, 40, 20))


@pytest.mark.cuda
@pytest.mark.parametrize("L", MASK_WIDTHS)
@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_mask_kernel_matches_plain_on_edge_rows(panel_ix, layout, L, cuda_device):
    # the hand-built pass-2 rows of every width, kernel against plain and
    # against the Python mirror of its steps
    packed = _packed(panel_ix[1], layout)
    cpu, dev = index_to_torch(packed, "cpu"), index_to_torch(packed, cuda_device)
    pr, lengths, gp, names = _mask_edge_rows(cpu, L, seed=L)
    exp = tm.mask_segments_plain(pr, lengths, gp, cpu, 10)
    got = tm.mask_segments(pr.to(cuda_device), lengths.to(cuda_device), gp.to(cuda_device),
                           dev, 10).cpu()
    bad = [names[i] for i in torch.nonzero((got != exp).any(1)).flatten().tolist()]
    assert not bad, f"mask_segments kernel differs from plain on {bad}"
    assert np.array_equal(got.numpy(), _kernel_mask_segments(pr, lengths, gp, cpu))
    # the same rows moved past the 16-bit chain ends (misses in front, the
    # hits' positions moved with them) take the wide path, equal to plain
    off = tm.MASK_MAX_WIDTH
    moved = pr.clone()
    moved[..., 1] += torch.where(pr[..., 0] >= 0, off, 0).to(torch.int32)
    front = torch.tensor([EMPTY, 0], dtype=torch.int32).expand(pr.shape[0], off, 2)
    wpr, wlen = torch.cat([front, moved], 1), lengths + off
    wexp = tm.mask_segments_plain(wpr, wlen, gp, cpu, 10)
    wgot = tm.mask_segments(wpr.to(cuda_device), wlen.to(cuda_device), gp.to(cuda_device),
                            dev, 10).cpu()
    assert torch.equal(wgot, wexp) and (wexp[:, 4] > tm.MASK_MAX_WIDTH).any()
