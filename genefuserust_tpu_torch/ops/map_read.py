"""Batched map_read on torch tensors: the two-pass k-mer vote/mask scan.

Port of `genefuserust_tpu/ops/map_read.py`. The plain PyTorch functions
keep the JAX names; three of them have a hand-written CUDA kernel beside
them (csrc/), reached through a wrapper that launches the kernel for CUDA
tensors and runs the plain version for CPU tensors:

  probe          compute_kmers + kv_lookup / single_probe_lookup / hash_lookup
                                                          (csrc/probe.cu)
  vote           expand + gplong + top2_votes + gate     (csrc/vote.cu)
  mask_segments  expand + flags + mask + extract_segments (csrc/mask_segments.cu)

The contig-sharded index (parallel/sharded_index.py) takes the vote and
pass 2 apart at their seams, with a wrapper and plain version each:

  vote_counts         the vote's two entries with their counts, no gate (vote.cu)
  vote_counts_shards  vote_counts of a device's shards in one launch    (vote.cu)
  merge_top2          the shards' entries merged, then the gate         (vote.cu)
  shard_flags         the shards' per-k-mer flags ORed into bit planes  (mask_segments.cu)
  mask_from_flags     mask + extract_segments from those planes         (mask_segments.cu)

The vote and mask+segments have no width limit: rows too wide for the
vote's shared memory, or for mask+segments' 16-bit chain ends, take wide
paths on the card. There a row's work is bounded by its own length, not
the batch's padded width, and a long row gets a block with its keys or
words in shared memory (global scratch only past `WIDE_SMEM_BYTES`; the
`smem_cap` argument, which no production caller passes, lowers that cap
so that tests can force the global route).

gplong (the reference's i64 `contig<<32 | pos bits`) is carried as ONE
int64 here instead of the JAX package's two int32 planes. JAX forms the
low half as `pos - i` in wrapping int32 with no borrow into the contig,
so the port packs `(contig << 32) | ((pos - i) & 0xFFFFFFFF)` and never
subtracts from the packed value. With that key, ascending int64 order is
JAX's (hi signed, lo unsigned) order and `_eq_pm1` is `|key - g| <= 1`.

uint32 arithmetic (hashes, payload decode) is done in int64 masked to 32
bits: torch on the CPU does not shift, add or compare uint32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ALLOWED_GAP, KMER, PASS1_STEP, THRESHOLD_LEN
from . import cuda
from .hashtable import DUPE, EMPTY, HIGH, OVF_PAYLOAD
from .index import TorchIndex

INT32_MAX = 0x7FFFFFFF
M32 = 0xFFFFFFFF
# JAX's invalid candidate (hi = lo = INT32_MAX) as a packed key; sorts after
# every real candidate
INVALID_KEY = (INT32_MAX << 32) | INT32_MAX
# per-row candidate slots (NS * D, rounded up) that the vote kernel's block
# path sorts in shared memory (MAX_BLOCK_KEYS in csrc/vote.cu); wider rows
# take the wide path
MAX_VOTE_KEYS = 16384
# shared memory a block of the wide paths may give a long row's keys (the
# vote, 8 bytes a key: VOTE_SMEM_KEYS in csrc/vote.cu) or words
# (mask+segments, 16 bytes a word: MASK_SMEM_CAP in csrc/mask_segments.cu);
# past it they go to global scratch
WIDE_SMEM_BYTES = 224 * 1024
# mask+segments' wide launch: rows a block (a row a warp), the longest row
# a warp takes in words (2,048 bases; a longer one takes the block), and
# the warps' shared memory, which any long row whose words fit may use
# (MASK_WIDE_WARPS, MASK_WARP_WORDS in csrc/mask_segments.cu)
MASK_WIDE_WARPS = 16
MASK_WARP_WORDS = 64
MASK_SLICE_BYTES = MASK_WIDE_WARPS * 16 * MASK_WARP_WORDS
# valid candidates a row may hold on the vote kernel's warp path (WARP_CAP
# in csrc/vote.cu)
VOTE_WARP_KEYS = 256
# distinct keys the warp path counts one by one; a row of more is sorted
# (PEEL_CAP in csrc/vote.cu)
VOTE_PEEL_KEYS = 16
# samples a warp walks on the vote's wide route (VOTE_WALK_MAX in csrc/vote.cu)
VOTE_WALK_MAX = 2048
# slots of the vote's row counter (VOTE_STAT_SLOTS in csrc/common.cuh): the
# launches add (rows voted on the warp path) + (rows sorted) << 32
VOTE_STAT_SLOTS = 32
# widest code row of the mask+segments kernels' main path, which keeps a
# chain end in 16 bits (MASK_MAX_L in csrc/mask_segments.cu); wider rows
# take the wide launch (64-bit chain keys)
MASK_MAX_WIDTH = 0xFFFF
# shards merge_top2's kernel and one vote_counts_shards launch take
# (MAX_SHARDS in csrc/vote.cu)
MAX_SHARDS = 8
# shards one shard_flags launch takes (MAX_FLAG_SHARDS in csrc/mask_segments.cu)
MAX_FLAG_SHARDS = 8


class MapReadResult(NamedTuple):
    """Per-read outputs; segment 0 is the TOP target, 1 the SECOND."""

    seg_valid: torch.Tensor  # (B, 2) bool
    seg_start: torch.Tensor  # (B, 2) int32
    seg_end: torch.Tensor  # (B, 2) int32
    seg_contig: torch.Tensor  # (B, 2) int32
    seg_pos: torch.Tensor  # (B, 2) int32


# ---------------- 32-bit helpers on int64 ----------------


def _mul32(k: torch.Tensor, m: int) -> torch.Tensor:
    """(k * m) mod 2^32 for 0 <= k < 2^32, without int64 overflow."""
    lo = k * (m & 0xFFFF)
    hi = ((k * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> int32 with that bit pattern."""
    x = x & M32
    return torch.where(x > INT32_MAX, x - (1 << 32), x).to(torch.int32)


def buckets(kmers: torch.Tensor, shift: int):
    """The 2-choice bucket pair of each k-mer (int64 in [0, 2^32))."""
    b1 = _mul32(kmers, 0x9E3779B1) >> shift
    b2 = ((_mul32(kmers ^ (kmers >> 15), 0x85EBCA6B) + 0xC2B2AE35) & M32) >> shift
    return b1, b2


def gplong(contig: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(contig, pos-bits) -> packed int64 key; `lo` is any integer tensor
    whose low 32 bits are the position bits."""
    return (contig.to(torch.int64) << 32) | (lo.to(torch.int64) & M32)


def _hi_lo(g: torch.Tensor):
    return (g >> 32).to(torch.int32), _i32(g)


# ---------------- plain versions ----------------


def compute_kmers(codes: torch.Tensor, lengths: torch.Tensor):
    """(B, L) uint8 codes -> (B, NK) int64 k-mers (uint32 values) + validity."""
    B, L = codes.shape
    NK = L - KMER + 1
    ok = codes != 255
    c = torch.where(ok, codes, 0).to(torch.int64)
    km = torch.zeros((B, NK), dtype=torch.int64, device=codes.device)
    for j in range(KMER):
        km |= c[:, j : j + NK] << (2 * (KMER - 1 - j))
    km &= M32
    cs = torch.cumsum((~ok).to(torch.int32), dim=1)
    cse = torch.cat([torch.zeros((B, 1), dtype=cs.dtype, device=cs.device), cs], 1)
    clean = (cse[:, KMER:] - cse[:, :-KMER]) == 0
    i_idx = torch.arange(NK, device=codes.device)
    in_range = i_idx[None, :] <= (lengths[:, None].to(torch.int64) - KMER)
    return km, clean & in_range


def hash_lookup(keys_tbl, vals_tbl, shift: int, kmers, valid):
    """Split layout: -> (contig, pos) int32, contig == EMPTY on a miss or an
    invalid query. The first matching slot wins, h1's bucket first."""
    S = keys_tbl.shape[1]
    ki = _i32(kmers)
    b1, b2 = buckets(kmers, shift)
    b1 = torch.where(valid, b1, 0)
    b2 = torch.where(valid, b2, 0)
    m1 = keys_tbl[b1] == ki[..., None]
    m2 = keys_tbl[b2] == ki[..., None]
    f1 = m1.any(-1)
    f2 = m2.any(-1)
    s1 = m1.to(torch.uint8).argmax(-1)
    s2 = m2.to(torch.uint8).argmax(-1)
    found = (f1 | f2) & valid
    flat = torch.where(f1, b1, b2) * S + torch.where(f1, s1, s2)
    sel = vals_tbl[torch.where(found, flat, 0)]
    out_c = torch.where(found, sel[..., 0], EMPTY)
    out_p = torch.where(found, sel[..., 1], 0)
    return out_c, out_p


def _decode(pay: torch.Tensor, cbits: int, pos_bias: int):
    """Packed uint32 payloads (int64) -> (contig, pos) int32 with the split
    layout's conventions (EMPTY, HIGH, DUPE with pos = dupe row, regular)."""
    pbits = 32 - cbits
    tag = pay >> pbits
    val = pay & ((1 << pbits) - 1)
    contig = torch.where(
        tag == 0,
        EMPTY,
        torch.where(tag == 1, HIGH, torch.where(tag == 2, DUPE, tag - 3)),
    ).to(torch.int32)
    pos = torch.where(tag >= 3, _i32(val + pos_bias), torch.where(tag == 2, val, 0))
    return contig, pos.to(torch.int32)


def _row_payload(rows, ki):
    """(..., 2S) [key | payload] rows and int32 keys (...) -> the uint32 sum
    (int64) of the payloads of the slots that hold the key."""
    S = rows.shape[-1] // 2
    pay = torch.where(rows[..., :S] == ki[..., None], rows[..., S:], 0)
    return pay.to(torch.int64).sum(-1) & M32


def kv_lookup(kv_tbl, shift: int, cbits: int, pos_bias: int, kmers, valid):
    """kv rows (S [key | payload] slots per row, S = width // 2): two row
    loads per query. Returns (contig, pos) like hash_lookup; an invalid
    query gives (EMPTY, 0)."""
    ki = _i32(kmers)
    b1, b2 = buckets(kmers, shift)
    # keys are unique, so at most one slot of each row matches with a
    # nonzero payload (empty slots hold an absent key and payload 0)
    pay = (_row_payload(kv_tbl[torch.where(valid, b1, 0)], ki)
           | _row_payload(kv_tbl[torch.where(valid, b2, 0)], ki))
    contig, pos = _decode(pay, cbits, pos_bias)
    return torch.where(valid, contig, EMPTY), torch.where(valid, pos, 0)


def single_probe_lookup(kv_tbl, shift: int, cbits: int, pos_bias: int, kmers, valid):
    """Single-probe rows (kvs, S=4; kv16, S=8; S = width // 2): the h1 row of
    every valid query, and its h2 row only where the h1 row carries the
    overflow marker (slot 2S-1 == OVF_PAYLOAD) and no slot matched with a
    nonzero payload sum. Returns (contig, pos) like kv_lookup; an invalid
    query gives (EMPTY, 0). The absent-key sentinel matches a marked row's
    marker (payload 1), so it loads no h2 row and decodes to EMPTY."""
    ki = _i32(kmers)
    b1, b2 = buckets(kmers, shift)
    r1 = kv_tbl[torch.where(valid, b1, 0)]
    pay = _row_payload(r1, ki)
    need2 = valid & (r1[..., -1] == OVF_PAYLOAD) & (pay == 0)
    pay2 = _row_payload(kv_tbl[torch.where(need2, b2, 0)], ki)
    contig, pos = _decode(pay | torch.where(need2, pay2, 0), cbits, pos_bias)
    return torch.where(valid, contig, EMPTY), torch.where(valid, pos, 0)


def lookup(index: TorchIndex, kmers, valid):
    if index.split:
        return hash_lookup(index.table, index.vals, index.shift, kmers, valid)
    fn = single_probe_lookup if index.single_probe else kv_lookup
    return fn(index.table, index.shift, index.cbits, index.pos_bias, kmers, valid)


def expand_candidates_kv(contig, pos, dupes_packed, max_dupe: int, cbits: int,
                         pos_bias: int):
    """kv layout: (..., ) lookup results -> (..., D) candidate (contig, pos,
    valid); dupe rows hold 8 packed regular-coded payloads."""
    is_reg = contig >= 0
    is_dupe = contig == DUPE
    if max_dupe <= 1 or dupes_packed.shape[0] == 0:
        return (
            torch.where(is_reg, contig, 0)[..., None],
            torch.where(is_reg, pos, 0)[..., None],
            is_reg[..., None],
        )
    drow = dupes_packed[torch.where(is_dupe, pos, 0).to(torch.int64)][..., :max_dupe]
    dc, dp = _decode(drow.to(torch.int64) & M32, cbits, pos_bias)
    dv = is_dupe[..., None] & (dc >= 0)
    cc = torch.where(dv, dc, 0)
    cp = torch.where(dv, dp, 0)
    cc[..., 0] = torch.where(is_reg, contig, cc[..., 0])
    cp[..., 0] = torch.where(is_reg, pos, cp[..., 0])
    dv[..., 0] |= is_reg
    return cc, cp, dv


def expand_candidates(contig, pos, dupes, max_dupe: int):
    """Split layout: dupe rows hold (D, 2) [contig, pos] pairs, EMPTY-padded."""
    is_reg = contig >= 0
    is_dupe = contig == DUPE
    if max_dupe <= 1 or dupes.shape[0] == 0:
        return (
            torch.where(is_reg, contig, 0)[..., None],
            torch.where(is_reg, pos, 0)[..., None],
            is_reg[..., None],
        )
    drow = dupes[torch.where(is_dupe, pos, 0).to(torch.int64)]  # (..., D, 2)
    cc = torch.where(is_dupe[..., None], drow[..., 0], 0)
    cp = torch.where(is_dupe[..., None], drow[..., 1], 0)
    cv = is_dupe[..., None] & (drow[..., 0] != EMPTY)
    cc[..., 0] = torch.where(is_reg, contig, cc[..., 0])
    cp[..., 0] = torch.where(is_reg, pos, cp[..., 0])
    cv[..., 0] |= is_reg
    return cc, cp, cv


def expand(index: TorchIndex, contig, pos):
    if index.split:
        return expand_candidates(contig, pos, index.dupes, index.max_dupe)
    return expand_candidates_kv(
        contig, pos, index.dupes, index.max_dupe, index.cbits, index.pos_bias
    )


def lookup_expand(index: TorchIndex, kmers, valid):
    return expand(index, *lookup(index, kmers, valid))


def top2_votes(keys: torch.Tensor, valid: torch.Tensor):
    """(B, P) gplong candidates -> top-2 (key, count) by the reference's
    (count desc, then smallest key) rule; key 0 is never voted for.
    Returns (g1, c1, g2, c2). With fewer than two voted keys the missing
    entries take count 0 and, as in JAX, the smallest sorted key."""
    B, P = keys.shape
    s = torch.sort(torch.where(valid, keys, INVALID_KEY), dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    idx = torch.arange(P, device=keys.device)
    nxt = torch.where(first, idx, P)
    nxt = torch.cat([nxt[:, 1:], torch.full((B, 1), P, device=keys.device)], 1)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    svalid = (s >> 32) != INT32_MAX
    cand = torch.where(first & svalid & (s != 0), nxt - idx, -1)
    i1 = cand.argmax(1, keepdim=True)
    c1 = cand.gather(1, i1)[:, 0]
    g1 = s.gather(1, i1)[:, 0]
    cand2 = torch.where(idx[None, :] == i1, -1, cand)
    i2 = cand2.argmax(1, keepdim=True)
    c2 = cand2.gather(1, i2)[:, 0]
    g2 = s.gather(1, i2)[:, 0]
    return g1, c1.clamp_min(0), g2, c2.clamp_min(0)


def extract_segments(mask: torch.Tensor, lengths: torch.Tensor, target: int):
    """Chain segments of one target flag -> (valid, start, end) per read:
    positions link when the gap is <= ALLOWED_GAP with no higher flag
    between; a target at the last in-bounds base cannot start a chain; the
    first longest chain wins and counts if longer than THRESHOLD_LEN."""
    B, L = mask.shape
    dev = mask.device
    t_idx = torch.arange(L, device=dev).expand(B, L)
    within = t_idx < lengths[:, None]
    ok = (mask == target) & within
    blocked = (mask > target) & within
    prev_inc = torch.cummax(torch.where(ok, t_idx, -1), dim=1).values
    prev = torch.cat([torch.full((B, 1), -1, device=dev), prev_inc[:, :-1]], 1)
    last_blocked = torch.cummax(torch.where(blocked, t_idx, -1), dim=1).values
    linked = ok & (prev >= 0) & ((t_idx - prev) <= ALLOWED_GAP) & (last_blocked <= prev)
    head = ok & ~linked & (t_idx < lengths[:, None] - 1)
    member = ok & (linked | head)
    hid = torch.cummax(torch.where(head, t_idx, -1), dim=1).values
    BIG = 0x3FFFFFFF
    nm = torch.where(member, hid, BIG)
    nm_inc = torch.flip(torch.cummin(torch.flip(nm, [1]), dim=1).values, [1])
    nm_hid = torch.cat([nm_inc[:, 1:], torch.full((B, 1), BIG, device=dev)], 1)
    chain_end = member & (nm_hid != hid)
    run_len = torch.where(chain_end & (hid >= 0), t_idx - hid, -1)
    best = run_len.argmax(1, keepdim=True)
    best_len = run_len.gather(1, best)[:, 0]
    seg_start = hid.gather(1, best)[:, 0]
    return best_len > THRESHOLD_LEN, seg_start.to(torch.int32), best[:, 0].to(torch.int32)


def probe_plain(codes, lengths, stride: int, index: TorchIndex):
    """Plain twin of the probe kernel: every `stride`-th k-mer of each row,
    looked up -> (B, NQ, 2) int32 [contig, pos]."""
    km, kvalid = compute_kmers(codes, lengths)
    c, p = lookup(index, km[:, ::stride], kvalid[:, ::stride])
    return torch.stack([c, p], dim=-1)


def _keys_at(index: TorchIndex, pr: torch.Tensor, step: int):
    """Probe results (B, NQ, 2) -> candidate keys and validity (B, NQ, D)."""
    cc, cp, cv = expand(index, pr[..., 0], pr[..., 1])
    i = torch.arange(pr.shape[1], device=pr.device)[None, :, None] * step
    return gplong(cc, cp.to(torch.int64) - i), cv


def vote_counts_plain(pr, index: TorchIndex):
    """Plain twin of the vote kernel's counts mode: pass-1 probe results
    (B, NS, 2) -> (B, 6) int32 [c1, h1, l1, c2, h2, l2], no gate."""
    B = pr.shape[0]
    keys, cv = _keys_at(index, pr, PASS1_STEP)
    g1, c1, g2, c2 = top2_votes(keys.reshape(B, -1), cv.reshape(B, -1))
    h1, l1 = _hi_lo(g1)
    h2, l2 = _hi_lo(g2)
    return torch.stack([c1.to(torch.int32), h1, l1, c2.to(torch.int32), h2, l2], dim=1)


def vote_tally(pr, index: TorchIndex, lengths=None):
    """What the vote kernel's row counter adds for a vote of `pr` (B, NS,
    2), as vote() launches it -> (rows voted on the warp path, those of
    them sorted): a row of at most VOTE_WARP_KEYS valid keys is the warp
    path's unless the wide route lists it (more than VOTE_WALK_MAX samples
    inside its length); it is sorted past VOTE_PEEL_KEYS distinct keys."""
    B, NS, _ = pr.shape
    if not B:
        return 0, 0
    keys, cv = _keys_at(index, pr, PASS1_STEP)
    wide = vote_width(NS, index.D) > MAX_VOTE_KEYS
    ns = torch.full((B,), NS, dtype=torch.int64, device=pr.device)
    if wide and lengths is not None:
        ln = lengths.to(torch.int64)
        ns = torch.where(ln < KMER, 0, torch.clamp((ln - KMER) // PASS1_STEP + 1, max=NS))
        cv = cv & (torch.arange(NS, device=pr.device)[None, :, None] < ns[:, None, None])
    keys, cv = keys.reshape(B, -1), cv.reshape(B, -1)
    s = torch.sort(torch.where(cv, keys, INVALID_KEY), dim=1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    # INVALID_KEY stands for the empty slots; a valid slot may hold it too
    distinct = (new & (s != INVALID_KEY)).sum(1) + (cv & (keys == INVALID_KEY)).any(1)
    warp = cv.sum(1) <= VOTE_WARP_KEYS
    if wide:
        warp &= ns <= VOTE_WALK_MAX
    return int(warp.sum()), int((warp & (distinct > VOTE_PEEL_KEYS)).sum())


def _gate(c1, c2, major_req: int, minor_req: int):
    return (c1 * PASS1_STEP >= major_req) & (c2 * PASS1_STEP >= minor_req)


def vote_plain(pr, index: TorchIndex, major_req: int, minor_req: int):
    """Plain twin of the vote kernel: pass-1 probe results (B, NS, 2) ->
    (B, 5) int32 [ok, h1, l1, h2, l2]."""
    v = vote_counts_plain(pr, index)
    ok = _gate(v[:, 0], v[:, 3], major_req, minor_req)
    return torch.cat([ok.to(torch.int32)[:, None], v[:, 1:3], v[:, 4:6]], dim=1)


def merge_top2_plain(votes, major_req: int, minor_req: int):
    """Plain twin of the merge kernel (`_merge_top2` and the gate of the
    JAX sharded map_read): S shards' counts-mode rows, a sequence of (B, 6)
    int32 tensors -> (ok (B,) bool, gp (B, 4) int32 [h1, l1, h2, l2]). A
    row's 2S candidates, [c1 of shards 0..S-1, c2 of shards 0..S-1], sort
    by count descending, then (hi, lo unsigned) ascending; counts <= 0 tie
    with each other after the rest. The sort is stable: JAX's is not, so
    where fewer than two counts are positive the missing entry's (hi, lo)
    may differ from JAX's; the gate fails such a row."""
    votes = torch.stack(list(votes))
    c = torch.cat([votes[:, :, 0], votes[:, :, 3]], 0).T
    h = torch.cat([votes[:, :, 1], votes[:, :, 4]], 0).T
    lo = torch.cat([votes[:, :, 2], votes[:, :, 5]], 0).T
    off = c <= 0
    big = 1 << 32
    order = torch.arange(c.shape[1], device=c.device).expand(c.shape).contiguous()
    # a stable sort a key, the least significant first
    for key in (lo.to(torch.int64) & M32, h.to(torch.int64), -c.to(torch.int64)):
        k = torch.where(off, big, key).gather(1, order)
        order = order.gather(1, torch.sort(k, dim=1, stable=True).indices)
    c, h, lo = (x.gather(1, order[:, :2]) for x in (c, h, lo))
    ok = _gate(c[:, 0].clamp_min(0), c[:, 1].clamp_min(0), major_req, minor_req)
    return ok, torch.stack([h[:, 0], lo[:, 0], h[:, 1], lo[:, 1]], dim=1)


def _pass2_flags(pr, gp, index: TorchIndex):
    """Full-stride probe results (B, NK, 2) and [h1, l1, h2, l2] -> (B, NK)
    flags: 3 on a candidate within +-1 of the top key, else 2 within +-1
    of the second, the max over the dupe slots."""
    keys, cv = _keys_at(index, pr, 1)
    keys = torch.where(cv, keys, 0)
    g1 = gplong(gp[:, 0], gp[:, 1])[:, None, None]
    g2 = gplong(gp[:, 2], gp[:, 3])[:, None, None]
    m1 = cv & ((keys - g1).abs() <= 1)
    m2 = cv & ((keys - g2).abs() <= 1)
    return torch.where(m1, 3, torch.where(m2, 2, 0)).amax(-1)


def _segments_from_flags(flag, lengths, gp, mismatch_thr: int):
    """(B, NK) k-mer flags -> the (B, 10) rows: the 16-wide window into a
    per-base mask, the mismatch count and the segments of targets 3, 2."""
    B, NK = flag.shape
    L = NK + KMER - 1
    pad = torch.zeros((B, KMER - 1), dtype=flag.dtype, device=flag.device)
    padded = torch.cat([pad, flag, pad], 1)
    mask = padded[:, KMER - 1 : KMER - 1 + L]
    for j in range(1, KMER):
        mask = torch.maximum(mask, padded[:, KMER - 1 - j : KMER - 1 - j + L])
    within = torch.arange(L, device=flag.device)[None, :] < lengths[:, None]
    read_ok = ((mask < 2) & within).sum(1) <= mismatch_thr
    v3, s3, e3 = extract_segments(mask, lengths, 3)
    v2, s2, e2 = extract_segments(mask, lengths, 2)
    cols = [v3 & read_ok, v2 & read_ok, s3, s2, e3, e2, gp[:, 0], gp[:, 2], gp[:, 1], gp[:, 3]]
    return torch.stack([c.to(torch.int32) for c in cols], dim=1)


def mask_segments_plain(pr, lengths, gp, index: TorchIndex, mismatch_thr: int):
    """Plain twin of the mask+segments kernel: full-stride probe results
    (B, NK, 2), lengths and the vote's [h1, l1, h2, l2] -> (B, 10) int32
    [valid0, valid1, start0, start1, end0, end1, h1, h2, l1, l2]."""
    return _segments_from_flags(_pass2_flags(pr, gp, index), lengths, gp, mismatch_thr)


def flag_words(NK: int) -> int:
    """Words a row of the pass-2 flag planes holds: one a 32 bases of its
    code row, as the mask kernels' words."""
    return (NK + KMER - 1 + 31) // 32


def shard_flags_plain(pr, gp, index: TorchIndex):
    """Plain twin of the sharded flags kernel: one shard's flags as (B, nw,
    2) int32 words [flag 3, flag >= 2], bit j of word c = k-mer 32c + j."""
    flag = _pass2_flags(pr, gp, index)
    B, NK = flag.shape
    nw = flag_words(NK)
    f = torch.zeros((B, nw * 32), dtype=flag.dtype, device=flag.device)
    f[:, :NK] = flag
    sh = torch.arange(32, device=flag.device)
    planes = [((f == 3).to(torch.int64).view(B, nw, 32) << sh).sum(-1),
              ((f >= 2).to(torch.int64).view(B, nw, 32) << sh).sum(-1)]
    return _i32(torch.stack(planes, dim=-1))


def mask_from_flags_plain(words, lengths, gp, NK: int, mismatch_thr: int):
    """Plain twin of mask+segments from flags: merged flag words (B, nw, 2)
    -> the (B, 10) rows of mask_segments_plain."""
    B = words.shape[0]
    bits = (words.to(torch.int64)[..., None] >> torch.arange(32, device=words.device)) & 1
    f3 = bits[:, :, 0].reshape(B, -1)[:, :NK]
    f2 = bits[:, :, 1].reshape(B, -1)[:, :NK]
    flag = torch.where(f3 != 0, 3, torch.where(f2 != 0, 2, 0))
    return _segments_from_flags(flag, lengths, gp, mismatch_thr)


# ---------------- kernel wrappers ----------------


def _check_index(index: TorchIndex, device) -> None:
    cuda.check_tensor(index.table, "index.table", torch.int32, 2, device)
    cuda.check_tensor(index.vals, "index.vals", torch.int32, 2, device)
    cuda.check_tensor(index.dupes, "index.dupes", torch.int32, 3 if index.split else 2, device)
    if index.split and index.S != 8:
        raise ValueError(f"split keys rows must be 8 slots wide, got {index.S}")
    if index.single_probe and index.S not in (4, 8):
        raise ValueError(f"single-probe rows must hold 4 or 8 slots, got {index.S}")
    if not index.split and not index.single_probe and index.S not in (1, 2, 4):
        raise ValueError(f"kv rows must hold 1, 2 or 4 slots, got {index.S}")


def probe(codes, lengths, stride: int, index: TorchIndex):
    """Kernel 1: build every `stride`-th 16-mer of each (B, W) code row and
    probe the table -> (B, NQ, 2) int32 [contig, pos]. Codes are 0-3, or
    255 for a base that is not ACGT. On kv and split tables the kernel
    loads a k-mer's h2 row only when its key is not in its h1 row (keys
    are unique across both rows, `tests/test_torch_index.py`), which equals
    the plain version's lookup; on single-probe tables (kvs, kv16) its
    variant loads h2 only past a marked h1 row, as single_probe_lookup.
    On the card the kernel reads `codes` in 16-byte chunks, so `codes` must
    start on a 16-byte boundary: a fresh tensor does, a row-offset view
    (`codes[1:]`) may not and is refused."""
    dev = codes.device
    cuda.check_tensor(codes, "codes", torch.uint8, 2, dev)
    cuda.check_tensor(lengths, "lengths", torch.int32, 1, dev)
    _check_index(index, dev)
    B, W = codes.shape
    if W < KMER or lengths.shape[0] != B or stride < 1:
        raise ValueError(f"probe: bad shapes codes={tuple(codes.shape)} "
                         f"lengths={tuple(lengths.shape)} stride={stride}")
    if dev.type == "cpu":
        return probe_plain(codes, lengths, stride, index)
    if codes.data_ptr() % 16:
        raise ValueError("probe: codes must start on a 16-byte boundary on the card "
                         "(pass a fresh tensor, not a row-offset view)")
    NQ = (W - KMER + stride) // stride
    out = torch.empty((B, NQ, 2), dtype=torch.int32, device=dev)
    if B:
        cuda.launch_probe(codes, lengths, None, None, B * NQ, W, stride, NQ, index, out)
    return out


def probe_kmers(kmers, valid, index: TorchIndex):
    """Kernel 1 over flat queries (the `pallas_lookup` signature): (N,)
    int32 k-mer bit patterns + (N,) bool validity -> (N, 2) int32."""
    dev = kmers.device
    cuda.check_tensor(kmers, "kmers", torch.int32, 1, dev)
    cuda.check_tensor(valid, "valid", torch.bool, 1, dev)
    _check_index(index, dev)
    if valid.shape != kmers.shape:
        raise ValueError("probe_kmers: kmers and valid differ in shape")
    if dev.type == "cpu":
        c, p = lookup(index, kmers.to(torch.int64) & M32, valid)
        return torch.stack([c, p], dim=-1)
    N = kmers.shape[0]
    out = torch.empty((N, 2), dtype=torch.int32, device=dev)
    if N:
        cuda.launch_probe(None, None, kmers, valid, N, 0, 1, 1, index, out)
    return out


def vote_width(NS: int, D: int) -> int:
    """Key buffer of the vote kernel's block-wide path: NS*D keys rounded
    up to a power of 2."""
    return 1 << max(0, NS * D - 1).bit_length()


def vote_candidates(pr, index: TorchIndex) -> torch.Tensor:
    """(B, NS, 2) pass-1 probe results -> (B,) int64: the valid candidates
    of each row, the keys the vote counts. Rows of more than
    VOTE_WARP_KEYS take the vote kernel's block-wide path."""
    return expand(index, pr[..., 0], pr[..., 1])[2].sum((1, 2))


def _smem_cap(smem_cap, least: int) -> int:
    cap = WIDE_SMEM_BYTES if smem_cap is None else smem_cap
    if not least <= cap <= WIDE_SMEM_BYTES:
        raise ValueError(f"smem_cap must lie in [{least}, {WIDE_SMEM_BYTES}], got {cap}")
    return cap


def _check_vote(pr, index: TorchIndex, lengths, dev) -> None:
    """The vote's probe results (B, NS, 2) and their lengths, on `dev`."""
    cuda.check_tensor(pr, "probe results", torch.int32, 3, dev)
    _check_index(index, dev)
    if pr.shape[2] != 2:
        raise ValueError(f"vote: probe results must be (B, NS, 2), got {tuple(pr.shape)}")
    if lengths is not None:
        cuda.check_tensor(lengths, "lengths", torch.int32, 1, dev)
        if lengths.shape[0] != pr.shape[0]:
            raise ValueError(f"vote: {lengths.shape[0]} lengths for {pr.shape[0]} rows")


def vote(pr, index: TorchIndex, major_req: int, minor_req: int, lengths=None,
         smem_cap=None, out=None, stats=None):
    """Kernel 2: pass-1 probe results (B, NS, 2) -> (B, 5) int32
    [ok, h1, l1, h2, l2]. One warp counts one row's valid candidates, a
    distinct key at a time, or past VOTE_PEEL_KEYS of them sorts them; a
    row of more than VOTE_WARP_KEYS goes to the block. When
    the rows are too wide for the block's keys to fit in shared memory
    (vote_width past MAX_VOTE_KEYS), those rows are listed instead, and a
    second launch gives each a 1,024-thread block that counts its valid
    keys and sorts just those in shared memory; a row of more than
    `smem_cap` bytes of keys (8 a key) is listed again, and a third launch
    sorts it in global scratch sized by the counts. `lengths`: the (B,)
    int32 lengths of the code rows `pr` was probed from; given, the wide
    path walks a row's samples only up to its length (the probe makes
    every later one a miss, so the result is the same). `out`: None, or
    a contiguous (B, 5) int32 tensor (rows of a larger buffer) that the
    rows are written into and that is returned. `stats`: None, or a
    (VOTE_STAT_SLOTS,) int64 row counter that the call adds vote_tally's
    (rows, sorted) to as rows + (sorted << 32), spread over its slots."""
    dev = pr.device
    _check_vote(pr, index, lengths, dev)
    B, NS, _ = pr.shape
    keys_cap = _smem_cap(smem_cap, 8) // 8
    if out is not None:
        cuda.check_tensor(out, "out", torch.int32, 2, dev)
        if out.shape != (B, 5):
            raise ValueError(f"vote: out must be ({B}, 5), got {tuple(out.shape)}")
    if stats is not None:
        cuda.check_tensor(stats, "stats", torch.int64, 1, dev)
        if stats.shape != (VOTE_STAT_SLOTS,):
            raise ValueError(f"vote: stats must be ({VOTE_STAT_SLOTS},), got {tuple(stats.shape)}")
    if dev.type == "cpu":
        res = vote_plain(pr, index, major_req, minor_req)
        if stats is not None:
            rows, sorted_ = vote_tally(pr, index, lengths)
            stats[0] += rows + (sorted_ << 32)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((B, 5), dtype=torch.int32, device=dev)
    if not B:
        return out
    P2 = vote_width(NS, index.D)
    if P2 <= MAX_VOTE_KEYS:
        cuda.launch_vote(pr, B, NS, index, PASS1_STEP, major_req, minor_req, P2, out,
                         stats=stats)
        return out
    wide = torch.zeros(3 + 3 * B, dtype=torch.int64, device=dev)
    args = (pr, B, NS, index, PASS1_STEP, major_req, minor_req)
    cuda.launch_vote(*args, P2, out, wide=wide, lengths=lengths, stats=stats)
    cuda.launch_vote_wide(*args, wide, lengths, keys_cap, out)
    # the keys of the rows past shared memory, counted by that launch:
    # reading them waits for it, so only where a row can have that many
    over = int(wide[1]) if NS * index.D > keys_cap else 0
    if over:
        scratch = torch.empty(over, dtype=torch.int64, device=dev)
        cuda.launch_vote_wide(*args, wide, lengths, keys_cap, out, scratch)
    return out


def vote_counts(pr, index: TorchIndex, lengths=None, smem_cap=None):
    """The vote's counts mode: (B, NS, 2) -> (B, 6) int32 [c1, h1, l1, c2,
    h2, l2], the top-2 keys with their counts and no gate;
    vote_counts_shards of the one table; `lengths` and `smem_cap` as
    vote's."""
    return vote_counts_shards([pr], [index], lengths, smem_cap)[0]


def _keys_past_smem(wides) -> list:
    """The keys that rows of the shards' wide launches counted past shared
    memory, one entry a wide list: one device read for all of them (it
    waits for their launches)."""
    return torch.stack([w[1] for w in wides]).tolist()


def vote_counts_shards(prs, indexes, lengths=None, smem_cap=None):
    """vote_counts of S shards whose pass-1 results `prs` (each (B, NS, 2),
    one a shard of `indexes`, all on one device, one table layout) ->
    (S, B, 6) int32, row s the counts-mode vote of prs[s] on indexes[s].
    On the card one launch votes up to MAX_SHARDS shards (a warp a row of a
    shard); rows too wide for the block path's shared memory are listed
    for all the shards together, one wide launch takes them, and the count
    of keys past `smem_cap` is one device read for the call. `lengths`:
    the rows' (B,) lengths, or None; given, a row's samples past it are not
    read (the probe makes them misses, so the rows are the same)."""
    S = len(prs)
    if S < 1 or len(indexes) != S:
        raise ValueError(f"vote_counts_shards: a table for each of the shards, got {S} "
                         f"results and {len(indexes)} tables")
    dev = prs[0].device
    for pr, index in zip(prs, indexes):
        _check_vote(pr, index, lengths, dev)
        if pr.shape != prs[0].shape:
            raise ValueError("vote_counts_shards: the shards' probe results differ in shape")
    if len({ix.split for ix in indexes}) != 1:
        raise ValueError("vote_counts_shards: the shards share one table layout")
    B, NS, _ = prs[0].shape
    keys_cap = _smem_cap(smem_cap, 8) // 8
    if dev.type == "cpu":
        return torch.stack([vote_counts_plain(pr, index) for pr, index in zip(prs, indexes)])
    out = torch.empty((S, B, 6), dtype=torch.int32, device=dev)
    if not B:
        return out
    P2 = max(vote_width(NS, ix.D) for ix in indexes)
    groups = [range(a, min(S, a + MAX_SHARDS)) for a in range(0, S, MAX_SHARDS)]
    launches = []
    for g in groups:
        args = ([prs[s] for s in g], [indexes[s] for s in g], B, NS, PASS1_STEP)
        o = out[g.start : g.stop]
        if P2 <= MAX_VOTE_KEYS:
            cuda.launch_vote_shards(*args, P2, o, None, lengths)
            continue
        wide = torch.zeros(3 + 3 * len(g) * B, dtype=torch.int64, device=dev)
        cuda.launch_vote_shards(*args, P2, o, wide, lengths)
        cuda.launch_vote_shards_wide(*args, wide, lengths, keys_cap, o)
        launches.append((args, o, wide))
    # only where a row can have more keys than shared memory holds
    if not launches or NS * max(ix.D for ix in indexes) <= keys_cap:
        return out
    for (args, o, wide), over in zip(launches, _keys_past_smem([w for _, _, w in launches])):
        if over:
            scratch = torch.empty(over, dtype=torch.int64, device=dev)
            cuda.launch_vote_shards_wide(*args, wide, lengths, keys_cap, o, scratch)
    return out


def merge_top2(votes, major_req: int, minor_req: int):
    """The shards' counts-mode rows, a sequence of S (B, 6) int32 tensors on
    one device (each as the vote wrote it) -> (ok (B,) bool, gp (B, 4)
    int32 [h1, l1, h2, l2]): the gate and the global top two, what pass 2
    takes (merge_top2_plain has the order). On the card one launch reads
    the shards' rows where they lie (their pointers by value), a thread a
    row, and writes both outputs."""
    votes = list(votes)
    if not 1 <= len(votes) <= MAX_SHARDS:
        raise ValueError(f"merge_top2: 1 to {MAX_SHARDS} shards, got {len(votes)}")
    dev = votes[0].device
    for v in votes:
        cuda.check_tensor(v, "votes", torch.int32, 2, dev)
        if v.shape != (votes[0].shape[0], 6):
            raise ValueError(f"merge_top2: (B, 6) rows a shard, got "
                             f"{[tuple(x.shape) for x in votes]}")
    if dev.type == "cpu":
        return merge_top2_plain(votes, major_req, minor_req)
    B = votes[0].shape[0]
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    gp = torch.empty((B, 4), dtype=torch.int32, device=dev)
    if B:
        cuda.launch_merge_top2(votes, PASS1_STEP, major_req, minor_req, gp, ok)
    return ok, gp


def _mask_scratch(B: int, NK: int, dev, smem_cap: int):
    """The wide launch's global words: None for rows of at most
    MASK_MAX_WIDTH, or where a long row's 16 bytes a word fit in the
    block's shared memory (max(smem_cap, MASK_SLICE_BYTES)); else a slice
    of 4 words a word for each block of MASK_WIDE_WARPS rows."""
    nw = flag_words(NK)
    if NK + KMER - 1 <= MASK_MAX_WIDTH or 16 * nw <= max(smem_cap, MASK_SLICE_BYTES):
        return None
    return torch.empty(-(-B // MASK_WIDE_WARPS) * 4 * nw, dtype=torch.int32, device=dev)


def mask_segments(pr, lengths, gp, index: TorchIndex, mismatch_thr: int, smem_cap=None):
    """Kernel 3: pass-2 probe results (B, NK, 2), lengths and the vote's
    (B, 4) [h1, l1, h2, l2] -> (B, 10) int32 segment rows. One warp
    works one row; rows wider than MASK_MAX_WIDTH bases take the wide
    path (64-bit chain keys): each row's loops stop at its own length, and
    a row past 2,048 bases gets its block, its words in shared memory
    (global scratch past `smem_cap` bytes)."""
    dev = pr.device
    cuda.check_tensor(pr, "probe results", torch.int32, 3, dev)
    cuda.check_tensor(lengths, "lengths", torch.int32, 1, dev)
    cuda.check_tensor(gp, "gp", torch.int32, 2, dev)
    _check_index(index, dev)
    B, NK, two = pr.shape
    if two != 2 or lengths.shape[0] != B or tuple(gp.shape) != (B, 4):
        raise ValueError("mask_segments: bad shapes")
    cap = _smem_cap(smem_cap, 0)
    if dev.type == "cpu":
        return mask_segments_plain(pr, lengths, gp, index, mismatch_thr)
    out = torch.empty((B, 10), dtype=torch.int32, device=dev)
    if B:
        cuda.launch_mask_segments(pr, lengths, gp, B, NK, index, mismatch_thr, out,
                                  _mask_scratch(B, NK, dev, cap), cap)
    return out


def shard_flags(prs, lengths, gp, indexes, words=None):
    """The pass-2 flags of shards whose stride-1 probe results `prs` (each
    (B, NK, 2), one a shard of `indexes`, all on one device) ORed over the
    shards -> words (B, flag_words(NK), 2) int32 [flag 3, flag >= 2], bit
    j of word c = k-mer 32c + j. lengths: the rows' (B,) lengths; gp: the
    merged (B, 4) [h1, l1, h2, l2]. One launch: a warp a row (and span of
    32 words) ORs the shards' ballots in its registers and writes each word
    once. `words` None: a new tensor, every word stored; else the flags are
    ORed into `words` in place (a later group of the same rows' shards). A
    row's k-mers from its length - 15 on are not read: the probe makes
    each of them EMPTY, which flags nothing, so the words equal
    shard_flags_plain's OR over the shards on probe results."""
    S = len(prs)
    if not 1 <= S <= MAX_FLAG_SHARDS or len(indexes) != S:
        raise ValueError(f"shard_flags: 1 to {MAX_FLAG_SHARDS} shards with a table each, "
                         f"got {S} results and {len(indexes)} tables")
    dev = prs[0].device
    B, NK, two = prs[0].shape
    for pr, index in zip(prs, indexes):
        cuda.check_tensor(pr, "probe results", torch.int32, 3, dev)
        _check_index(index, dev)
        if pr.shape != prs[0].shape:
            raise ValueError("shard_flags: the shards' probe results differ in shape")
    cuda.check_tensor(lengths, "lengths", torch.int32, 1, dev)
    cuda.check_tensor(gp, "gp", torch.int32, 2, dev)
    if words is not None:
        cuda.check_tensor(words, "words", torch.int32, 3, dev)
    if (two != 2 or lengths.shape[0] != B or tuple(gp.shape) != (B, 4)
            or (words is not None and tuple(words.shape) != (B, flag_words(NK), 2))):
        raise ValueError("shard_flags: bad shapes")
    if len({ix.split for ix in indexes}) != 1:
        raise ValueError("shard_flags: the shards of a launch share one table layout")
    if dev.type == "cpu":
        out = shard_flags_plain(prs[0], gp, indexes[0])
        for pr, index in zip(prs[1:], indexes[1:]):
            out |= shard_flags_plain(pr, gp, index)
        return out if words is None else words.bitwise_or_(out)
    out = torch.empty((B, flag_words(NK), 2), dtype=torch.int32, device=dev) \
        if words is None else words
    if B:
        cuda.launch_shard_flags(prs, indexes, lengths, gp, NK, out, words is not None)
    return out


def mask_from_flags(words, lengths, gp, NK: int, mismatch_thr: int, smem_cap=None):
    """Mask+segments from merged flag words (B, flag_words(NK), 2) -> the
    (B, 10) rows of mask_segments; wide rows and `smem_cap` as there. On
    the narrow launch a row takes a segment of 8, 16 or 32 lanes (the
    least that holds flag_words(NK) words; 4, 2 or 1 rows a warp), a word
    a lane, and stops at its own last word."""
    dev = words.device
    cuda.check_tensor(words, "words", torch.int32, 3, dev)
    cuda.check_tensor(lengths, "lengths", torch.int32, 1, dev)
    cuda.check_tensor(gp, "gp", torch.int32, 2, dev)
    B = words.shape[0]
    if (NK < 1 or tuple(words.shape) != (B, flag_words(NK), 2) or lengths.shape[0] != B
            or tuple(gp.shape) != (B, 4)):
        raise ValueError("mask_from_flags: bad shapes")
    cap = _smem_cap(smem_cap, 0)
    if dev.type == "cpu":
        return mask_from_flags_plain(words, lengths, gp, NK, mismatch_thr)
    out = torch.empty((B, 10), dtype=torch.int32, device=dev)
    if B:
        cuda.launch_mask_from_flags(words, lengths, gp, B, NK, mismatch_thr, out,
                                    _mask_scratch(B, NK, dev, cap), cap)
    return out


# ---------------- the two passes ----------------


def map_read_pass1(codes, lengths, index: TorchIndex, major_req: int = 40,
                   minor_req: int = 20):
    """Vote phase: stride-2 lookups, top-2 selection, threshold gate ->
    (pass1_ok, h1, l1, h2, l2)."""
    v = vote(probe(codes, lengths, PASS1_STEP, index), index, major_req, minor_req, lengths)
    return v[:, 0] != 0, v[:, 1], v[:, 2], v[:, 3], v[:, 4]


def map_read_pass2(codes, lengths, h1, l1, h2, l2, index: TorchIndex,
                   mismatch_thr: int = 10) -> MapReadResult:
    """Mask + segment phase for reads that passed the vote gate."""
    gp = torch.stack([h1, l1, h2, l2], dim=1).to(torch.int32).contiguous()
    r = mask_segments(probe(codes, lengths, 1, index), lengths, gp, index, mismatch_thr)
    return MapReadResult(r[:, 0:2] != 0, r[:, 2:4], r[:, 4:6], r[:, 6:8], r[:, 8:10])


def map_read_batch(codes, lengths, index: TorchIndex, major_req: int = 40,
                   minor_req: int = 20, mismatch_thr: int = 10) -> MapReadResult:
    """Both passes over every row; a segment is valid only if its read
    passed the vote gate."""
    ok, h1, l1, h2, l2 = map_read_pass1(codes, lengths, index, major_req, minor_req)
    r = map_read_pass2(codes, lengths, h1, l1, h2, l2, index, mismatch_thr)
    return r._replace(seg_valid=r.seg_valid & ok[:, None])
