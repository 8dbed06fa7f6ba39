"""The whole per-batch scan: port of `ops/fused.py::fused_scan_lanes`.

Per code lane: unpack the 2-bit rows, set the exception positions to 255,
probe every second k-mer (kernel 1) and vote (kernel 2). Then compact the
vote-gate survivors in row order, gather their code rows, probe their
full-stride k-mers (kernel 1) and extract their segments (kernel 3). None
of it waits for the device: the only host reads of a batch are its
(cap + 1, 13) result and, on survivor-cap overflow, the bitmap.

The glue between the passes has hand-written CUDA kernels
(csrc/fused_glue.cu), reached through wrappers that launch them for CUDA
tensors and run the plain versions beside them for CPU tensors:

  lanes_codes    every lane's unpack_seq2 + the exception scatter, one
                 launch of each for up to cuda.MAX_LANES lanes
                 (lanes_unpack_kernel, then lane_exceptions_kernel);
                 lane_codes is its one-lane case
  compact        stable survivor compaction and okwords, over tiles of
                 rows spread across the card: a count launch (the bitmap
                 and each tile's survivors), then a place launch that also
                 copies the placed rows' codes, 255-padded, from up to
                 cuda.MAX_LANES lanes (compact_count_kernel,
                 compact_place_kernel)
  survivor_rows  the placed rows' codes from further lanes, 255-padded
                 (survivor_rows_kernel)

The JAX package's device-side pair merge is here too, beside the main
path (TorchEngine merges on the host, as the JAX TpuEngine does): the
upload of 4-bit codes and 2-bit quality classes ([s1p | q1p | s2p | q2p]
a row, `native.pack_pe_batch`) merged on the card, its three map-code
lanes voted on, and the vote and pass-2 passes over rows gathered from
the merged codes or the upload. Two kernels of csrc/merge.cu carry it,
each with a plain version beside it:

  merge_packed   unpack, RC of R2, the merge on codes and classes, and the
                 three map-code lanes with their lengths (merge_codes_kernel)
  merge_rows     rows of the merged codes or of the upload's R1/R2, padded
                 with 15 and mapped to codes (merge_rows_kernel)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MIN_OVERLAP, PASS1_STEP
from . import cuda
from .index import TorchIndex
from .map_read import VOTE_STAT_SLOTS, mask_segments, probe, vote
from .merge import MERGE_MAX_L, low_qual_classes, overlap_scan
from .pack import COMP4, MAP_FROM_SEQ4, lut, unpack_q2, unpack_seq2, unpack_seq4

OUT_COLS = 13


def lane_codes_plain(buf, W: int, exc, off: int) -> torch.Tensor:
    """Unpacked (P, W) codes of one lane with its exceptions set to 255
    (lane_exceptions_plain)."""
    return lane_exceptions_plain(unpack_seq2(buf, W), exc, off)


def lanes_codes_plain(bufs, widths, exc, off: int = 0) -> list:
    """lane_codes_plain of each lane, the lanes' rows concatenated from
    row `off` on."""
    out = []
    for buf, W in zip(bufs, widths):
        out.append(lane_codes_plain(buf, W, exc, off))
        off += buf.shape[0]
    return out


def lane_exceptions_plain(codes, exc, off: int) -> torch.Tensor:
    """A copy of one lane's (P, W) codes with its exceptions set to 255.
    An entry of exc (E, 2) [row, col] counts when its row lies in the lane
    ([off, off + P)) and its column in [-W, W): a negative column is taken
    from the row's end (W + col), as JAX's `.at[].set(mode="drop")` does;
    every other entry is dropped."""
    P, W = codes.shape
    flat = torch.empty(P * W + 1, dtype=torch.uint8, device=codes.device)
    flat[: P * W].view(P, W).copy_(codes)
    erow = exc[:, 0].to(torch.int64)
    ecol = exc[:, 1].to(torch.int64)
    col = torch.where(ecol < 0, ecol + W, ecol)
    inside = (erow >= off) & (erow < off + P) & (col >= 0) & (col < W)
    dest = torch.where(inside, (erow - off) * W + col, P * W)
    flat.index_fill_(0, dest, 255)
    return flat[: P * W].view(P, W)


def compact_plain(v, lens, cap: int, stats=None):
    """The concatenated vote rows v (N, 5) [ok, h1, l1, h2, l2] and lens
    (N,) -> (out, slens, gp, okwords):

      out      (cap + 1, 13) int32 zeros but for [sidx, svalid] in rows
               [0, c), c = min(cap, N), the survivor count at [cap, 0]
               and, given the vote's row counter `stats`, its rows voted
               and rows sorted at [cap, 1:3];
               sidx: the survivors in row order, then the other rows in
               row order (the stable argsort of where(ok, i, N + i));
      slens    (c,) int32, the rows' lengths, 0 where not a survivor;
      gp       (c, 4) int32, v[sidx, 1:5];
      okwords  (ceil(N/32),) int32, bit k of word w = row 32w + k, as the
               int32 bit pattern of a uint32 OR.
    """
    dev = v.device
    N = v.shape[0]
    ok = v[:, 0] != 0
    iota = torch.arange(N, device=dev)
    order = torch.argsort(torch.where(ok, iota, N + iota))
    c = min(cap, N)
    sidx = order[:c]
    svalid = ok[sidx]
    slens = torch.where(svalid, lens[sidx], 0).to(torch.int32)
    gp = v[sidx, 1:5].contiguous()
    out = torch.zeros((cap + 1, OUT_COLS), dtype=torch.int32, device=dev)
    out[:c, 0] = sidx.to(torch.int32)
    out[:c, 1] = svalid.to(torch.int32)
    out[cap, 0] = ok.sum().to(torch.int32)
    if stats is not None:
        t = int(stats.sum())
        out[cap, 1:3] = torch.tensor([t & 0xFFFFFFFF, t >> 32], dtype=torch.int32)
    return out, slens, gp, _okwords(ok)


def _okwords(ok) -> torch.Tensor:
    N = ok.shape[0]
    nw = (N + 31) // 32
    bits = torch.zeros(nw * 32, dtype=torch.int64, device=ok.device)
    bits[:N] = ok.to(torch.int64)
    words = (bits.view(nw, 32) << torch.arange(32, device=ok.device)).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def compact_count_plain(v, tile: int):
    """What compaction's count step gives: (okwords, as compact_plain's;
    tile_cnt (ceil(N / tile),) int32, the survivors of each tile of rows)."""
    N = v.shape[0]
    ok = v[:, 0] != 0
    nt = -(-N // tile)
    pad = torch.zeros(nt * tile, dtype=torch.int32, device=v.device)
    pad[:N] = ok.to(torch.int32)
    return _okwords(ok), pad.view(nt, tile).sum(1, dtype=torch.int32)


def survivor_rows_plain(lanes, sidx, Wmax: int) -> torch.Tensor:
    """The code rows sidx (c,) of the concatenated lanes (P_i, W_i) uint8,
    each padded with 255 to Wmax -> (c, Wmax) uint8."""
    N = sum(t.shape[0] for t in lanes)
    allcodes = torch.full((N, Wmax), 255, dtype=torch.uint8, device=sidx.device)
    off = 0
    for ci in lanes:
        allcodes[off : off + ci.shape[0], : ci.shape[1]] = ci
        off += ci.shape[0]
    return allcodes[sidx.to(torch.int64)]


# ---------------- kernel wrappers ----------------


def lanes_codes(bufs, widths, exc, off: int = 0) -> list:
    """lanes_codes_plain's (P_i, W_i) codes. On the card they are views of
    one fresh buffer, each at a 16-byte-aligned offset (the probe reads
    them in 16-byte chunks); for every cuda.MAX_LANES lanes one launch
    unpacks them (a 32-bit load and a 16-byte store a chunk where W_i % 16
    == 0) and one more sets their exceptions."""
    dev = exc.device
    cuda.check_tensor(exc, "exc", torch.int32, 2, dev)
    if exc.shape[1] != 2 or len(bufs) != len(widths):
        raise ValueError(f"lanes_codes: exc={tuple(exc.shape)}, {len(bufs)} lanes, "
                         f"{len(widths)} widths")
    for buf, W in zip(bufs, widths):
        cuda.check_tensor(buf, "buf", torch.uint8, 2, dev)
        if W < 1 or 4 * buf.shape[1] < W:
            raise ValueError(f"lanes_codes: {buf.shape[1]} packed bytes a row cannot hold "
                             f"width {W}")
    if dev.type == "cpu":
        return lanes_codes_plain(bufs, widths, exc, off)
    starts, offs, at, row = [], [], 0, off
    for buf, W in zip(bufs, widths):
        starts.append(at)
        offs.append(row)
        at += -(-buf.shape[0] * W // 16) * 16
        row += buf.shape[0]
    flat = torch.empty(at, dtype=torch.uint8, device=dev)
    outs = [flat[s : s + b.shape[0] * W].view(b.shape[0], W)
            for s, b, W in zip(starts, bufs, widths)]
    for g in range(0, len(bufs), cuda.MAX_LANES):
        group = slice(g, g + cuda.MAX_LANES)
        if not any(o.numel() for o in outs[group]):
            continue
        args = (bufs[group], widths[group], offs[group], outs[group])
        cuda.launch_lanes_unpack(*args)
        if exc.shape[0]:
            cuda.launch_lane_exceptions(*args, exc)
    return outs


def lane_codes(buf, W: int, exc, off: int) -> torch.Tensor:
    """lane_codes_plain's (P, W) codes: lanes_codes of one lane."""
    return lanes_codes([buf], [W], exc, off)[0]


def compact(v, lens, cap: int, lanes=None, Wmax: int = 0, stats=None):
    """compact_plain's (out, slens, gp, okwords), and given the code
    `lanes` (P_i, W_i) uint8 whose rows are v's, survivor_rows_plain's
    (c, Wmax) rows of out[:c, 0] as a fifth output; `stats`: None, or the
    vote's row counter (map_read.vote), for out[cap, 1:3]. On the card, over tiles
    of cuda.compact_tile() rows, a block a tile: the count launch ballots
    the gate bits 32 rows a word (okwords) and counts each tile's
    survivors; the place launch gives row i the slot pre(i) (the survivors
    before it) if it survives, else S + i - pre(i), writes the rows whose
    slot is below min(cap, N) with their codes from the first
    cuda.MAX_LANES lanes, and writes `out` whole, its zeros too. The codes
    of each further cuda.MAX_LANES lanes take a survivor_rows launch."""
    dev = v.device
    cuda.check_tensor(v, "votes", torch.int32, 2, dev)
    cuda.check_tensor(lens, "lens", torch.int32, 1, dev)
    N = v.shape[0]
    if (v.shape[1] != 5 or lens.shape[0] != N or N >= 1 << 30
            or not 0 <= cap < (1 << 31) // OUT_COLS - 1):
        raise ValueError(f"compact: bad shapes v={tuple(v.shape)} lens={tuple(lens.shape)} "
                         f"cap={cap}")
    if lanes is not None:
        _check_lanes(lanes, dev, Wmax, "compact")
        held = sum(t.shape[0] for t in lanes)
        if held != N:
            raise ValueError(f"compact: the lanes hold {held} rows, v {N}")
    if dev.type == "cpu":
        res = compact_plain(v, lens, cap, stats)
        if lanes is None:
            return res
        return (*res, survivor_rows_plain(lanes, res[0][: res[1].shape[0], 0], Wmax))
    c = min(cap, N)
    out = torch.empty((cap + 1, OUT_COLS), dtype=torch.int32, device=dev)
    slens = torch.empty(c, dtype=torch.int32, device=dev)
    gp = torch.empty((c, 4), dtype=torch.int32, device=dev)
    okwords = torch.empty((N + 31) // 32, dtype=torch.int32, device=dev)
    tile_cnt = torch.empty(-(-N // cuda.compact_tile()), dtype=torch.int32, device=dev)
    if N:
        cuda.launch_compact_count(v, okwords, tile_cnt)
    if lanes is None:
        cuda.launch_compact_place(v, lens, cap, okwords, tile_cnt, out, slens, gp, stats=stats)
        return out, slens, gp, okwords
    rows = torch.empty((c, Wmax), dtype=torch.uint8, device=dev)
    offs = _lane_offsets(lanes)
    first = slice(0, cuda.MAX_LANES)
    cuda.launch_compact_place(v, lens, cap, okwords, tile_cnt, out, slens, gp, lanes[first],
                              offs[first], rows, stats=stats)
    for g in range(cuda.MAX_LANES, len(lanes) if c else 0, cuda.MAX_LANES):
        group = slice(g, g + cuda.MAX_LANES)
        cuda.launch_survivor_rows(lanes[group], offs[group], out[:c, 0], rows)
    return out, slens, gp, okwords, rows


def _check_lanes(lanes, dev, Wmax: int, name: str) -> None:
    for t in lanes:
        cuda.check_tensor(t, "lane codes", torch.uint8, 2, dev)
    if not lanes or max(t.shape[1] for t in lanes) > Wmax:
        raise ValueError(f"{name}: lanes wider than Wmax {Wmax}")


def _lane_offsets(lanes) -> list:
    """Each lane's first row in the lanes' concatenated row space."""
    offs, at = [], 0
    for t in lanes:
        offs.append(at)
        at += t.shape[0]
    return offs


def survivor_rows(lanes, sidx, Wmax: int) -> torch.Tensor:
    """survivor_rows_plain's (c, Wmax) rows. sidx may be a strided view
    (a column of compact's `out`). On the card the rows are copied from
    the lanes into a fresh tensor, at most cuda.MAX_LANES lanes a launch
    (the scan's own rows come from compact's place launch; this is its
    launch for lanes past those)."""
    dev = sidx.device
    if sidx.dtype != torch.int32 or sidx.dim() != 1:
        raise ValueError(f"survivor_rows: sidx must be 1-D int32, got {sidx.dim()}-D "
                         f"{sidx.dtype}")
    _check_lanes(lanes, dev, Wmax, "survivor_rows")
    if dev.type == "cpu":
        return survivor_rows_plain(lanes, sidx, Wmax)
    c = sidx.shape[0]
    out = torch.empty((c, Wmax), dtype=torch.uint8, device=dev)
    offs = _lane_offsets(lanes)
    for g in range(0, len(lanes) if c else 0, cuda.MAX_LANES):
        cuda.launch_survivor_rows(lanes[g : g + cuda.MAX_LANES],
                                  offs[g : g + cuda.MAX_LANES], sidx, out)
    return out


def fused_scan_lanes(bufs, lens_t, exc, index: TorchIndex, *, widths, cap: int,
                     major_req: int = 40, minor_req: int = 20,
                     mismatch_thr: int = 10):
    """Scan any number of width-bucketed lanes in one call.

    bufs: (P_i, ceil(widths[i]/4)) uint8 2-bit rows; lens_t: the rows'
    int32 lengths, one (sum P_i,) tensor in row order (JAX takes a tensor
    a lane; here each lane's are a view of it); exc: (E, 2) int32 [row,
    col] of non-ACGT bases in the concatenated row space (pad entries
    point out of bounds and are dropped; a column in [-W_i, -1] counts
    from the row's end, as in JAX).

    Each lane's vote writes its rows of one (N, 5) buffer, so the
    compaction reads the votes and lengths where they lie; its place
    launch copies the survivors' code rows. The votes add to one row
    counter, which the place launch writes into the count row.

    Returns (out, okwords):
      out      (cap + 1, 13) int32 — per survivor [sidx, svalid, valid0,
               valid1, start0, start1, end0, end1, contig0, contig1, pos0,
               pos1, 0]; the LAST row is [n_survivors, rows voted on the
               vote's warp path, rows of them sorted (past VOTE_PEEL_KEYS
               distinct keys), 0, ...] (the JAX package's holds zeros past
               n_survivors).
      okwords  (ceil(N/32),) int32 — the vote-gate bitmap, bit k of word w
               = row 32w + k, as the int32 bit pattern of a uint32 OR.
    """
    rows = [b.shape[0] for b in bufs]
    if not isinstance(lens_t, torch.Tensor) or lens_t.shape != (sum(rows),):
        raise ValueError(f"fused_scan_lanes: lens_t must be one ({sum(rows)},) tensor")
    codes_l = lanes_codes(bufs, widths, exc)
    votes = torch.empty((lens_t.shape[0], 5), dtype=torch.int32, device=exc.device)
    stats = torch.zeros(VOTE_STAT_SLOTS, dtype=torch.int64, device=exc.device)
    at = 0
    for ci, ln in zip(codes_l, torch.split(lens_t, rows)):
        vote(probe(ci, ln, PASS1_STEP, index), index, major_req, minor_req, ln,
             out=votes[at : at + ci.shape[0]], stats=stats)
        at += ci.shape[0]
    out, slens, gp, okwords, scodes = compact(votes, lens_t, cap, codes_l, max(widths), stats)
    c = slens.shape[0]
    out[:c, 2:12] = mask_segments(probe(scodes, slens, 1, index), slens, gp, index,
                                  mismatch_thr)
    return out, okwords


# ---------------- the device-side pair merge ----------------


class FusedPass1Result(NamedTuple):
    merged: torch.Tensor  # (B,) bool
    diff: torch.Tensor  # (B,) int32
    m_len: torch.Tensor  # (B,) int32
    merged_codes: torch.Tensor  # (B, 2L) uint8 4-bit codes, left on the device
    ok_m: torch.Tensor  # (B,) bool       pass-1 gate, merged lane
    gp_m: torch.Tensor  # (B, 4) int32    h1, l1, h2, l2
    ok_1: torch.Tensor
    gp_1: torch.Tensor
    ok_2: torch.Tensor
    gp_2: torch.Tensor


# summary layout (one host fetch): columns of the (B, 18) int32 array
# [0]=merged [1]=diff [2]=m_len [3]=ok_m [4:8]=gp_m [8]=ok_1 [9:13]=gp_1
# [13]=ok_2 [14:18]=gp_2
SUMMARY_COLS = 18


def merge_codes(s1, qc1, l1, rc2f, qc2f, l2, L: int):
    """The merge on 4-bit codes and quality classes (JAX `_merge_codes`):
    s1/qc1 (B, L) R1 codes and classes, rc2f/qc2f (B, L) RC(R2) reversed
    over the full width L (the read right-aligned at L - l2) ->
    (merged (B,) bool, diff (B,) int32, m_len (B,) int32, m_codes (B, 2L)
    uint8, 15 past the merged read and in rows that do not merge). In the
    overlap the merged base is R1's only where R1 is high (class 2) and
    R2 low (class 0) and they differ."""
    B = s1.shape[0]
    dev = s1.device
    i = torch.arange(L, device=dev)[None, :]
    l2c = l2.long()[:, None]
    src = (L - l2c + i).clamp(0, L - 1)
    t2 = torch.where(i < l2c, rc2f.gather(1, src), torch.full_like(rc2f, 15))
    q2 = torch.where(i < l2c, qc2f.gather(1, src), torch.zeros_like(qc2f))
    found, olen, diff = overlap_scan(s1, qc1, t2, q2, l1, l2, low_qual_classes)
    l1c = l1.long()[:, None]
    offset = l1c - olen[:, None]
    out_len = offset + l2c
    jm = torch.arange(2 * L, device=dev)[None, :]
    c1 = jm.clamp(0, L - 1).expand(B, -1)
    c2 = (jm - offset).clamp(0, L - 1)
    g1, gq1 = s1.gather(1, c1), qc1.gather(1, c1)
    g2, gq2 = t2.gather(1, c2), q2.gather(1, c2)
    take1 = (g1 != g2) & (gq1 == 2) & (gq2 == 0)
    in_left = jm < offset
    in_overlap = (jm >= offset) & (jm < l1c)
    in_right = (jm >= l1c) & (jm < out_len)
    seq = torch.where(in_left | (in_overlap & take1), g1, g2)
    keep = found[:, None] & (in_left | in_overlap | in_right)
    i32 = lambda x: torch.where(found, x, 0).to(torch.int32)
    return found, i32(diff), i32(out_len[:, 0]), torch.where(keep, seq, torch.full_like(seq, 15))


def _upload_split(L: int):
    """Column offsets of [s1p | q1p | s2p | q2p] in an upload row."""
    w2, w4 = (L + 1) // 2, (L + 3) // 4
    return w2, w4, 2 * w2 + 2 * w4


def merge_codes_plain(buf, lens2, L: int, lanes: bool = False):
    """Plain twin of merge_codes_kernel: the upload rows buf (B, 2*ceil(L/2)
    + 2*ceil(L/4)) and lens2 (B, 2) [l1, l2] -> (msum (B, 3) int32 [merged,
    diff, m_len], m_codes (B, 2L) uint8); with `lanes` also the three
    map-code lanes (m (B, 2L), R1 (B, L), R2 (B, L) as uploaded, not RC'd;
    MAP_FROM_SEQ4, 255 where not ACGT) and their lengths (3, B) int32
    [m_len, l1 where unmerged, l2 where unmerged], as fused_pass1 votes on
    them."""
    w2, w4, _ = _upload_split(L)
    s1 = unpack_seq4(buf[:, :w2], L)
    qc1 = unpack_q2(buf[:, w2 : w2 + w4], L)
    s2 = unpack_seq4(buf[:, w2 + w4 : 2 * w2 + w4], L)
    qc2 = unpack_q2(buf[:, 2 * w2 + w4 :], L)
    l1, l2 = lens2[:, 0], lens2[:, 1]
    merged, diff, m_len, m_codes = merge_codes(s1, qc1, l1, lut(COMP4, s2.flip(1)),
                                               qc2.flip(1), l2, L)
    msum = torch.stack([merged.to(torch.int32), diff, m_len], 1)
    if not lanes:
        return msum, m_codes
    maps = tuple(lut(MAP_FROM_SEQ4, c) for c in (m_codes, s1, s2))
    lens3 = torch.stack([m_len, torch.where(merged, 0, l1), torch.where(merged, 0, l2)])
    return msum, m_codes, maps, lens3.to(torch.int32)


def merge_rows_plain(m_codes, buf, idx, lane, W: int, L: int) -> torch.Tensor:
    """Plain twin of merge_rows_kernel: for each entry p of idx (PB,), the
    pair row idx[p]'s merged codes (m_codes (B, Lm), where lane[p] == 0 or
    lane is None) or its R1 (lane[p] == 1) or R2 (any other lane, or lane 0
    without m_codes) unpacked from the upload rows buf and padded with 15
    past L; its first W columns mapped with MAP_FROM_SEQ4 -> (PB, W) uint8.
    A row outside [0, B) is all 255."""
    src = idx.long()
    nrows = (m_codes if m_codes is not None else buf).shape[0]
    inside = (src >= 0) & (src < nrows)
    s = src.clamp(0, max(nrows - 1, 0))
    PB = src.shape[0]
    rows4 = None
    if buf is not None:
        w2, w4, _ = _upload_split(L)
        r1 = unpack_seq4(buf[s, :w2], L)
        r2 = unpack_seq4(buf[s, w2 + w4 : 2 * w2 + w4], L)
        ln = torch.zeros_like(src) if lane is None else lane.long()
        r = torch.where((ln == 1)[:, None], r1, r2)
        rows4 = torch.full((PB, W), 15, dtype=torch.uint8, device=src.device)
        rows4[:, : min(L, W)] = r[:, : min(L, W)]
    if m_codes is not None:
        m = m_codes[s, :W]
        is_m = torch.ones_like(inside) if lane is None else lane == 0
        rows4 = m if rows4 is None else torch.where(is_m[:, None], m, rows4)
    codes = lut(MAP_FROM_SEQ4, rows4)
    return torch.where(inside[:, None], codes, torch.full_like(codes, 255))


def _check_upload(buf, lens2, L: int, name: str) -> None:
    dev = buf.device
    cuda.check_tensor(buf, "buf", torch.uint8, 2, dev)
    cuda.check_tensor(lens2, "lens2", torch.int32, 2, dev)
    if L < 1 or buf.shape[1] != _upload_split(L)[2] or lens2.shape != (buf.shape[0], 2):
        raise ValueError(f"{name}: upload {tuple(buf.shape)} and lens2 {tuple(lens2.shape)} "
                         f"do not fit L {L}")


def merge_packed(buf, lens2, L: int, lanes: bool = False):
    """merge_codes_plain's outputs. On the card one launch: a warp a pair
    unpacks its row into shared memory (R1's codes and classes, R2's RC'd
    and left-aligned), finds the first acceptable overlap as merge_batch's
    kernel does (32 overlaps filtered at a time on their first few
    positions, those that pass scanned whole with ballots), and writes
    msum, the merged codes and, with `lanes`, the three map-code lanes
    (each a fresh tensor, 16-byte aligned for the probe) and their
    lengths. Lengths lie in [0, L]."""
    _check_upload(buf, lens2, L, "merge_packed")
    dev = buf.device
    if dev.type == "cpu":
        return merge_codes_plain(buf, lens2, L, lanes)
    if L > MERGE_MAX_L:
        raise ValueError(f"merge_packed: reads of {L} bases past the kernel's {MERGE_MAX_L}")
    B = buf.shape[0]
    msum = torch.empty((B, 3), dtype=torch.int32, device=dev)
    m_codes = torch.empty((B, 2 * L), dtype=torch.uint8, device=dev)
    maps = lens3 = None
    if lanes:
        maps = tuple(torch.empty((B, w), dtype=torch.uint8, device=dev)
                     for w in (2 * L, L, L))
        lens3 = torch.empty((3, B), dtype=torch.int32, device=dev)
    if B:
        cuda.launch_merge_codes(buf, lens2, L, msum, m_codes, maps, lens3)
    return (msum, m_codes) if not lanes else (msum, m_codes, maps, lens3)


def merge_rows(m_codes, buf, idx, lane, W: int, L: int) -> torch.Tensor:
    """merge_rows_plain's (PB, W) codes. idx and lane may be strided views
    (the columns of a work list). On the card one launch, a warp a row, into
    a fresh tensor (16-byte aligned for the probe)."""
    dev = idx.device
    if idx.dtype != torch.int32 or idx.dim() != 1 or (
            lane is not None and (lane.dtype != torch.int32 or lane.shape != idx.shape
                                  or lane.device != dev)):
        raise ValueError("merge_rows: idx and lane must be 1-D int32 of one length and "
                         "device")
    if m_codes is not None:
        cuda.check_tensor(m_codes, "m_codes", torch.uint8, 2, dev)
        if W > m_codes.shape[1]:
            raise ValueError(f"merge_rows: width {W} past the merged codes' "
                             f"{m_codes.shape[1]}")
    if buf is not None:
        cuda.check_tensor(buf, "buf", torch.uint8, 2, dev)
        if buf.shape[1] != _upload_split(L)[2] or (
                m_codes is not None and m_codes.shape[0] != buf.shape[0]):
            raise ValueError(f"merge_rows: upload {tuple(buf.shape)} does not fit L {L}")
    if (m_codes is None and buf is None) or W < 1 or (lane is not None and buf is None):
        raise ValueError("merge_rows: no rows to take, a lane without the upload, or "
                         "width < 1")
    if dev.type == "cpu":
        return merge_rows_plain(m_codes, buf, idx, lane, W, L)
    out = torch.empty((idx.shape[0], W), dtype=torch.uint8, device=dev)
    if idx.shape[0]:
        cuda.launch_merge_rows(m_codes, buf, L, idx, lane, out)
    return out


def _check_chunk(B: int, chunk: int, name: str) -> None:
    # the JAX package maps over chunks of rows to bound the TPU's working
    # set; here the whole batch is one launch, with the same results
    if chunk < 1 or B % chunk:
        raise ValueError(f"{name}: batch of {B} rows is not a multiple of chunk {chunk}")


def fused_merge_chunked(buf, lens2, L: int, chunk: int):
    """Merge-only stage: -> (msum (B, 3) int32 [merged, diff, m_len],
    m_codes (B, 2L) uint8), B a multiple of `chunk`."""
    _check_chunk(buf.shape[0], chunk, "fused_merge_chunked")
    return merge_packed(buf, lens2, L)


def pass1_lanes(maps, lens3, index: TorchIndex, major_req: int, minor_req: int):
    """The stride-2 vote of each of the three map-code lanes -> (3, B, 5)
    int32 [ok, h1, l1, h2, l2] rows (lanes m, R1, R2)."""
    votes = torch.empty((3, lens3.shape[1], 5), dtype=torch.int32, device=lens3.device)
    for k, codes in enumerate(maps):
        ln = lens3[k]
        vote(probe(codes, ln, PASS1_STEP, index), index, major_req, minor_req, ln,
             out=votes[k])
    return votes


def fused_pass1_chunked(buf, lens2, index: TorchIndex, L: int, chunk: int,
                        major_req: int = 40, minor_req: int = 20):
    """One upload in, the merge and the three lanes' pass 1 -> (summary
    (B, SUMMARY_COLS) int32, m_codes (B, 2L) uint8). Each lane votes over
    all B rows; a lane's rows that the merge leaves out have length 0."""
    _check_chunk(buf.shape[0], chunk, "fused_pass1_chunked")
    msum, m_codes, maps, lens3 = merge_packed(buf, lens2, L, lanes=True)
    votes = pass1_lanes(maps, lens3, index, major_req, minor_req)
    summary = torch.cat([msum, votes.permute(1, 0, 2).reshape(-1, 15)], 1)
    return summary, m_codes


def fused_pass1(s1p, q1p, l1, s2p, q2p, l2, index: TorchIndex, L: int,
                major_req: int = 40, minor_req: int = 20) -> FusedPass1Result:
    """fused_pass1_chunked on the four packed parts, as FusedPass1Result."""
    buf = torch.cat([s1p, q1p, s2p, q2p], 1)
    lens2 = torch.stack([l1, l2], 1).to(torch.int32)
    s, m_codes = fused_pass1_chunked(buf, lens2, index, L, max(1, buf.shape[0]),
                                     major_req, minor_req)
    return FusedPass1Result(s[:, 0] != 0, s[:, 1], s[:, 2], m_codes,
                            s[:, 3] != 0, s[:, 4:8], s[:, 8] != 0, s[:, 9:13],
                            s[:, 13] != 0, s[:, 14:18])


def merged_width(L2: int, width: int = 0) -> int:
    """The columns of pass1_rows_merged's rows: a merged read is at most
    L2 - MIN_OVERLAP long; `width` > 0 trims further."""
    return L2 - MIN_OVERLAP if width <= 0 else min(width, L2 - MIN_OVERLAP)


def pass1_rows_merged(m_codes, idx, lens, index: TorchIndex, L2: int, major_req: int = 40,
                      minor_req: int = 20, width: int = 0):
    """The vote over the merged rows idx (PB,) of m_codes with lengths lens
    (PB,) -> (PB, 5) int32 [ok, h1, l1, h2, l2]."""
    w = min(merged_width(L2, width), m_codes.shape[1])
    codes = merge_rows(m_codes, None, idx, None, w, 0)
    return vote(probe(codes, lens, PASS1_STEP, index), index, major_req, minor_req, lens)


def pass1_rows_packed(buf, work, index: TorchIndex, L: int, major_req: int = 40,
                      minor_req: int = 20):
    """The vote over unmerged reads: work (PB, 3) int32 [pair row, lane (1
    R1, else R2), length] -> (PB, 5) int32."""
    lens = work[:, 2].contiguous()
    codes = merge_rows(None, buf, work[:, 0], work[:, 1], L, L)
    return vote(probe(codes, lens, PASS1_STEP, index), index, major_req, minor_req, lens)


def fused_pass2_combined(m_codes, buf, work, index: TorchIndex, L: int,
                         mismatch_thr: int = 10):
    """Pass 2 over all three lane groups at once: work (PB, 7) int32 [pair
    row, lane (0 merged, 1 R1, else R2), length, h1, l1, h2, l2]; R1/R2
    rows padded with 15 to the merged width 2L - MIN_OVERLAP -> (PB, 10)
    int32 [valid0, valid1, start0, start1, end0, end1, contig0, contig1,
    pos0, pos1]."""
    W = m_codes.shape[1] - MIN_OVERLAP
    lens = work[:, 2].contiguous()
    codes = merge_rows(m_codes, buf, work[:, 0], work[:, 1], W, L)
    return mask_segments(probe(codes, lens, 1, index), lens, work[:, 3:7].contiguous(),
                         index, mismatch_thr)


def fused_scan_codes(mbuf, mlens, ubuf, ulens, exc, index: TorchIndex, Wm: int, L: int,
                     cap: int, major_req: int = 40, minor_req: int = 20,
                     mismatch_thr: int = 10):
    """Two-lane form of fused_scan_lanes: the merged lane at width Wm, the
    unmerged reads at width L."""
    return fused_scan_lanes((mbuf, ubuf), torch.cat([mlens, ulens]), exc, index,
                            widths=(Wm, L), cap=cap, major_req=major_req,
                            minor_req=minor_req, mismatch_thr=mismatch_thr)
