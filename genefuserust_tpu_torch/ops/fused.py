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
"""

from __future__ import annotations

import torch

from ..config import PASS1_STEP
from . import cuda
from .index import TorchIndex
from .map_read import mask_segments, probe, vote
from .pack import unpack_seq2

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


def compact_plain(v, lens, cap: int):
    """The concatenated vote rows v (N, 5) [ok, h1, l1, h2, l2] and lens
    (N,) -> (out, slens, gp, okwords):

      out      (cap + 1, 13) int32 zeros but for [sidx, svalid] in rows
               [0, c), c = min(cap, N), and the survivor count at [cap, 0];
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


def compact(v, lens, cap: int, lanes=None, Wmax: int = 0):
    """compact_plain's (out, slens, gp, okwords), and given the code
    `lanes` (P_i, W_i) uint8 whose rows are v's, survivor_rows_plain's
    (c, Wmax) rows of out[:c, 0] as a fifth output. On the card, over tiles
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
        res = compact_plain(v, lens, cap)
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
        cuda.launch_compact_place(v, lens, cap, okwords, tile_cnt, out, slens, gp)
        return out, slens, gp, okwords
    rows = torch.empty((c, Wmax), dtype=torch.uint8, device=dev)
    offs = _lane_offsets(lanes)
    first = slice(0, cuda.MAX_LANES)
    cuda.launch_compact_place(v, lens, cap, okwords, tile_cnt, out, slens, gp, lanes[first],
                              offs[first], rows)
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
    launch copies the survivors' code rows.

    Returns (out, okwords):
      out      (cap + 1, 13) int32 — per survivor [sidx, svalid, valid0,
               valid1, start0, start1, end0, end1, contig0, contig1, pos0,
               pos1, 0]; the LAST row is [n_survivors, 0, ...].
      okwords  (ceil(N/32),) int32 — the vote-gate bitmap, bit k of word w
               = row 32w + k, as the int32 bit pattern of a uint32 OR.
    """
    rows = [b.shape[0] for b in bufs]
    if not isinstance(lens_t, torch.Tensor) or lens_t.shape != (sum(rows),):
        raise ValueError(f"fused_scan_lanes: lens_t must be one ({sum(rows)},) tensor")
    codes_l = lanes_codes(bufs, widths, exc)
    votes = torch.empty((lens_t.shape[0], 5), dtype=torch.int32, device=exc.device)
    at = 0
    for ci, ln in zip(codes_l, torch.split(lens_t, rows)):
        vote(probe(ci, ln, PASS1_STEP, index), index, major_req, minor_req, ln,
             out=votes[at : at + ci.shape[0]])
        at += ci.shape[0]
    out, slens, gp, okwords, scodes = compact(votes, lens_t, cap, codes_l, max(widths))
    c = slens.shape[0]
    out[:c, 2:12] = mask_segments(probe(scodes, slens, 1, index), slens, gp, index,
                                  mismatch_thr)
    return out, okwords
