"""The whole per-batch scan: port of `ops/fused.py::fused_scan_lanes`.

Per code lane: unpack the 2-bit rows, set the exception positions to 255,
probe every second k-mer (kernel 1) and vote (kernel 2). Then compact the
vote-gate survivors in row order, gather their code rows, probe their
full-stride k-mers (kernel 1) and extract their segments (kernel 3). None
of it waits for the device: the only host reads of a batch are its
(cap + 1, 13) result and, on survivor-cap overflow, the bitmap.

The glue between the passes has a hand-written CUDA kernel for each step
(csrc/fused_glue.cu), reached through a wrapper that launches the kernel
for CUDA tensors and runs the plain version beside it for CPU tensors:

  lane_codes     unpack_seq2 + the exception scatter  (lane_unpack_kernel)
  compact        stable survivor compaction, okwords (compact_kernel)
  survivor_rows  the survivors' code rows, 255-padded (survivor_rows_kernel)
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
    """Unpacked (P, W) codes of one lane with its exceptions set to 255.
    An entry of exc (E, 2) [row, col] counts when its row lies in the lane
    ([off, off + P)) and its column in [-W, W): a negative column is taken
    from the row's end (W + col), as JAX's `.at[].set(mode="drop")` does;
    every other entry is dropped."""
    P = buf.shape[0]
    flat = torch.empty(P * W + 1, dtype=torch.uint8, device=buf.device)
    flat[: P * W].view(P, W).copy_(unpack_seq2(buf, W))
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
    nw = (N + 31) // 32
    bits = torch.zeros(nw * 32, dtype=torch.int64, device=dev)
    bits[:N] = ok.to(torch.int64)
    words = (bits.view(nw, 32) << torch.arange(32, device=dev)).sum(1)
    okwords = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return out, slens, gp, okwords


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


def lane_codes(buf, W: int, exc, off: int) -> torch.Tensor:
    """lane_codes_plain's (P, W) codes. On the card one launch unpacks the
    lane into a fresh tensor (the probe reads it in 16-byte chunks) and
    then sets its exceptions."""
    dev = buf.device
    cuda.check_tensor(buf, "buf", torch.uint8, 2, dev)
    cuda.check_tensor(exc, "exc", torch.int32, 2, dev)
    P, Wb = buf.shape
    if W < 1 or 4 * Wb < W or exc.shape[1] != 2:
        raise ValueError(f"lane_codes: bad shapes buf={tuple(buf.shape)} W={W} "
                         f"exc={tuple(exc.shape)}")
    if dev.type == "cpu":
        return lane_codes_plain(buf, W, exc, off)
    out = torch.empty((P, W), dtype=torch.uint8, device=dev)
    if P:
        cuda.launch_lane_unpack(buf, W, exc, off, out)
    return out


def compact(v, lens, cap: int):
    """compact_plain's (out, slens, gp, okwords). On the card one block
    ballots the gate bits 32 rows a word, places each row at the running
    count before it and writes `out` whole, its zeros too."""
    dev = v.device
    cuda.check_tensor(v, "votes", torch.int32, 2, dev)
    cuda.check_tensor(lens, "lens", torch.int32, 1, dev)
    N = v.shape[0]
    if v.shape[1] != 5 or lens.shape[0] != N or not 0 <= cap < (1 << 31) // OUT_COLS - 1:
        raise ValueError(f"compact: bad shapes v={tuple(v.shape)} lens={tuple(lens.shape)} "
                         f"cap={cap}")
    if dev.type == "cpu":
        return compact_plain(v, lens, cap)
    c = min(cap, N)
    out = torch.empty((cap + 1, OUT_COLS), dtype=torch.int32, device=dev)
    slens = torch.empty(c, dtype=torch.int32, device=dev)
    gp = torch.empty((c, 4), dtype=torch.int32, device=dev)
    okwords = torch.empty((N + 31) // 32, dtype=torch.int32, device=dev)
    cuda.launch_compact(v, lens, cap, out, slens, gp, okwords)
    return out, slens, gp, okwords


def survivor_rows(lanes, sidx, Wmax: int) -> torch.Tensor:
    """survivor_rows_plain's (c, Wmax) rows. sidx may be a strided view
    (a column of compact's `out`). On the card the rows are copied from
    the lanes into a fresh tensor, at most cuda.MAX_LANES lanes a launch."""
    dev = sidx.device
    if sidx.dtype != torch.int32 or sidx.dim() != 1:
        raise ValueError(f"survivor_rows: sidx must be 1-D int32, got {sidx.dim()}-D "
                         f"{sidx.dtype}")
    for t in lanes:
        cuda.check_tensor(t, "lane codes", torch.uint8, 2, dev)
    if not lanes or max(t.shape[1] for t in lanes) > Wmax:
        raise ValueError(f"survivor_rows: lanes wider than Wmax {Wmax}")
    if dev.type == "cpu":
        return survivor_rows_plain(lanes, sidx, Wmax)
    c = sidx.shape[0]
    out = torch.empty((c, Wmax), dtype=torch.uint8, device=dev)
    offs = [sum(t.shape[0] for t in lanes[:i]) for i in range(len(lanes))]
    for g in range(0, len(lanes) if c else 0, cuda.MAX_LANES):
        cuda.launch_survivor_rows(lanes[g : g + cuda.MAX_LANES],
                                  offs[g : g + cuda.MAX_LANES], sidx, out)
    return out


def fused_scan_lanes(bufs, lens_t, exc, index: TorchIndex, *, widths, cap: int,
                     major_req: int = 40, minor_req: int = 20,
                     mismatch_thr: int = 10):
    """Scan any number of width-bucketed lanes in one call.

    bufs: (P_i, ceil(widths[i]/4)) uint8 2-bit rows; lens_t: (P_i,) int32;
    exc: (E, 2) int32 [row, col] of non-ACGT bases in the concatenated row
    space (pad entries point out of bounds and are dropped; a column in
    [-W_i, -1] counts from the row's end, as in JAX).

    Returns (out, okwords):
      out      (cap + 1, 13) int32 — per survivor [sidx, svalid, valid0,
               valid1, start0, start1, end0, end1, contig0, contig1, pos0,
               pos1, 0]; the LAST row is [n_survivors, 0, ...].
      okwords  (ceil(N/32),) int32 — the vote-gate bitmap, bit k of word w
               = row 32w + k, as the int32 bit pattern of a uint32 OR.
    """
    codes_l, votes = [], []
    off = 0
    for buf, ln, W in zip(bufs, lens_t, widths):
        ci = lane_codes(buf, W, exc, off)
        codes_l.append(ci)
        votes.append(vote(probe(ci, ln, PASS1_STEP, index), index, major_req, minor_req))
        off += buf.shape[0]
    out, slens, gp, okwords = compact(torch.cat(votes), torch.cat(lens_t), cap)
    c = slens.shape[0]
    scodes = survivor_rows(codes_l, out[:c, 0], max(widths))
    out[:c, 2:12] = mask_segments(probe(scodes, slens, 1, index), slens, gp, index,
                                  mismatch_thr)
    return out, okwords
