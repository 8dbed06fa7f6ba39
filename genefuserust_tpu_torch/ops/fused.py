"""The whole per-batch scan: port of `ops/fused.py::fused_scan_lanes`.

Per code lane: unpack the 2-bit rows, set the exception positions to 255,
probe every second k-mer (kernel 1) and vote (kernel 2). Then compact the
vote-gate survivors in row order, probe their full-stride k-mers (kernel 1)
and extract their segments (kernel 3). The glue is plain torch, and none of
it waits for the device: the only host reads of a batch are its
(cap + 1, 13) result and, on survivor-cap overflow, the bitmap.
"""

from __future__ import annotations

import torch

from ..config import PASS1_STEP
from .index import TorchIndex
from .map_read import mask_segments, probe, vote
from .pack import unpack_seq2


def lane_codes(buf, W: int, erow, ecol, off: int) -> torch.Tensor:
    """Unpacked (P, W) codes of one lane with its exceptions set to 255;
    exception entries outside the lane's rows or columns are dropped."""
    P = buf.shape[0]
    flat = torch.empty(P * W + 1, dtype=torch.uint8, device=buf.device)
    flat[: P * W].view(P, W).copy_(unpack_seq2(buf, W))
    inside = (erow >= off) & (erow < off + P) & (ecol >= 0) & (ecol < W)
    dest = torch.where(inside, (erow - off) * W + ecol, P * W)
    flat.index_fill_(0, dest, 255)
    return flat[: P * W].view(P, W)


def fused_scan_lanes(bufs, lens_t, exc, index: TorchIndex, *, widths, cap: int,
                     major_req: int = 40, minor_req: int = 20,
                     mismatch_thr: int = 10):
    """Scan any number of width-bucketed lanes in one call.

    bufs: (P_i, ceil(widths[i]/4)) uint8 2-bit rows; lens_t: (P_i,) int32;
    exc: (E, 2) int32 [row, col] of non-ACGT bases in the concatenated row
    space (pad entries point out of bounds and are dropped).

    Returns (out, okwords):
      out      (cap + 1, 13) int32 — per survivor [sidx, svalid, valid0,
               valid1, start0, start1, end0, end1, contig0, contig1, pos0,
               pos1, 0]; the LAST row is [n_survivors, 0, ...].
      okwords  (ceil(N/32),) int32 — the vote-gate bitmap, bit k of word w
               = row 32w + k, as the int32 bit pattern of a uint32 OR.
    """
    dev = exc.device
    erow = exc[:, 0].to(torch.int64)
    ecol = exc[:, 1].to(torch.int64)
    codes_l, votes = [], []
    off = 0
    for buf, ln, W in zip(bufs, lens_t, widths):
        ci = lane_codes(buf, W, erow, ecol, off)
        codes_l.append(ci)
        votes.append(vote(probe(ci, ln, PASS1_STEP, index), index, major_req, minor_req))
        off += buf.shape[0]
    N = off
    v = torch.cat(votes)
    ok = v[:, 0] != 0
    lens = torch.cat(lens_t)
    # stable survivor compaction: survivors first, each group in row order
    iota = torch.arange(N, device=dev)
    order = torch.argsort(torch.where(ok, iota, N + iota))
    c = min(cap, N)
    sidx = order[:c]
    svalid = ok[sidx]
    slens = torch.where(svalid, lens[sidx], 0).to(torch.int32)
    gp = v[sidx, 1:5].contiguous()
    # survivor code rows, from the exception-applied lanes, unified to the
    # widest lane (255-filled)
    Wmax = max(widths)
    allcodes = torch.full((N, Wmax), 255, dtype=torch.uint8, device=dev)
    off = 0
    for ci in codes_l:
        allcodes[off : off + ci.shape[0], : ci.shape[1]] = ci
        off += ci.shape[0]
    scodes = allcodes[sidx]
    seg = mask_segments(probe(scodes, slens, 1, index), slens, gp, index, mismatch_thr)
    out = torch.zeros((cap + 1, 13), dtype=torch.int32, device=dev)
    out[:c, 0] = sidx.to(torch.int32)
    out[:c, 1] = svalid.to(torch.int32)
    out[:c, 2:12] = seg
    out[cap, 0] = ok.sum().to(torch.int32)
    nw = (N + 31) // 32
    bits = torch.zeros(nw * 32, dtype=torch.int64, device=dev)
    bits[:N] = ok.to(torch.int64)
    words = (bits.view(nw, 32) << torch.arange(32, device=dev)).sum(1)
    okwords = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return out, okwords
