"""Batched paired-end overlap merge (fast_merge) on the device: port of
`ops/merge.py::merge_batch`.

The reference scans the overlap lengths o from MIN_OVERLAP up and stops
at the first mismatch that is not low-quality discordant (one side >= Q30,
the other <= Q15) or at the third such mismatch; (diff - low_qual_diff)
and low_qual_diff never fall as the scan goes on, so o is acceptable iff
every mismatch of its overlap is low-quality discordant and there are at
most 2 of them, and the first acceptable o wins, its diff the full count.

Inputs are raw bytes (compared raw: 'a' != 'A') of the left read and of
the reverse-complemented right read, with PHRED quality characters (the
right read's reversed). Lengths lie in [0, L].

`merge_batch` launches csrc/merge.cu's merge_bytes_kernel (a warp a pair:
its lanes filter the overlaps on a prefix, the warp scans those that pass
with that early stop, then writes the merged row) for CUDA tensors and runs `merge_batch_plain` for CPU tensors. The plain version
loops over o with (B, o) work a step: JAX's (B, O, L) tensor would be 1.2 G
elements at 65,536 pairs of 150 bases.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MIN_OVERLAP
from . import cuda

_Q30 = ord("?")
_Q15 = ord("0")
_QCAP = ord("Z")
# widest rows the merge kernels stage in one warp's shared memory (MERGE_MAX_L
# in csrc/merge.cu)
MERGE_MAX_L = 32768


class MergeResult(NamedTuple):
    merged: torch.Tensor  # (B,) bool
    olen: torch.Tensor  # (B,) int32
    diff: torch.Tensor  # (B,) int32
    out_seq: torch.Tensor  # (B, 2L) uint8 (0 padding)
    out_qual: torch.Tensor  # (B, 2L) uint8
    out_len: torch.Tensor  # (B,) int32


def low_qual_bytes(qa, qb):
    """Low-quality discordance of PHRED characters."""
    return ((qa >= _Q30) & (qb <= _Q15)) | ((qa <= _Q15) & (qb >= _Q30))


def low_qual_classes(ca, cb):
    """Low-quality discordance of quality classes (0 low, 2 high)."""
    return ((ca == 2) & (cb == 0)) | ((ca == 0) & (cb == 2))


def overlap_scan(a, qa, b, qb, l1, l2, low_pair):
    """The first acceptable overlap of each pair: the left read a/qa (B, L)
    (its overlap right-aligned at l1) against the right read b/qb (B, L),
    left-aligned -> (found (B,) bool, olen (B,) int64, MIN_OVERLAP where
    none, diff (B,) int64, 0 where none)."""
    B, L = a.shape
    dev = a.device
    l1, l2 = l1.long(), l2.long()
    nmax = torch.minimum(l1, l2)
    ar = torch.arange(L, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    olen = torch.full((B,), MIN_OVERLAP, dtype=torch.long, device=dev)
    diff = torch.zeros(B, dtype=torch.long, device=dev)
    for o in range(MIN_OVERLAP, L + 1):
        j = ((l1 - o)[:, None] + ar[None, :o]).clamp(0, L - 1)
        mism = a.gather(1, j) != b[:, :o]
        n_low = (mism & low_pair(qa.gather(1, j), qb[:, :o])).sum(1)
        d = mism.sum(1)
        ok = ~found & (nmax >= o) & (d == n_low) & (n_low <= 2)
        olen = torch.where(ok, o, olen)
        diff = torch.where(ok, d, diff)
        found |= ok
    return found, olen, diff


def merge_batch_plain(b1, q1, l1, b2, q2, l2) -> MergeResult:
    """Plain twin of merge_bytes_kernel (JAX `merge_batch`)."""
    B, L = b1.shape
    dev = b1.device
    found, olen, diff = overlap_scan(b1, q1, b2, q2, l1, l2, low_qual_bytes)
    l1c = l1.long()[:, None]
    offset = l1c - olen[:, None]
    out_len = offset + l2.long()[:, None]
    jm = torch.arange(2 * L, device=dev)[None, :]
    c1 = jm.clamp(0, L - 1).expand(B, -1)
    c2 = (jm - offset).clamp(0, L - 1)
    g1, gq1 = b1.gather(1, c1), q1.gather(1, c1)
    g2, gq2 = b2.gather(1, c2), q2.gather(1, c2)
    in_left = jm < offset
    in_overlap = (jm >= offset) & (jm < l1c)
    in_right = (jm >= l1c) & (jm < out_len)
    same = g1 == g2
    take1 = (gq1 >= _Q30) & (gq2 <= _Q15)
    ov_seq = torch.where(same, g2, torch.where(take1, g1, g2))
    sumq = (gq1.int() + gq2.int() - 33).clamp(max=_QCAP).to(torch.uint8)
    ov_qual = torch.where(same, sumq, torch.where(take1, gq1, gq2))
    zero = torch.zeros_like(g1)
    keep = found[:, None] & (in_left | in_overlap | in_right)
    out_seq = torch.where(in_left, g1, torch.where(in_overlap, ov_seq, g2))
    out_qual = torch.where(in_left, gq1, torch.where(in_overlap, ov_qual, gq2))
    i32 = lambda x: torch.where(found, x, 0).to(torch.int32)
    return MergeResult(found, i32(olen), i32(diff), torch.where(keep, out_seq, zero),
                       torch.where(keep, out_qual, zero), i32(out_len[:, 0]))


def merge_batch(b1, q1, l1, b2, q2, l2) -> MergeResult:
    """Overlap merge of B pairs: b1/q1 (B, L) uint8 left read bytes and
    qualities, b2/q2 (B, L) the reverse-complemented right read and its
    reversed qualities, l1/l2 (B,) int32 lengths in [0, L] -> MergeResult.
    On the card one warp merges a pair: it stages the four rows in shared
    memory (L up to MERGE_MAX_L), filters 32 overlaps at a time on their
    first few positions, a lane each, scans the ones that pass 32
    positions a step with ballots, and writes the merged row over 2L
    columns."""
    dev = b1.device
    for t, name in ((b1, "b1"), (q1, "q1"), (b2, "b2"), (q2, "q2")):
        cuda.check_tensor(t, name, torch.uint8, 2, dev)
    for t, name in ((l1, "l1"), (l2, "l2")):
        cuda.check_tensor(t, name, torch.int32, 1, dev)
    B, L = b1.shape
    if (any(t.shape != b1.shape for t in (q1, b2, q2))
            or l1.shape != (B,) or l2.shape != (B,)):
        raise ValueError(f"merge_batch: rows {tuple(b1.shape)}, {tuple(q1.shape)}, "
                         f"{tuple(b2.shape)}, {tuple(q2.shape)}; lengths "
                         f"{tuple(l1.shape)}, {tuple(l2.shape)}")
    if dev.type == "cpu":
        return merge_batch_plain(b1, q1, l1, b2, q2, l2)
    if L > MERGE_MAX_L:
        raise ValueError(f"merge_batch: rows of {L} bytes past the kernel's {MERGE_MAX_L}")
    merged = torch.empty(B, dtype=torch.bool, device=dev)
    ints = torch.empty((3, B), dtype=torch.int32, device=dev)
    out = torch.empty((2, B, 2 * L), dtype=torch.uint8, device=dev)
    if B:
        cuda.launch_merge_bytes(b1, q1, l1, b2, q2, l2, merged, ints, out)
    return MergeResult(merged, ints[0], ints[1], out[0], out[1], ints[2])
