"""The probe's work in a sample, counted from the reads as the reference
merges and walks them (not from the program's counters), so that the same
work is read whatever implements it.

Each pair is merged as `fast_merge` merges it (reference: read.rs:313-440;
vectorised here: the first overlap from 30 bases up whose mismatches are
all low-quality diffs, at most 2). A merged pair is one row of its merged
bases; an unmerged pair is two rows, R1 and R2. Pass 1 looks up each row's
k-mers at stride 2 that hold no N. The bound counts 1 byte a base of every
row and one 32-byte sector a k-mer looked up, a pass a panel. Pass 2 (the
survivors' rows at stride 1), the reverse-complement retries and the second
row of a two-choice lookup are left out: the bound stays a lower bound.
"""

from __future__ import annotations

import numpy as np

from .bounds import bound

KMER = 16
MIN_OVERLAP = 30
SECTOR = 32
_Q30, _Q15 = ord("?"), ord("0")
_COMPLEMENT = np.full(256, ord("N"), np.uint8)
_COMPLEMENT[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
_ACGT = np.zeros(256, bool)
_ACGT[np.frombuffer(b"ACGT", np.uint8)] = True
_PREFIX = 8  # overlap positions a candidate is first filtered on
_CHUNK = 65536


def merge_offsets(b1, q1, b2, q2) -> np.ndarray:
    """(n,) the offset in R1 where R2's reverse complement starts for each
    pair that merges, -1 for one that does not. Reads of one length."""
    n, rl = b1.shape
    r2 = _COMPLEMENT[b2[:, ::-1]]
    s2 = q2[:, ::-1]
    offs = np.full(n, -1, np.int64)
    n_off = rl - MIN_OVERLAP + 1  # offsets 0 .. rl - 30
    for s in range(0, n, _CHUNK):
        r = slice(s, min(n, s + _CHUNK))
        x1, y1, x2, y2 = b1[r], q1[r], r2[r], s2[r]
        m = np.zeros((x1.shape[0], n_off), np.uint8)
        for t in range(_PREFIX):
            m += x1[:, t : t + n_off] != x2[:, t, None]
        rows, off = np.nonzero(m <= 2)
        best = np.full(x1.shape[0], -1, np.int64)
        for o in np.unique(off):
            sel = rows[off == o]
            a, qa = x1[sel, o:], y1[sel, o:]
            bb, qb = x2[sel, : rl - o], y2[sel, : rl - o]
            diff = a != bb
            lqd = ((qa >= _Q30) & (qb <= _Q15)) | ((qa <= _Q15) & (qb >= _Q30))
            ok = ~(diff & ~lqd).any(1) & (diff.sum(1) <= 2)
            # the smallest overlap wins: the largest offset
            best[sel[ok]] = np.maximum(best[sel[ok]], o)
        offs[r] = best
    return offs


def _valid_kmers(bad: np.ndarray, lens: np.ndarray, stride: int) -> np.ndarray:
    """Per row, the k-mers at positions 0, stride, ... < len - 15 whose 16
    bases are all A, C, G or T. bad: (n, W) bool, True where a base is not."""
    c = np.zeros((bad.shape[0], bad.shape[1] + 1), np.int32)
    np.cumsum(bad, axis=1, out=c[:, 1:])
    nk = bad.shape[1] - KMER + 1
    ok = (c[:, KMER:] - c[:, :nk]) == 0
    pos = np.arange(nk)
    ok &= (pos[None, :] % stride == 0) & (pos[None, :] < (lens[:, None] - KMER + 1))
    return ok.sum(1)


def pass1_work(b1, q1, b2, q2) -> dict:
    """Rows, bases and k-mers looked up in pass 1 over one panel."""
    n, rl = b1.shape
    offs = merge_offsets(b1, q1, b2, q2)
    out = dict(rows=0, bases=0, kmers=0, merged=int((offs >= 0).sum()))
    for s in range(0, n, _CHUNK):
        r = slice(s, min(n, s + _CHUNK))
        off = offs[r]
        x1, y1 = b1[r], q1[r]
        x2, y2 = _COMPLEMENT[b2[r][:, ::-1]], q2[r][:, ::-1]
        mg = off >= 0
        # unmerged pairs: R1 and R2 as read
        for side in (b1[r][~mg], b2[r][~mg]):
            lens = np.full(side.shape[0], rl)
            out["kmers"] += int(_valid_kmers(~_ACGT[side], lens, 2).sum())
            out["bases"] += side.size
            out["rows"] += side.shape[0]
        # merged rows: R1 before the overlap, then R2's reverse complement;
        # inside the overlap a differing base is R1's where R1 >= Q30 and
        # R2 <= Q15, else R2's
        o = off[mg]
        x1, y1, x2, y2 = x1[mg], y1[mg], x2[mg], y2[mg]
        W = 2 * rl - MIN_OVERLAP
        lens = 2 * rl - (rl - o)
        col = np.arange(W)[None, :]
        j = col - o[:, None]  # column in R2's reverse complement
        from1 = col < rl
        in2 = (j >= 0) & (j < rl)
        c1 = np.minimum(np.arange(W), rl - 1)
        jc = np.clip(j, 0, rl - 1)
        base1, qa = x1[:, c1], y1[:, c1]
        base2, qb = np.take_along_axis(x2, jc, 1), np.take_along_axis(y2, jc, 1)
        take1 = from1 & (~in2 | ((base1 != base2) & (qa >= _Q30) & (qb <= _Q15)))
        merged = np.where(take1, base1, base2)
        bad = ~_ACGT[merged] & (col < lens[:, None])
        out["kmers"] += int(_valid_kmers(bad, lens, 2).sum())
        out["bases"] += int(lens.sum())
        out["rows"] += len(o)
    return out


def probe_bound(b1, q1, b2, q2, panels: int) -> dict:
    """The probe's least time over a sample's pass 1 against `panels`
    tables, with the counts it is made of."""
    w = pass1_work(b1, q1, b2, q2)
    nbytes = panels * (w["bases"] + SECTOR * w["kmers"])
    return dict(w, panels=panels, **bound(nbytes, 0))
