"""Host-side edit distance (Levenshtein), Myers bit-parallel.

The reference (src/core/edit_distance.rs:12-197) implements Myers' bit-vector
algorithm over fixed u64 word counts. Levenshtein distance is symmetric, so
the reference's pattern/text orientation shuffling (edit_distance.rs:164-182)
does not change the value; we use Python big-int words for arbitrary length.

Note: for two strings BOTH longer than 640 chars the reference falls into a
DP path that indexes unpushed Vec capacity and would panic
(edit_distance.rs:94-120, noted in SURVEY §2 row 16); we simply compute the
correct distance (unreachable for the reference's <=~300bp reads).

The batched device version lives in ops/edit_distance.py.
"""

from __future__ import annotations


def edit_distance(a: str, b: str) -> int:
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    # pattern = a, text = b
    m = len(a)
    peq = {}
    for i, ch in enumerate(a):
        peq[ch] = peq.get(ch, 0) | (1 << i)
    mask = (1 << m) - 1
    top = 1 << (m - 1)
    pv = mask
    mv = 0
    score = m
    for ch in b:
        eq = peq.get(ch, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) & mask ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & top:
            score += 1
        elif mh & top:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score
