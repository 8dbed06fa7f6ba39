"""Standalone overlap fitter between R1/R2 (dead code in the reference's
main path — fast_merge is used instead — but part of the public surface
with golden tests; reference: src/core/overlap.rs:11-125).

Faithful details: the positive-offset skip is max(1, (d - ceil(thr)) / 2)
(overlap.rs:82) while the negative-offset skip groups differently as
max(1, d - ceil(thr)/2) (overlap.rs:118) — both replicated, including
Rust's truncating integer division.
"""

from __future__ import annotations

import dataclasses
import math

from .edit_distance import edit_distance
from .sequence import reverse_complement


@dataclasses.dataclass
class Overlap:
    offset: int
    overlap_len: int
    distance: int

    @property
    def overlapped(self) -> bool:
        return self.overlap_len > 0

    @staticmethod
    def fit(r1: str, r2: str) -> "Overlap":
        len1 = len(r1)
        len2 = len(r2)
        rev2 = reverse_complement(r2)

        overlapped = False
        overlap_len = 0
        offset = 0
        distance = 0

        while offset < len1 - 10 and not overlapped:
            overlap_len = min(len1 - offset, len2)
            distance = edit_distance(
                r1[offset : offset + overlap_len], rev2[:overlap_len]
            )
            threshold = min(3.0, overlap_len / 10.0)
            if distance <= threshold:
                # verify by moving one more base: keep while strictly better
                while offset < len1 - 10:
                    next_offset = offset + 1
                    next_overlap_len = min(len1 - next_offset, len2)
                    next_distance = edit_distance(
                        r1[next_offset : next_offset + next_overlap_len],
                        rev2[:next_overlap_len],
                    )
                    if distance <= next_distance:
                        overlapped = True
                        break
                    offset = next_offset
                    distance = next_distance
                    overlap_len = next_overlap_len
                break
            offset += max(1, (distance - int(math.ceil(threshold))) // 2)

        if overlapped and offset == 0:
            # negative offsets: insert shorter than read length (adapter
            # read-through); reference overlap.rs:85-121
            while offset > -(len2 - 10):
                overlap_len = min(len1, len2 - abs(offset))
                distance = edit_distance(
                    r1[:overlap_len], rev2[-offset : -offset + overlap_len]
                )
                threshold = min(3.0, overlap_len / 10.0)
                if distance <= threshold:
                    while offset > -(len2 - 10):
                        next_offset = offset - 1
                        next_overlap_len = min(len1, len2 - abs(next_offset))
                        next_distance = edit_distance(
                            r1[:next_overlap_len],
                            rev2[-next_offset : -next_offset + next_overlap_len],
                        )
                        if distance <= next_distance:
                            return Overlap(offset, overlap_len, distance)
                        distance = next_distance
                        overlap_len = next_overlap_len
                        offset = next_offset
                else:
                    offset -= max(1, distance - int(math.ceil(threshold)) // 2)
        elif overlapped:
            return Overlap(offset, overlap_len, distance)

        return Overlap(0, 0, 0)
