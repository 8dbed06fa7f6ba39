"""Read records and paired-end overlap merging.

reference: src/core/read.rs. `fast_merge` (read.rs:313-440) is the exact
host-side specification; the batched device kernel in ops/merge.py must
produce identical merged sequences/qualities (cross-checked in tests).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .sequence import reverse_complement
from ..config import MIN_OVERLAP


@dataclasses.dataclass
class SequenceRead:
    name: str
    seq: str
    strand: str
    quality: str
    has_quality: bool = True

    def __len__(self) -> int:
        return len(self.seq)

    def reverse_complement(self) -> "SequenceRead":
        """reference: src/core/read.rs:243-261 (strand '+' <-> '-'; any
        non-'+' strand maps to '+')."""
        return SequenceRead(
            self.name,
            reverse_complement(self.seq),
            "-" if self.strand == "+" else "+",
            self.quality[::-1],
            True,
        )


# quality thresholds used in merging (reference: src/core/read.rs:348-351):
# '?' = Q30, '0' = Q15
_Q30 = ord("?")
_Q15 = ord("0")
_QCAP = ord("Z")


@dataclasses.dataclass
class SequenceReadPair:
    left: SequenceRead
    right: SequenceRead

    def fast_merge(self) -> Optional[SequenceRead]:
        """Overlap-merge R1 with reverse-complemented R2.

        reference: src/core/read.rs:313-440. Tries overlap lengths from 30
        upward; an overlap is accepted iff every mismatch within it is a
        "low-qual diff" (one side >=Q30, other <=Q15) and there are at most
        2 such diffs. In the merged overlap, mismatches take R1's base only
        when R1>=Q30 and R2rc<=Q15 (otherwise R2rc's base); matches get
        summed quality capped at 'Z'.
        """
        rc_right = self.right.reverse_complement()
        str1 = self.left.seq
        str2 = rc_right.seq
        qual1 = self.left.quality
        qual2 = rc_right.quality
        len1, len2 = len(str1), len(str2)

        b1 = str1.encode("latin-1")
        b2 = str2.encode("latin-1")
        q1 = qual1.encode("latin-1")
        q2 = qual2.encode("latin-1")

        overlapped = False
        final_olen = 0
        final_diff = 0
        for olen in range(MIN_OVERLAP, min(len1, len2) + 1):
            offset = len1 - olen
            diff = 0
            lqd = 0
            ok = True
            for i in range(olen):
                if b1[offset + i] != b2[i]:
                    diff += 1
                    if (q1[offset + i] >= _Q30 and q2[i] <= _Q15) or (
                        q1[offset + i] <= _Q15 and q2[i] >= _Q30
                    ):
                        lqd += 1
                    if diff > lqd or lqd >= 3:
                        ok = False
                        break
            if ok:
                overlapped = True
                final_olen = olen
                final_diff = diff
                break

        if not overlapped:
            return None

        olen = final_olen
        offset = len1 - olen
        merged_name = f"{self.left.name} merged_diff_{final_diff}"
        seq = bytearray(b1[:offset] + b2)
        qual = bytearray(q1[:offset] + q2)
        for i in range(olen):
            if b1[offset + i] != b2[i]:
                if q1[offset + i] >= _Q30 and q2[i] <= _Q15:
                    seq[offset + i] = b1[offset + i]
                    qual[offset + i] = q1[offset + i]
                else:
                    seq[offset + i] = b2[i]
                    qual[offset + i] = q2[i]
            else:
                q = q1[offset + i] + q2[i] - 33
                qual[offset + i] = min(q, _QCAP)
        return SequenceRead(
            merged_name, seq.decode("latin-1"), "+", qual.decode("latin-1"), True
        )
