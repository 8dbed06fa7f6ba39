"""FusionResult: a cluster of supporting reads for one fusion event.

reference: src/core/fusion_result.rs:25-798. Holds the clustered matches,
computes the consensus fusion point, extracts reference context sequences,
fine-adjusts the break (±3 minimizing near-break edit distance), counts
unique supports, and applies the qualification gates.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, TYPE_CHECKING

from .config import Settings, SUPPORT_TOLERANCE
from .fusion import Fusion
from .gene import Gene
from .edit_distance import edit_distance
from .indexer import GenePos
from .sequence import dis_connected_count, reverse_complement

if TYPE_CHECKING:
    from .mapper import ReadMatch

log = logging.getLogger("gfbench.reference")


def get_ref_seq(ref_s: str, start: int, end: int) -> str:
    """Extract [start, end] (inclusive) from a panel sequence; negative
    coordinates address the reverse-complement strand.

    reference: src/core/fusion_result.rs:770-798 (empty string on
    mixed-strand or out-of-range requests)."""
    if (start >= 0 and end <= 0) or (start <= 0 and end >= 0):
        return ""
    if abs(start) >= len(ref_s) or abs(end) >= len(ref_s):
        return ""
    length = abs(end - start) + 1
    if start < 0:
        return reverse_complement(ref_s[-end : -end + length])
    return ref_s[start : start + length]


@dataclasses.dataclass
class FusionResult:
    left_gp: GenePos = dataclasses.field(default_factory=lambda: GenePos(0, 0))
    right_gp: GenePos = dataclasses.field(default_factory=lambda: GenePos(0, 0))
    matches: List["ReadMatch"] = dataclasses.field(default_factory=list)
    unique: int = 0
    title: str = ""
    left_ref: str = ""
    right_ref: str = ""
    left_ref_ext: str = ""
    right_ref_ext: str = ""
    left_pos: str = ""
    right_pos: str = ""
    left_gene: Gene = dataclasses.field(default_factory=Gene)
    right_gene: Gene = dataclasses.field(default_factory=Gene)
    left_is_exon: bool = False
    right_is_exon: bool = False
    left_exon_or_intron_id: int = -1
    right_exon_or_intron_id: int = -1

    # ------------- clustering -------------

    def add_match(self, m: "ReadMatch") -> None:
        self.matches.append(m)

    def support(self, m: "ReadMatch") -> bool:
        """reference: fusion_result.rs:416-445 (same contigs, positions
        within ±3 of any existing member)."""
        return any(_support_same(m, m2) for m2 in self.matches)

    # ------------- finalize chain -------------

    def calc_fusion_point(self) -> None:
        """reference: fusion_result.rs:60-86 (first gap==0 match wins, else
        integer-mean of positions)."""
        if not self.matches:
            return
        left_total = 0
        right_total = 0
        for rm in self.matches:
            if rm.gap == 0:
                self.left_gp = rm.left_gp.clone()
                self.right_gp = rm.right_gp.clone()
                return
            left_total += rm.left_gp.position
            right_total += rm.right_gp.position
        n = len(self.matches)
        self.left_gp = GenePos(self.matches[0].left_gp.contig, _trunc_div(left_total, n))
        self.right_gp = GenePos(
            self.matches[0].right_gp.contig, _trunc_div(right_total, n)
        )

    def make_reference(self, ref_l: str, ref_r: str) -> None:
        """reference: fusion_result.rs:242-297."""
        longest_left = 0
        longest_right = 0
        for rm in self.matches:
            longest_left = max(longest_left, rm.read_break + 1)
            longest_right = max(longest_right, len(rm.read.seq) - (rm.read_break + 1))
        lp, rp = self.left_gp.position, self.right_gp.position
        self.left_ref = get_ref_seq(ref_l, lp - longest_left + 1, lp)
        self.right_ref = get_ref_seq(ref_r, rp, rp + longest_right - 1)
        self.left_ref_ext = get_ref_seq(ref_l, lp, lp + longest_right - 1)
        self.right_ref_ext = get_ref_seq(ref_r, rp - longest_left + 1, rp)

    def adjust_fusion_break(self) -> None:
        """reference: fusion_result.rs:299-324 (shift ±3 minimizing 20bp
        near-break edit distance; strict < keeps the earliest shift)."""
        for rm in self.matches:
            smallest_ed = 0xFFFF
            shift = 0
            best_l = best_r = 0
            for s in range(-3, 4):
                ed, led, red = self._calc_ed(rm, s)
                if ed < smallest_ed:
                    smallest_ed = ed
                    shift = s
                    best_l, best_r = led, red
            rm.left_distance = best_l
            rm.right_distance = best_r
            rm.read_break += shift
            rm.left_gp.position += shift
            rm.right_gp.position += shift

    def _calc_ed(self, m: "ReadMatch", shift: int):
        """reference: fusion_result.rs:326-410. Returns
        (near-break total ed, full left ed, full right ed)."""
        read_break = m.read_break + shift
        seq = m.read.seq
        left_len = read_break + 1
        left_seq = seq[:left_len]
        right_seq = seq[left_len:]

        left_comp = min(len(left_seq), len(self.left_ref), 20)
        right_comp = min(len(right_seq), len(self.right_ref), 20)
        left_part_ed = edit_distance(
            _tail(left_seq, left_comp), _tail(self.left_ref, left_comp)
        )
        right_part_ed = edit_distance(
            right_seq[:right_comp], self.right_ref[:right_comp]
        )
        total_ed = left_part_ed + right_part_ed

        # note: the second block uses left_len (not len(left_seq)) as in the
        # reference (fusion_result.rs:378); when left_len exceeds the actual
        # sequence length the reference's usize wrap yields an empty slice —
        # _tail reproduces that.
        left_comp = min(left_len, len(self.left_ref))
        right_comp = min(len(right_seq), len(self.right_ref))
        left_ed = edit_distance(
            _tail(left_seq, left_comp), _tail(self.left_ref, left_comp)
        )
        right_ed = edit_distance(
            right_seq[:right_comp], self.right_ref[:right_comp]
        )
        return total_ed, left_ed, right_ed

    def calc_unique(self) -> None:
        """reference: fusion_result.rs:88-105 (distinct (read_break, len)
        among the sorted matches)."""
        self.unique = 1
        if len(self.matches) < 2:
            return
        prev = self.matches[0]
        for mm in self.matches[1:]:
            if mm.read_break != prev.read_break or len(mm.read.seq) != len(prev.read.seq):
                self.unique += 1
            prev = mm

    def update_info(self, fusions: List[Fusion]) -> None:
        """reference: fusion_result.rs:196-240."""
        self.left_gene = fusions[self.left_gp.contig].gene
        self.right_gene = fusions[self.right_gp.contig].gene
        head = "Deletion: " if self.is_deletion() else "Fusion: "
        lp = self.left_gene.pos2str(self.left_gp.position)
        rp = self.right_gene.pos2str(self.right_gp.position)
        self.title = (
            f"{head}{lp}___{rp}  (total: {len(self.matches)}, unique:{self.unique})"
        )
        self.left_pos = lp
        self.right_pos = rp
        self.left_is_exon, self.left_exon_or_intron_id = self.left_gene.get_exon_intron(
            self.left_gp.position
        )
        (
            self.right_is_exon,
            self.right_exon_or_intron_id,
        ) = self.right_gene.get_exon_intron(self.right_gp.position)

    # ------------- gates -------------

    def is_deletion(self) -> bool:
        """reference: fusion_result.rs:107-118."""
        if self.left_gp.contig == self.right_gp.contig:
            if self.left_gp.position > 0 and self.right_gp.position > 0:
                return True
            if self.left_gp.position < 0 and self.right_gp.position < 0:
                return True
        return False

    def can_be_mapped(self) -> bool:
        """reference: fusion_result.rs:120-129."""
        return self._can_be_matched(self.left_ref_ext, self.right_ref) or (
            self._can_be_matched(self.left_ref, self.right_ref_ext)
        )

    def _can_be_matched(self, s1: str, s2: str) -> bool:
        """reference: fusion_result.rs:131-161 — offsets -6..=6; an
        out-of-range start short-circuits True; ed <= cmplen/10 -> True."""
        length = len(s1)
        for offset in range(-6, 7):
            start1 = max(offset, 0)
            start2 = max(-offset, 0)
            cmplen = length - abs(offset)
            if start1 >= len(s1) or start2 >= len(s2):
                return True
            sub1 = s1[start1 : start1 + cmplen]
            sub2 = s2[start2 : start2 + cmplen]
            if len(sub1) != cmplen or len(sub2) != cmplen:
                # reference subchars would panic on out-of-range; this is
                # reachable only with pathological ref lengths — mirror by
                # failing loudly rather than silently diverging.
                raise RuntimeError("can_be_matched: substring out of range")
            ed = edit_distance(sub1, sub2)
            if ed <= cmplen // 10:
                return True
        return False

    def is_qualified(self, settings: Settings) -> bool:
        """reference: fusion_result.rs:163-194."""
        if self.unique < settings.unique_requirement:
            return False
        if self.can_be_mapped():
            return False
        if len(self.left_ref) <= 30 or len(self.right_ref) <= 30:
            return False
        if dis_connected_count(self.left_ref[-10:]) <= 2:
            return False
        if dis_connected_count(self.right_ref[:10]) <= 2:
            return False
        return True

    def is_left_protein_forward(self) -> bool:
        """reference: fusion_result.rs:446-452."""
        if self.left_gene.is_reversed():
            return self.left_gp.position < 0
        return self.left_gp.position > 0

    def is_right_protein_forward(self) -> bool:
        """reference: fusion_result.rs:454-460."""
        if self.right_gene.is_reversed():
            return self.right_gp.position < 0
        return self.right_gp.position > 0


def _trunc_div(a: int, b: int) -> int:
    """Rust integer division truncates toward zero (Python // floors)."""
    q = abs(a) // b
    return q if a >= 0 else -q


def _tail(s: str, k: int) -> str:
    """Last k chars; empty when k exceeds len(s) (reference usize-wrap
    behavior, see _calc_ed)."""
    if k <= 0 or k > len(s):
        return ""
    return s[len(s) - k :]


def _support_same(m1: "ReadMatch", m2: "ReadMatch") -> bool:
    """reference: fusion_result.rs:426-445."""
    if abs(m1.left_gp.position - m2.left_gp.position) > SUPPORT_TOLERANCE:
        return False
    if abs(m1.right_gp.position - m2.right_gp.position) > SUPPORT_TOLERANCE:
        return False
    if m1.left_gp.contig != m2.left_gp.contig:
        return False
    if m1.right_gp.contig != m2.right_gp.contig:
        return False
    return True
