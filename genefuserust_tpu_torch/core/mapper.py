"""FusionMapper: per-read matching, match bins, filters, clustering driver.

reference: src/core/fusion_mapper.rs:23-569. The mapper owns the panel
Indexer and the per-(left,right)-contig match bins (bin index =
n_fusions*right_contig + left_contig, fusion_mapper.rs:263), runs the
read -> ReadMatch conversion (make_match + calc_distance), the four match
filters, the deterministic sort, and greedy clustering into FusionResults.
The bins are sparse (`MatchBins`): the reference's n^2 lists, walked in
bin-index order, hold only the bins a match has landed in.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from ..config import DISTANCE_DIFF_THRESHOLD, Settings
from ..models.fusion import Fusion
from ..utils.spans import span
from .edit_distance import edit_distance
from .indexer import GenePos, Indexer, SeqMatch
from .read import SequenceRead
from .sequence import dis_connected_count, reverse_complement
from .fusion_result import FusionResult
from .matcher import Matcher, genome_index

log = logging.getLogger("genefuse")


@dataclasses.dataclass
class ReadMatch:
    """One candidate fusion-supporting read (reference: src/core/read_match.rs:18-54)."""

    read: SequenceRead
    read_break: int
    left_gp: GenePos
    right_gp: GenePos
    gap: int
    reversed: bool = False
    left_distance: int = 0
    right_distance: int = 0
    original_reads: List[SequenceRead] = dataclasses.field(default_factory=list)

    def sort_key(self):
        """Composite key for the reference's descending sort:
        read_break DESC, seq byte-length ASC, name DESC
        (reference: read_match.rs:203-229 composite cmp reversed by
        fusion_mapper.rs:384 `b.partial_cmp(a)`)."""
        return (-self.read_break, len(self.read.seq), _NegStr(self.read.name))


class _NegStr:
    """Descending-order wrapper for string sort keys."""

    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s

    def __lt__(self, other: "_NegStr") -> bool:
        return self.s > other.s

    def __eq__(self, other) -> bool:
        return self.s == other.s


class MatchBins:
    """The mapper's n x n match bins, keeping a bin only once it is asked
    for (`add_match` asks only to append to it). `len()` is n x n, as the
    reference's list of lists; `bins[i]` is bin i's list, kept from then on;
    iteration walks the kept bins in bin-index order, which is the order
    of the reference's walk over its non-empty lists. A 1,100-gene panel
    has 1.21M bins, of which a sample fills a few hundred."""

    __slots__ = ("_n", "_kept")

    def __init__(self, n_bins: int):
        self._n = n_bins
        self._kept: Dict[int, List["ReadMatch"]] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> List["ReadMatch"]:
        if not 0 <= i < self._n:
            raise IndexError("match bin index out of range")
        fm = self._kept.get(i)
        if fm is None:
            fm = self._kept[i] = []
        return fm

    def __iter__(self):
        kept = self._kept
        return (kept[i] for i in sorted(kept))

    def kept(self) -> int:
        """The bins held: what one walk over them visits."""
        return len(self._kept)


class FusionMapper:
    def __init__(
        self,
        contigs: Dict[str, str],
        fusion_file: str,
        settings: Settings = Settings(),
        multi_csv_mode: bool = False,
        index_cache_dir: str = "",
        ref_file: str = "",
    ):
        self.settings = settings
        self.multi_csv_mode = multi_csv_mode
        self.fusion_list = Fusion.parse_csv(fusion_file)
        self.indexer = Indexer(contigs, self.fusion_list, settings)
        cached = False
        if index_cache_dir and ref_file:
            from ..utils import index_cache

            cached = index_cache.load(index_cache_dir, ref_file, fusion_file, self.indexer)
        if not cached:
            self.indexer.make_index()
            if index_cache_dir and ref_file:
                from ..utils import index_cache

                index_cache.save(
                    index_cache_dir, ref_file, fusion_file, self.indexer
                )
        self.contigs = contigs
        n = len(self.fusion_list)
        self.fusion_matches = MatchBins(n * n)
        self.fusion_results: List[FusionResult] = []

    # ------------- per-read -------------

    def map_read(self, r: SequenceRead) -> Tuple[Optional[ReadMatch], bool]:
        """-> (match, mapable). reference: fusion_mapper.rs:93-132."""
        mapping = self.indexer.map_read(r.seq)
        if len(mapping) < 2:
            return None, False
        if not self.indexer.in_required_direction(mapping):
            return None, True
        return self.make_match(r, mapping), True

    def make_match(
        self, r: SequenceRead, mapping: List[SeqMatch], ed_batcher=None
    ) -> Optional[ReadMatch]:
        """reference: fusion_mapper.rs:154-194. With `ed_batcher` (a
        parallel.ed_batch.EdBatcher) the two edit distances are deferred to
        a batched device evaluation; distances are final after the
        batcher's flush()."""
        if len(mapping) != 2:
            return None
        left, right = mapping[0], mapping[1]
        if left.seq_start > right.seq_start:
            left, right = right, left
        read_break = (left.seq_end + right.seq_start) // 2
        left_gp = GenePos(left.start_gp.contig, left.start_gp.position + read_break)
        right_gp = GenePos(right.start_gp.contig, right.start_gp.position + read_break + 1)
        gap = right.seq_start - left.seq_end - 1
        m = ReadMatch(r, read_break, left_gp, right_gp, gap, False)
        self.calc_distance(m, ed_batcher)
        return m

    def calc_distance(self, m: ReadMatch, ed_batcher=None) -> None:
        """reference: fusion_mapper.rs:196-222."""
        seq = m.read.seq
        rb = m.read_break
        left_len = rb + 1
        right_len = len(seq) - left_len
        left_seq = seq[:left_len]
        right_seq = seq[left_len : left_len + right_len]
        self._calc_ed_into(
            left_seq,
            m.left_gp.contig,
            m.left_gp.position - left_len + 1,
            m.left_gp.position,
            lambda v: setattr(m, "left_distance", v),
            ed_batcher,
        )
        self._calc_ed_into(
            right_seq,
            m.right_gp.contig,
            m.right_gp.position,
            m.right_gp.position + right_len - 1,
            lambda v: setattr(m, "right_distance", v),
            ed_batcher,
        )

    def _prep_ed(self, seq: str, contig: int, start: int, end: int):
        """Sentinel/RC preparation shared by sync and deferred paths.
        -> int sentinel, or (query, ref_str) pair still to be measured."""
        if (start >= 0 and end <= 0) or (start <= 0 and end >= 0):
            return -1
        fseq = self.indexer.fusion_seq[contig]
        if abs(start) >= len(fseq) or abs(end) >= len(fseq):
            return -2
        if start < 0:
            seq = reverse_complement(seq)
            start, end = -end, -start
        return seq, fseq[start : end + 1]

    def calc_ed(self, seq: str, contig: int, start: int, end: int) -> int:
        """reference: fusion_mapper.rs:224-251 (sentinels -1 mixed-strand,
        -2 overflow; negative coords compare the reverse complement)."""
        prep = self._prep_ed(seq, contig, start, end)
        if isinstance(prep, int):
            return prep
        return edit_distance(*prep)

    def _calc_ed_into(self, seq, contig, start, end, setter, ed_batcher):
        prep = self._prep_ed(seq, contig, start, end)
        if isinstance(prep, int):
            setter(prep)
        elif ed_batcher is None:
            setter(edit_distance(*prep))
        else:
            ed_batcher.submit(prep[0], prep[1], setter)

    def add_match(self, m: ReadMatch) -> None:
        idx = len(self.fusion_list) * m.right_gp.contig + m.left_gp.contig
        self.fusion_matches[idx].append(m)

    # ------------- filters -------------

    def filter_matches(self) -> None:
        total = sum(len(fm) for fm in self.fusion_matches)
        log.info("sequence number before filtering: %d", total)
        with span("report.filter"):
            self.remove_by_complexity()
            self.remove_by_distance()
            self.remove_indels()
        with span("report.alignable"):
            self.remove_alignables()

    def remove_by_complexity(self) -> None:
        """reference: fusion_mapper.rs:298-321,559-569."""
        removed = 0
        for fm in self.fusion_matches:
            kept = []
            for rm in fm:
                seq = rm.read.seq
                rb = rm.read_break
                if _is_low_complexity(seq[: rb + 1]) or _is_low_complexity(seq[rb + 1 :]):
                    removed += 1
                else:
                    kept.append(rm)
            fm[:] = kept
        log.info("remove_by_complexity: %d", removed)

    def remove_by_distance(self) -> None:
        """reference: fusion_mapper.rs:323-348 (drop if left+right ed >= 5)."""
        removed = 0
        for fm in self.fusion_matches:
            kept = [
                rm
                for rm in fm
                if rm.left_distance + rm.right_distance < DISTANCE_DIFF_THRESHOLD
            ]
            removed += len(fm) - len(kept)
            fm[:] = kept
        log.info("removeByDistance: %d", removed)

    def remove_indels(self) -> None:
        """reference: fusion_mapper.rs:350-377."""
        thr = self.settings.deletion_threshold
        removed = 0
        for fm in self.fusion_matches:
            kept = [
                rm
                for rm in fm
                if not (
                    rm.left_gp.contig == rm.right_gp.contig
                    and abs(rm.left_gp.position - rm.right_gp.position) < thr
                )
            ]
            removed += len(fm) - len(kept)
            fm[:] = kept
        log.info("removeIndels: %d", removed)

    def remove_alignables(self) -> None:
        """reference: fusion_mapper.rs:488-542 — whole-genome alignability
        check through the (quirk-faithful) Matcher."""
        seqs = [rm.read.seq for fm in self.fusion_matches for rm in fm]
        log.info("making matcher...")
        # the genome index is built once per contigs object and shared by
        # every mapper over it; this mapper keeps it alive
        self.genome_index = genome_index(self.contigs)
        matcher = Matcher.over(self.genome_index, seqs)
        removed = 0
        log.info("removing alignable sequences...")
        for fm in self.fusion_matches:
            kept = []
            for rm in fm:
                if matcher.do_match(rm.read.seq) is not None:
                    removed += 1
                else:
                    kept.append(rm)
            fm[:] = kept
        log.info("removeAlignables: %d", removed)

    # ------------- sort + cluster -------------

    def sort_matches(self) -> None:
        for fm in self.fusion_matches:
            fm.sort(key=ReadMatch.sort_key)

    def cluster_matches(self) -> None:
        """reference: fusion_mapper.rs:399-486."""
        for fm in self.fusion_matches:
            frs: List[FusionResult] = []
            for rm in fm:
                for fr in frs:
                    if fr.support(rm):
                        fr.add_match(rm)
                        break
                else:
                    fr = FusionResult()
                    fr.add_match(rm)
                    frs.append(fr)
            for fr in frs:
                fr.calc_fusion_point()
                fr.make_reference(
                    self.indexer.fusion_seq[fr.left_gp.contig],
                    self.indexer.fusion_seq[fr.right_gp.contig],
                )
                fr.adjust_fusion_break()
                fr.calc_unique()
                fr.update_info(self.fusion_list)
                if fr.is_qualified(self.settings):
                    if not self.settings.output_deletions and fr.is_deletion():
                        continue
                    if fr.is_left_protein_forward() != fr.is_right_protein_forward():
                        if not self.settings.output_untranslated:
                            continue
                    if not self.multi_csv_mode:
                        fr.print_stdout()
                    self.fusion_results.append(fr)
        self.sort_fusion_results()
        log.info("found %d fusions", len(self.fusion_results))

    def sort_fusion_results(self) -> None:
        """descending by (unique, match count) — fusion_mapper.rs:544-556."""
        self.fusion_results.sort(key=lambda fr: (-fr.unique, -len(fr.matches)))

    def free_matches(self) -> None:
        self.fusion_matches = MatchBins(len(self.fusion_matches))


def _is_low_complexity(s: str) -> bool:
    """reference: fusion_mapper.rs:559-569."""
    if len(s) < 20:
        return True
    if dis_connected_count(s) < 7:
        return True
    return False
