"""Panel k-mer index: construction + the exact map_read specification.

Reproduces the reference Indexer (src/core/indexer.rs:30-913):

Index build (make_index / index_contig, indexer.rs:122-241):
  - for each panel gene: slice [start, end) of its chromosome, uppercased;
    chromosome-name fallback `chr{X}` / strip-"chr" (indexer.rs:141-151);
    missing chromosome -> empty fusion_seq entry, gene skipped.
  - index forward (offset 0) and reverse complement (offset 1-len: negative
    positions encode the RC strand).
  - k-mer positions 0 .. len-KMER-1 (indexer.rs:188 — the final k-mer at
    len-KMER is EXCLUDED; faithful off-by-one).
  - duplicate k-mers: 1 occurrence -> direct GenePos; 2..=5 -> dupe list
    (all sites, insertion order); >=6 -> high-level dupe, dropped entirely
    (indexer.rs:202-239, threshold skip_key_dup_threshold=5).
  - The reference's 512MB "bloom filter" is an EXACT membership bitmap
    ((kmer>>3, kmer&7) is a bijection on 32-bit kmers, indexer.rs:243-250),
    so table-miss == bloom-miss; no separate structure is needed.

map_read (indexer.rs:252-538) — two passes over the read:
  pass 1 (stride 2): vote shifted genome positions gp-i (packed to i64 as
    contig<<32 | pos-as-u32-bits, indexer.rs:697-706); take top-2 by
    (count desc, first-seen-in-ascending-i64-order); require
    count1*2 >= major_req(40) and count2*2 >= minor_req(20).
  pass 2 (stride 1): per-base mask = max over covering k-mers of
    TOP(3) if |gplong-gp1|<=1, SECOND(2) if |gplong-gp2|<=1,
    NONE(1) if gplong==0 (NONE and UNKNOWN(0) are downstream-equivalent:
    both count as mismatches and neither blocks/extends segments);
    reject if >10 positions are <SECOND; segment_mask extracts the longest
    run per target allowing gaps<=10, keeping runs with end-start>20.

This scalar implementation is the correctness oracle for the batched device
kernels in ops/ (cross-validated in tests on random + real panels).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import (
    ALLOWED_GAP,
    DUPE_HIGH_LEVEL,
    DUPE_NORMAL_LEVEL,
    KMER,
    MATCH_NONE,
    MATCH_SECOND,
    MATCH_TOP,
    MATCH_UNKNOWN,
    PASS1_STEP,
    Settings,
    THRESHOLD_LEN,
)
from ..models.fusion import Fusion
from .. import native
from .sequence import encode_bases, reverse_complement

log = logging.getLogger("genefuse")


@dataclasses.dataclass
class GenePos:
    contig: int
    position: int

    def clone(self) -> "GenePos":
        return GenePos(self.contig, self.position)


@dataclasses.dataclass
class SeqMatch:
    seq_start: int
    seq_end: int
    start_gp: GenePos


def gp_to_i64(contig: int, position: int) -> int:
    """Pack (contig:i16, position:i32) -> i64 = contig<<32 | pos-bits.

    reference: src/core/indexer.rs:697-706 — the position's raw 32-bit
    two's-complement pattern fills the low word (zero-extended), so the ±1
    tolerance wraps across contig boundaries for positions -1/0; replicated
    exactly.
    """
    v = ((contig & 0xFFFFFFFF) << 32) | (position & 0xFFFFFFFF)
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def i64_to_gp(val: int) -> GenePos:
    """reference: src/core/indexer.rs:708-714 (arithmetic shift, truncate)."""
    contig = (val >> 32) & 0xFFFF
    if contig >= 1 << 15:
        contig -= 1 << 16
    pos = val & 0xFFFFFFFF
    if pos >= 1 << 31:
        pos -= 1 << 32
    return GenePos(contig, pos)


def rolling_kmers(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All KMER-length rolling k-mers of a 2-bit code array.

    Returns (kmers uint32 of length max(0, n-KMER+1), valid bool) where
    valid[i] iff codes[i:i+16] are all ACGT — matching the reference's
    rolling encoders (indexer.rs:789-850): an invalid base poisons exactly
    the windows containing it.
    """
    n = len(codes)
    if n < KMER:
        return np.zeros(0, np.uint32), np.zeros(0, bool)
    ok = codes != 255
    c = np.where(ok, codes, 0).astype(np.uint64)
    nk = n - KMER + 1
    km = np.zeros(nk, np.uint64)
    for j in range(KMER):
        km |= c[j : j + nk] << np.uint64(2 * (KMER - 1 - j))
    # window validity via prefix sums of invalid counts
    bad = (~ok).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[KMER:] - cs[:-KMER]) == 0
    return km.astype(np.uint32), valid


class Indexer:
    """Panel index over (contig -> sequence) + fusion list."""

    def __init__(
        self,
        contigs: Dict[str, str],
        fusions: List[Fusion],
        settings: Settings = Settings(),
    ):
        self.contigs = contigs
        self.fusions = fusions
        self.settings = settings
        self.fusion_seq: List[str] = []
        # grouped-array index representation (vectorized build):
        #   entries sorted by kmer (stable, preserving insertion order):
        #   uniq_keys (sorted uint32), group_start/group_count into se
        self.se_kmer: np.ndarray = np.zeros(0, np.uint32)
        self.se_contig: np.ndarray = np.zeros(0, np.int32)
        self.se_pos: np.ndarray = np.zeros(0, np.int32)
        self.uniq_keys: np.ndarray = np.zeros(0, np.uint32)
        self.group_start: np.ndarray = np.zeros(0, np.int64)
        self.group_count: np.ndarray = np.zeros(0, np.int64)
        self.unique_pos = 0
        self.dupe_pos = 0
        self._dicts: Optional[tuple] = None

    # ---------------- build ----------------

    def resolve_chr(self, chrom: str) -> Optional[str]:
        """Chromosome-name fallback (reference: src/core/indexer.rs:141-151)."""
        if chrom in self.contigs:
            return chrom
        if f"chr{chrom}" in self.contigs:
            return f"chr{chrom}"
        stripped = chrom.replace("chr", "")
        if stripped in self.contigs:
            return stripped
        return None

    def make_index(self) -> None:
        from ..utils.pbar import prepare_pbar

        pbar = prepare_pbar(len(self.fusions))
        pbar.set_message("making index...")
        all_entries: List[np.ndarray] = []  # columns: kmer, contig, pos
        for ctg, fusion in enumerate(self.fusions):
            pbar.inc(1)
            gene = fusion.gene
            chrom = self.resolve_chr(gene.chr)
            if chrom is None:
                self.fusion_seq.append("")
                continue
            s = self.contigs[chrom][gene.start : gene.end].upper()
            for seq, start in ((s, 0), (reverse_complement(s), 1 - len(s))):
                codes = encode_bases(seq)
                # EXCLUDE the final k-mer (reference off-by-one, indexer.rs:188)
                nat = native.rolling_entries(codes, ctg, start, exclude_last=True)
                if nat is not None:
                    all_entries.append(nat)
                else:
                    km, valid = rolling_kmers(codes)
                    if len(km) > 0:
                        km, valid = km[:-1], valid[:-1]
                    idx = np.nonzero(valid)[0]
                    all_entries.append(
                        (
                            km[idx],
                            np.full(len(idx), ctg, np.int32),
                            (idx + start).astype(np.int32),
                        )
                    )
            self.fusion_seq.append(s)

        if all_entries:
            kmers_all = np.concatenate([e[0] for e in all_entries])
            ctg_all = np.concatenate([e[1] for e in all_entries])
            pos_all = np.concatenate([e[2] for e in all_entries])
        else:
            kmers_all = np.zeros(0, np.uint32)
            ctg_all = np.zeros(0, np.int32)
            pos_all = np.zeros(0, np.int32)

        # group by kmer preserving insertion order (stable radix sort of
        # whole records: streaming passes, no random gathers)
        n = len(kmers_all)
        srt = native.sort_entries_by_kmer(kmers_all, ctg_all, pos_all)
        if srt is not None:
            self.se_kmer, self.se_contig, self.se_pos = srt
        else:
            order = np.argsort(kmers_all, kind="stable")
            # numpy fallback: apply the permutation in ONE random-access
            # pass over packed 12-byte records instead of three 4-byte
            # passes — the permute is memory-LATENCY bound (one cache miss
            # per element), so batching the columns is ~3x cheaper
            rec = np.empty(
                n, dtype=[("k", np.uint32), ("c", np.int32), ("p", np.int32)]
            )
            rec["k"] = kmers_all
            rec["c"] = ctg_all
            rec["p"] = pos_all
            rec = rec[order]
            self.se_kmer = np.ascontiguousarray(rec["k"])
            self.se_contig = np.ascontiguousarray(rec["c"])
            self.se_pos = np.ascontiguousarray(rec["p"])
        sk = self.se_kmer
        if len(sk):
            # entries are kmer-sorted: group boundaries by adjacency
            starts = native.group_starts(sk)
            if starts is None:
                first = np.empty(n, bool)
                first[0] = True
                np.not_equal(sk[1:], sk[:-1], out=first[1:])
                starts = np.nonzero(first)[0]  # int64 already
            counts = np.empty(len(starts), np.int64)
            if len(starts) > 1:
                np.subtract(starts[1:], starts[:-1], out=counts[:-1])
            counts[-1] = n - starts[-1]
            self.uniq_keys = sk[starts]
        else:
            starts = np.zeros(0, np.int64)
            counts = np.zeros(0, np.int64)
            self.uniq_keys = np.zeros(0, np.uint32)
        self.group_start = starts
        self.group_count = counts
        self.unique_pos = int(np.count_nonzero(counts == 1))
        self.dupe_pos = int(np.count_nonzero(counts > 1))
        log.info("mapper indexing done.")

    # ---- dict views (tests / small-panel oracle introspection) ----

    def _build_dicts(self):
        if self._dicts is not None:
            return self._dicts
        thr = self.settings.skip_key_dup_threshold
        kmer_gp, kmer_dupe, kmer_high = {}, {}, set()
        for k, s0, c in zip(
            self.uniq_keys.tolist(),
            self.group_start.tolist(),
            self.group_count.tolist(),
        ):
            if c == 1:
                kmer_gp[k] = (int(self.se_contig[s0]), int(self.se_pos[s0]))
            elif c <= thr:
                kmer_dupe[k] = [
                    (int(self.se_contig[j]), int(self.se_pos[j]))
                    for j in range(s0, s0 + c)
                ]
            else:
                kmer_high.add(k)
        self._dicts = (kmer_gp, kmer_dupe, kmer_high)
        return self._dicts

    @property
    def kmer_gp(self):
        return self._build_dicts()[0]

    @property
    def kmer_dupe(self):
        return self._build_dicts()[1]

    @property
    def kmer_high(self):
        return self._build_dicts()[2]

    # ---------------- query (scalar oracle) ----------------

    def _candidates(self, kmer: int):
        """Expand one k-mer to its vote candidates.

        Returns None for a table miss ("bloom miss"), [] for a high-level
        dupe (skipped), else list of (contig, pos)."""
        j = int(np.searchsorted(self.uniq_keys, np.uint32(kmer)))
        if j >= len(self.uniq_keys) or int(self.uniq_keys[j]) != kmer:
            return None
        c = int(self.group_count[j])
        if c > self.settings.skip_key_dup_threshold:
            return []
        s0 = int(self.group_start[j])
        return [
            (int(self.se_contig[i]), int(self.se_pos[i])) for i in range(s0, s0 + c)
        ]

    def map_read(self, seq: str) -> List[SeqMatch]:
        st = self.settings
        codes = encode_bases(seq.encode("latin-1"))
        seqlen = len(codes)
        km, valid = rolling_kmers(codes)
        nk = len(km)
        if nk == 0:
            return []

        # pass 1: vote
        stat: Dict[int, int] = {}
        for i in range(0, nk, PASS1_STEP):
            if not valid[i]:
                continue
            cand = self._candidates(int(km[i]))
            if cand is None or not cand:
                continue
            for ctg, pos in cand:
                g = gp_to_i64(ctg, pos - i)
                stat[g] = stat.get(g, 0) + 1

        gp1 = gp2 = 0
        count1 = count2 = 0
        for k in sorted(stat):  # BTreeMap ascending-i64 iteration
            v = stat[k]
            if k != 0 and v > count1:
                gp2, count2 = gp1, count1
                gp1, count1 = k, v
            elif k != 0 and v > count2:
                gp2, count2 = k, v

        if (
            count1 * PASS1_STEP < st.major_gene_key_requirement
            or count2 * PASS1_STEP < st.minor_gene_key_requirement
        ):
            return []

        # pass 2: mask
        mask = np.zeros(seqlen, np.uint8)
        for i in range(nk):
            if not valid[i]:
                continue
            cand = self._candidates(int(km[i]))
            if cand is None or not cand:
                continue
            for ctg, pos in cand:
                g = gp_to_i64(ctg, pos - i)
                if abs(g - gp1) <= 1:
                    flag = MATCH_TOP
                elif abs(g - gp2) <= 1:
                    flag = MATCH_SECOND
                elif g == 0:
                    flag = MATCH_NONE
                else:
                    continue
                end = min(seqlen, i + KMER)
                np.maximum(mask[i:end], flag, out=mask[i:end])

        mismatches = int(np.count_nonzero(mask < MATCH_SECOND))
        if mismatches > st.mismatch_threshold:
            return []

        return segment_mask(mask, seqlen, i64_to_gp(gp1), i64_to_gp(gp2))

    def in_required_direction(self, mapping: Sequence[SeqMatch]) -> bool:
        """Canonicalize supporting-read strand orientation.

        reference: src/core/indexer.rs:541-608 — including the final
        self-comparison bug (left vs left, :597-598) which makes the
        same-reversal+same-contig case always return False.
        """
        if len(mapping) < 2:
            return False
        left, right = mapping[0], mapping[1]
        if left.seq_start > right.seq_start:
            left, right = right, left
        if left.start_gp.position > 0 and right.start_gp.position > 0:
            return True
        if left.start_gp.position < 0 and right.start_gp.position < 0:
            return False
        lrev = self.fusions[left.start_gp.contig].is_reversed()
        rrev = self.fusions[right.start_gp.contig].is_reversed()
        if lrev and not rrev:
            return False
        if not lrev and rrev:
            return True
        if left.start_gp.contig < right.start_gp.contig:
            return True
        # faithful bug: compares left to itself -> always False
        if left.start_gp.contig == right.start_gp.contig and abs(
            left.start_gp.position
        ) < abs(left.start_gp.position):
            return True
        return False


def segment_mask(
    mask: np.ndarray, seqlen: int, gp1: GenePos, gp2: GenePos
) -> List[SeqMatch]:
    """Extract the longest run per target flag.

    reference: src/core/indexer.rs:616-679. A run of `target` positions may
    bridge gaps of up to 10 positions of values < target; a value > target
    blocks extension; a target at the final position cannot START a run;
    kept if span end-start > 20. First-longest wins (strict >).
    """
    result: List[SeqMatch] = []
    for target, gp in ((MATCH_TOP, gp1), (MATCH_SECOND, gp2)):
        max_start = -1
        max_end = -1
        start = 0
        while True:
            while start != seqlen - 1 and mask[start] != target:
                start += 1
            if start >= seqlen - 1:
                break
            if mask[start] == target:
                end = start + 1
                g = 0
                while g < ALLOWED_GAP and end + g < seqlen:
                    if mask[end + g] > target:
                        break
                    if mask[end + g] == target:
                        end += g + 1
                        g = 0
                        continue
                    g += 1
                end -= 1
                if end - start > max_end - max_start:
                    max_end = end
                    max_start = start
                start += 1
            else:
                break
        if max_end - max_start > THRESHOLD_LEN:
            result.append(SeqMatch(max_start, max_end, gp.clone()))
    return result
