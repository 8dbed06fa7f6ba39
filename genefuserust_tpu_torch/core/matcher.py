"""Whole-genome alignability checker ("Matcher") — quirk-faithful.

reference: src/core/matcher.rs:32-910. This component exists to drop
candidate reads that align to the reference genome in one piece
(remove_alignables). The reference Rust port carries two mistranslations
from the C++ original that define its OBSERVED behavior (SURVEY §2 row 8):

  1. `make_kmer_bytes`/`make_kmer` (matcher.rs:810-885) `break` out of the
     whole loop after the first base, so *initial/restart* k-mers are
     1-base values in {0..3}. Consequently:
       - the bloom filter seeded from candidate reads only ever sets bits
         0..3 of byte 0 (matcher.rs:64-88);
       - genome indexing (matcher.rs:227-289) uses an incremental encoder
         whose warm-up also starts from a 1-base value, so the stored key at
         contig position i is the 16-mer *ending* at i once warmed up, and a
         short prefix k-mer right after a restart;
       - only genome positions whose key value is <= 3 (poly-A-ish 16-mers
         "A"*16, "A"*15+{T,C,G}, or contig-start partials) survive the bloom
         gate — the genome index is tiny;
       - every *query* k-mer in map_to_index (matcher.rs:408-444) is a
         1-base value in {0..3}.
  2. The mask loop's membership check is inverted
     (`contains_key` -> skip, matcher.rs:486), after which the reference
     unconditionally unwraps the (absent) entry — i.e. the reference binary
     PANICS if that line is ever reached. On real genomes the 1-base query
     keys hit >50-position lists and are skipped in pass 1
     (skip_threshold=50, matcher.rs:397), so top counts stay 0, the mask
     loop never runs, and remove_alignables removes ~0 reads.

We reproduce this observed behavior exactly; reaching the
would-panic state raises RuntimeError with a clear message. A
`faithful-cpp` mode implementing the C++ intent is a possible future flag
(documented, not needed for parity).

Also note matcher.rs packs GenePos differently from the indexer:
gp_to_i64 here is contig<<32 + sign-extended position (matcher.rs:896-902).
"""

from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import KMER
from ..utils import spans
from .sequence import reverse_complement

log = logging.getLogger("genefuse")

SKIP_THRESHOLD = 50  # matcher.rs:397
TOP = 5  # matcher.rs:448


def _matcher_gp_to_i64(contig: int, position: int) -> int:
    """matcher.rs:896-902: contig<<32 PLUS sign-extended position."""
    return (contig << 32) + position


@dataclasses.dataclass
class MatchResult:
    start_contig: int
    start_position: int
    reversed: bool
    mismatches: List[int]


def _first_base_code(ch: int) -> int:
    if ch == ord("A"):
        return 0
    if ch == ord("T"):
        return 1
    if ch == ord("C"):
        return 2
    if ch == ord("G"):
        return 3
    return -1


_CODE_LUT = np.full(256, -1, np.int64)
_CODE_LUT[ord("A")] = 0
_CODE_LUT[ord("T")] = 1
_CODE_LUT[ord("C")] = 2
_CODE_LUT[ord("G")] = 3


def _scan_contigs(
    contigs: Dict[str, str], bloom_bits
) -> Tuple[List[str], Dict[int, List[Tuple[int, int]]]]:
    """matcher.rs:120-169 + index_contig_bytes:227-289, single-threaded
    deterministic order (name-sorted contigs) -> (contig names, key (quirky
    kmer value) -> list of (contig, position)), keeping the keys in
    `bloom_bits`."""
    from .. import native
    from .sequence import encode_bases

    contig_names: List[str] = []
    kmer_positions: Dict[int, List[Tuple[int, int]]] = {}
    for ctg, (name, seq) in enumerate(contigs.items()):
        contig_names.append(name)
        su = seq.upper()
        n = len(su)
        if n <= KMER:
            continue
        # native single-pass scan (capped run counters; exact same keep
        # set as the vectorized fallback below, cross-checked in tests)
        nat = native.matcher_scan(encode_bases(su), bloom_bits)
        if nat is not None:
            poss, keys = nat
            for k in range(4):
                sel = poss[keys == k]
                if len(sel):
                    kmer_positions.setdefault(k, []).extend(
                        (ctg, i) for i in sel.tolist()
                    )
            continue
        b = np.frombuffer(su.encode("latin-1"), np.uint8)
        codes = _CODE_LUT[b]
        # positions iterated: 0 .. n-KMER-1 (bound excludes last kmer)
        m = n - KMER
        # state machine: kmer value at i = packed codes of
        # [run_start_i .. i] truncated to the last 16 bases; invalid
        # base resets. Vectorized: standard rolling 16-mer with invalid
        # codes zeroed, masked down to min(run_len,16) bases.
        valid = codes >= 0
        c = np.where(valid, codes, 0).astype(np.uint64)
        # rolling 16-mer ending at i (for i>=15, positions before padded 0)
        cp = np.concatenate([np.zeros(KMER - 1, np.uint64), c])
        km = np.zeros(n, np.uint64)
        for j in range(KMER):
            km |= cp[j : j + n] << np.uint64(2 * (KMER - 1 - j))
        # run length ending at i (# consecutive valid up to and incl i):
        # index of last invalid before or at i
        inv_idx = np.where(valid, -1, np.arange(n))
        last_inv = np.maximum.accumulate(inv_idx)
        run = np.arange(n) - last_inv  # 0 where invalid
        w = np.minimum(run, KMER)
        mask = (np.uint64(1) << (2 * w.astype(np.uint64))) - np.uint64(1)
        kmv = (km & mask).astype(np.int64)
        keep = (run[:m] > 0) & (kmv[:m] <= 3) & np.isin(
            kmv[:m], list(bloom_bits) or [-99]
        )
        for i in np.nonzero(keep)[0].tolist():
            kmer_positions.setdefault(int(kmv[i]), []).append((ctg, int(i)))
    return contig_names, kmer_positions


class GenomeIndex:
    """The genome index of one contigs dict for every key 0-3 (the full
    bloom set). A position is kept whatever the bloom set iff its key is
    at most 3 and in the set, so the index of any set is this one with the
    other keys dropped, each remaining list unchanged (Matcher.over).
    Holds `contigs`, so that its id is not reused while the index lives."""

    def __init__(self, contigs: Dict[str, str]):
        self.contigs = contigs
        self.contig_names, self.kmer_positions = _scan_contigs(contigs, range(4))


# id(contigs) -> its GenomeIndex, while any holder (each FusionMapper that
# used it) keeps the index: mappers over one dict share one build, and no
# genome outlives its last holder
_SHARED: "weakref.WeakValueDictionary[int, GenomeIndex]" = weakref.WeakValueDictionary()


def genome_index(contigs: Dict[str, str]) -> GenomeIndex:
    """The GenomeIndex of this contigs object: built on the first call
    (span `report.matcher_index`), found on later ones (counter
    `matcher.index_reuse`) while a holder keeps it."""
    idx = _SHARED.get(id(contigs))
    if idx is not None and idx.contigs is contigs:
        spans.count("matcher.index_reuse", 1)
        return idx
    with spans.span("report.matcher_index"):
        idx = GenomeIndex(contigs)
    _SHARED[id(contigs)] = idx
    return idx


class Matcher:
    def __init__(self, contigs: Dict[str, str], seqs: List[str]):
        self._init_bloom(seqs)
        # key (quirky kmer value) -> list of (contig, position)
        self.contig_names, self.kmer_positions = _scan_contigs(contigs, self._bloom_bits)

    @classmethod
    def over(cls, index: GenomeIndex, seqs: List[str]) -> "Matcher":
        """Matcher(index.contigs, seqs) from a built GenomeIndex, no scan:
        the same names, lists and order (the lists are the index's own)."""
        m = cls.__new__(cls)
        m._init_bloom(seqs)
        m.contig_names = index.contig_names
        m.kmer_positions = {
            k: v for k, v in index.kmer_positions.items() if k in m._bloom_bits
        }
        return m

    # -------- bloom (quirky): set of first-base codes over read prefixes --------

    def _init_bloom(self, seqs: List[str]) -> None:
        """matcher.rs:64-88 via quirky make_kmer: bloom = the set of values
        code(seq[i]) for i in 0..len-16 over all candidate seqs and RCs."""
        bits = set()
        for s in seqs:
            for variant in (s, reverse_complement(s)):
                b = variant.encode("latin-1")
                n = len(b)
                if n < KMER:
                    # reference iterates 0..(len - 16 + 1); for len<16 the
                    # Rust range is empty only if len-16+1 <= 0 in usize
                    # arithmetic this would underflow-panic; reads are >=16bp
                    # in practice. Mirror: skip.
                    continue
                for i in range(0, n - KMER + 1):
                    c = _first_base_code(b[i])
                    if c >= 0:
                        bits.add(c)
        self._bloom_bits = bits

    # -------- query --------

    def do_match(self, seq: str) -> Optional[MatchResult]:
        """matcher.rs:662-689: better of fwd / RC by mismatch count."""
        mc = self.map_to_index(seq)
        rc = self.map_to_index(reverse_complement(seq))
        if rc is not None:
            rc.reversed = True
        if mc is None:
            return rc
        if rc is None:
            return mc
        return mc if len(mc.mismatches) <= len(rc.mismatches) else rc

    def map_to_index(self, seq: str) -> Optional[MatchResult]:
        """matcher.rs:388-529 with the quirks described above."""
        b = seq.encode("latin-1")
        seq_len = len(b)
        if seq_len < KMER:
            return None
        stat: Dict[int, int] = {0: 0}
        all_kmer = [0] * seq_len
        kmer_valid = [False] * seq_len
        skipped = [False] * seq_len
        for i in range(seq_len - KMER + 1):
            c = _first_base_code(b[i])  # quirky 1-base query kmer
            valid = c >= 0
            kmer_valid[i] = valid
            if not valid:
                continue
            all_kmer[i] = c
            plist = self.kmer_positions.get(c)
            if plist is None:
                stat[0] += 1
                continue
            if len(plist) > SKIP_THRESHOLD:
                skipped[i] = True
                continue
            # faithful bug: the shift uses the LIST INDEX, not the read
            # position (matcher.rs:432-437 shadowed loop variable)
            for li, (ctg, pos) in enumerate(plist):
                g = _matcher_gp_to_i64(ctg, pos - li)
                stat[g] = stat.get(g, 0) + 1

        topgp = [0] * TOP
        topcount = [0] * TOP
        for gp, count in stat.items():  # HashMap order; counts drive result
            if gp == 0 or count <= topcount[TOP - 1]:
                continue
            topgp[TOP - 1] = gp
            topcount[TOP - 1] = count
            for t in range(TOP - 2, -1, -1):
                if count > topcount[t]:
                    topcount[t + 1] = topcount[t]
                    topgp[t + 1] = topgp[t]
                    topcount[t] = count
                    topgp[t] = gp

        for t in range(TOP):
            if topcount[t] == 0:
                break
            # mask loop: inverted membership check; reaching a valid kmer
            # NOT in the index would make the reference binary panic.
            for i in range(seq_len - KMER + 1):
                if not kmer_valid[i] or all_kmer[i] in self.kmer_positions:
                    continue
                raise RuntimeError(
                    "Matcher::map_to_index reached the inverted-membership "
                    "unwrap (reference binary would panic here; "
                    "matcher.rs:486-491). Input outside supported envelope."
                )
            mismatches = list(range(seq_len))  # mask never set
            if len(mismatches) < 10:
                gp = topgp[t]
                return MatchResult(
                    (gp >> 32) & 0xFFFF, gp & 0xFFFFFFFF, False, mismatches
                )
        return None
