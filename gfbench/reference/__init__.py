"""The benchmark's plain reference: GeneFuse's semantics in NumPy and
Python, independent of the program under test.

A frozen copy of the port's host oracle (its scalar map_read, pair merge,
match assembly, filters, clustering and JSON report), rebuilt to import
nothing of the program: the index is built here from the panel's FASTA
and CSV files, and no table, weight or result of the program is read.

`Reference(fasta, csvs, settings)` holds one panel a CSV.
`pair_matches(pairs)` gives the matches each pair adds to each panel, as
`scan_one_pair` makes them, from an index of the panels' genes kept for
these pairs' k-mers; `report(matches)` gives each panel's JSON fusions
block after those matches are filtered, sorted and clustered.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .config import Settings
from .fasta import read_all
from .indexer import KmerTable, rolling_kmers
from .mapper import FusionMapper, ReadMatch
from .matcher import Matcher, bloom_bits
from .read import SequenceRead, SequenceReadPair
from .report import JsonReporter
from .scanner import scan_one_pair
from .sequence import encode_bases, reverse_complement

__all__ = ["Reference", "ReadMatch", "SequenceRead", "SequenceReadPair", "Settings"]


class Reference:
    """position_bits: the width the scan's gene positions are held in; 32
    as the reference holds them, fewer only for the control of the check
    (gfbench/control.py)."""

    def __init__(self, fasta: str, csvs: Sequence[str], settings: Settings,
                 position_bits: int = 32):
        self.settings = settings
        self.contigs = read_all(fasta)
        self._matchers: Dict[frozenset, Matcher] = {}
        self.mappers = [FusionMapper(self.contigs, csv, settings, self.matcher) for csv in csvs]
        for m in self.mappers:
            m.indexer.position_bits = position_bits

    def matcher(self, seqs: List[str]) -> Matcher:
        """The Matcher of these candidate reads, one a set of bloom bits."""
        bits = bloom_bits(seqs)
        if bits not in self._matchers:
            self._matchers[bits] = Matcher(self.contigs, bits)
        return self._matchers[bits]

    def _index(self, reads: List[SequenceRead]) -> None:
        """Index every panel's genes for the k-mers of these reads and
        their reverse complements: one table over the distinct gene
        regions of all panels."""
        regions: Dict[tuple, int] = {}
        per_panel = []
        for m in self.mappers:
            ids = []
            for f, s in zip(m.fusion_list, m.indexer.fusion_seq):
                g = f.gene
                key = (m.indexer.resolve_chr(g.chr), g.start, g.end)
                ids.append(-1 if key[0] is None else regions.setdefault(key, len(regions)))
            per_panel.append(ids)
        seqs = [""] * len(regions)
        for m, ids in zip(self.mappers, per_panel):
            for r, s in zip(ids, m.indexer.fusion_seq):
                if r >= 0:
                    seqs[r] = s
        wanted = [rolling_kmers(encode_bases(s))[0]
                  for r in reads for s in (r.seq, reverse_complement(r.seq))]
        table = KmerTable(seqs, np.concatenate(wanted) if wanted else np.zeros(0, np.uint32))
        for m, ids in zip(self.mappers, per_panel):
            m.indexer.attach(table, ids)

    def pair_matches(self, pairs: Sequence[SequenceReadPair]) -> List[List[List[ReadMatch]]]:
        """For each pair, the matches it adds to each panel (the panels'
        bins are left as they were)."""
        merged = [p.fast_merge() for p in pairs]
        self._index([r for p, mg in zip(pairs, merged)
                     for r in ([mg] if mg is not None else [p.left, p.right])])
        out = []
        for pair, mg in zip(pairs, merged):
            per_panel = []
            for m in self.mappers:
                added: List[ReadMatch] = []
                keep, m.add_match = m.add_match, added.append
                try:
                    scan_one_pair(m, pair, mg)
                finally:
                    m.add_match = keep
                per_panel.append(added)
            out.append(per_panel)
        return out

    def report(self, matches: Sequence[Sequence[ReadMatch]]) -> List[str]:
        """Each panel's JSON fusions block over `matches` (a list a panel,
        in scan order), through the filters, the sort and the clustering.
        The matches are changed on the way, as the reference changes them."""
        out = []
        for m, ms in zip(self.mappers, matches):
            n = len(m.fusion_list)
            m.fusion_matches = [[] for _ in range(n * n)]
            m.fusion_results = []
            for rm in ms:
                m.add_match(rm)
            m.filter_matches()
            m.sort_matches()
            m.cluster_matches()
            out.append(JsonReporter(m, self.settings).fusions_block())
            m.free_matches()
            m.fusion_results = []
        return out
