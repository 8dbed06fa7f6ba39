"""Scan orchestration: the paired-end decision tree.

reference: src/core/pescanner.rs:52-600, one pair at a time.

Per-pair decision tree (pescanner.rs:427-518):
  merge succeeded -> map merged; on miss-but-mapable map its RC (match kept
  WITHOUT the reversed flag — faithful to pescanner.rs:465-468); R1/R2 are
  never tried for merged pairs.
  else -> map R1 (RC fallback sets reversed=true), then R2 likewise.
"""

from __future__ import annotations

from .mapper import FusionMapper
from .read import SequenceReadPair


def scan_one_pair(mapper: FusionMapper, pair: SequenceReadPair, merged) -> None:
    """reference: pescanner.rs:427-518; merged: pair.fast_merge(), made
    once for every panel."""
    if merged is not None:
        mm, mapable = mapper.map_read(merged)
        if mm is not None:
            mm.original_reads = [pair.left, pair.right]
            mapper.add_match(mm)
        elif mapable:
            mmr, _ = mapper.map_read(merged.reverse_complement())
            if mmr is not None:
                mmr.original_reads = [pair.left, pair.right]
                mapper.add_match(mmr)
        return
    for r in (pair.left, pair.right):
        m, mapable = mapper.map_read(r)
        if m is not None:
            m.original_reads = [pair.left, pair.right]
            mapper.add_match(m)
        elif mapable:
            mr, _ = mapper.map_read(r.reverse_complement())
            if mr is not None:
                mr.original_reads = [pair.left, pair.right]
                mr.reversed = True
                mapper.add_match(mr)
