"""Scan orchestration: paired-end / single-end pipelines.

reference: src/core/pescanner.rs:52-600 and src/core/sescanner.rs:47-473.
The reference's producer/consumer thread pipeline over 1000-read packs is
replaced by a batched engine interface: the host engine processes reads one
by one through the scalar oracle; the batch engine (parallel/engine.py)
processes large batches on the device with identical semantics.

Per-pair decision tree (pescanner.rs:427-518):
  merge succeeded -> map merged; on miss-but-mapable map its RC (match kept
  WITHOUT the reversed flag — faithful to pescanner.rs:465-468); R1/R2 are
  never tried for merged pairs.
  else -> map R1 (RC fallback sets reversed=true), then R2 likewise.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional

from ..config import Settings
from ..utils import spans
from ..utils.spans import span
from .mapper import FusionMapper, ReadMatch
from .read import SequenceRead, SequenceReadPair

log = logging.getLogger("genefuse")


class HostEngine:
    """Scalar per-read engine: the correctness oracle."""

    def scan_pairs(self, mapper: FusionMapper, pairs: Iterable[SequenceReadPair]):
        for pair in pairs:
            scan_one_pair(mapper, pair)

    def scan_singles(self, mapper: FusionMapper, reads: Iterable[SequenceRead]):
        for r in reads:
            scan_one_single(mapper, r)


def scan_one_pair(mapper: FusionMapper, pair: SequenceReadPair) -> None:
    """reference: pescanner.rs:427-518."""
    merged = pair.fast_merge()
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


def scan_one_single(mapper: FusionMapper, r: SequenceRead) -> None:
    """reference: sescanner.rs:183-205."""
    m, mapable = mapper.map_read(r)
    if m is not None:
        m.original_reads = [r]
        mapper.add_match(m)
    elif mapable:
        mr, _ = mapper.map_read(r.reverse_complement())
        if mr is not None:
            mr.original_reads = [r]
            mr.reversed = True
            mapper.add_match(mr)


class Scanner:
    """Single-CSV scan over preloaded reference contigs."""

    def __init__(
        self,
        fusion_file: str,
        contigs: Dict[str, str],
        html_file: str,
        json_file: str,
        settings: Settings = Settings(),
        engine=None,
        multi_csv_mode: bool = False,
        command: str = "",
        index_cache_dir: str = "",
        ref_file: str = "",
    ):
        self.fusion_file = fusion_file
        self.contigs = contigs
        self.html_file = html_file
        self.json_file = json_file
        self.settings = settings
        self.engine = engine or HostEngine()
        self.multi_csv_mode = multi_csv_mode
        self.command = command
        self.index_cache_dir = index_cache_dir
        self.ref_file = ref_file

    def scan_pairs(self, pairs: Iterable[SequenceReadPair]) -> FusionMapper:
        mapper = FusionMapper(
            self.contigs,
            self.fusion_file,
            self.settings,
            self.multi_csv_mode,
            self.index_cache_dir,
            self.ref_file,
        )
        self.engine.scan_pairs(mapper, pairs)
        return self._finish(mapper)

    def scan_singles(self, reads: Iterable[SequenceRead]) -> FusionMapper:
        mapper = FusionMapper(
            self.contigs,
            self.fusion_file,
            self.settings,
            self.multi_csv_mode,
            self.index_cache_dir,
            self.ref_file,
        )
        self.engine.scan_singles(mapper, reads)
        return self._finish(mapper)

    def scan_pair_block(self, block) -> FusionMapper:
        """Vectorized path over an io.fastq_block.PairBlock."""
        mapper = FusionMapper(
            self.contigs,
            self.fusion_file,
            self.settings,
            self.multi_csv_mode,
            self.index_cache_dir,
            self.ref_file,
        )
        if hasattr(self.engine, "scan_pair_block"):
            self.engine.scan_pair_block(mapper, block)
        else:
            self.engine.scan_pairs(
                mapper, (block.pair_obj(i) for i in range(len(block)))
            )
        return self._finish(mapper)

    def scan_pair_stream(self, blocks) -> FusionMapper:
        """Streamed scan over an iterator of PairBlocks (large inputs)."""
        mapper = FusionMapper(
            self.contigs,
            self.fusion_file,
            self.settings,
            self.multi_csv_mode,
            self.index_cache_dir,
            self.ref_file,
        )
        bs = getattr(self.engine, "batch_size", 0)
        if bs:
            # re-chunk byte-sized stream blocks to exact batch multiples:
            # ragged tails at chunk boundaries cost ~20% extra padded
            # dispatches otherwise (io.fastq_block.coalesce_pair_blocks)
            from ..io.fastq_block import coalesce_pair_blocks

            blocks = coalesce_pair_blocks(blocks, bs)
        for block in blocks:
            if hasattr(self.engine, "scan_pair_block"):
                self.engine.scan_pair_block(mapper, block)
            else:
                self.engine.scan_pairs(
                    mapper, (block.pair_obj(i) for i in range(len(block)))
                )
        return self._finish(mapper)

    def scan_single_stream(self, blocks) -> FusionMapper:
        mapper = FusionMapper(
            self.contigs,
            self.fusion_file,
            self.settings,
            self.multi_csv_mode,
            self.index_cache_dir,
            self.ref_file,
        )
        bs = getattr(self.engine, "batch_size", 0)
        if bs:
            from ..io.fastq_block import coalesce_read_blocks

            blocks = coalesce_read_blocks(blocks, bs)
        for rblock in blocks:
            if hasattr(self.engine, "scan_single_block"):
                self.engine.scan_single_block(mapper, rblock)
            else:
                self.engine.scan_singles(
                    mapper, (rblock.read_obj(i) for i in range(len(rblock)))
                )
        return self._finish(mapper)

    def scan_single_block(self, rblock) -> FusionMapper:
        mapper = FusionMapper(
            self.contigs,
            self.fusion_file,
            self.settings,
            self.multi_csv_mode,
            self.index_cache_dir,
            self.ref_file,
        )
        if hasattr(self.engine, "scan_single_block"):
            self.engine.scan_single_block(mapper, rblock)
        else:
            self.engine.scan_singles(
                mapper, (rblock.read_obj(i) for i in range(len(rblock)))
            )
        return self._finish(mapper)

    def _finish(self, mapper: FusionMapper) -> FusionMapper:
        if hasattr(self.engine, "flush"):
            self.engine.flush(mapper)
        finish_scan(mapper, self.html_file, self.json_file, self.command, self.settings)
        return mapper


def finish_scan(
    mapper: FusionMapper,
    html_file: str,
    json_file: str,
    command: str,
    settings: Settings,
) -> None:
    """Post-scan pipeline tail: filters, deterministic sort, clustering,
    reports (pescanner.rs:334-346). Shared by Scanner and the multi-CSV
    driver path."""
    with span("report.finish_scan"):
        spans.count("report.bins_walked", mapper.fusion_matches.kept())
        mapper.filter_matches()
        with span("report.sort"):
            mapper.sort_matches()
        with span("report.cluster"):
            mapper.cluster_matches()
        with span("report.write"):
            if html_file:
                from ..report.html import HtmlReporter

                HtmlReporter(html_file, mapper, command, settings).run()
            if json_file:
                from ..report.json import JsonReporter

                JsonReporter(json_file, mapper, command, settings).run()
        mapper.free_matches()
