"""Sharded-index engine: panels whose table outgrows one device.

Port of `genefuserust_tpu/parallel/sharded_engine.py::ShardedIndexEngine`,
the product wrapper around `parallel/sharded_index.sharded_map_read`. The
index is partitioned by contig over a list of torch devices, one per
shard (a list may name one device several times: S tables on one card);
each read batch goes to every shard, and the shards' top-2 votes and flag
words are merged on the first device (the exactness argument is in
`parallel/sharded_index.py`).

Reachable from the CLI via `--engine sharded-index` (+ `--mesh N` for the
shard count, one shard a device). The host pair decision tree matches
pescanner.rs:427-518 exactly (as core/scanner.scan_one_pair); map_read is
the engine's device call, so report equality with the host oracle follows
from kernel equality (tests/test_torch_sharded_engine.py checks end to
end anyway). Edit distances go through the port's EdBatcher on the first
device.
"""

from __future__ import annotations

import logging
import time
from typing import Iterable, List, Tuple

import numpy as np
import torch

from ..config import Settings
from ..core.indexer import GenePos, SeqMatch
from ..core.read import SequenceRead
from ..core.sequence import encode_bases
from ..ops.map_read import MAX_SHARDS
from .ed_batch import EdBatcher, _round_up
from .engine import resolve_device
from .mesh import resolve_mesh
from .sharded_index import pack_index_sharded, shard_indexes, sharded_map_read, table_bytes

log = logging.getLogger("genefuse")


class ShardedIndexEngine:
    """Object-stream engine with a contig-sharded device index."""

    def __init__(self, settings: Settings, devices=None, batch_size: int = 4096):
        self.settings = settings
        if devices is None:
            devices = resolve_mesh("auto")
        self.devices = [resolve_device(d) for d in devices]
        if not 1 <= len(self.devices) <= MAX_SHARDS:
            raise ValueError(f"ShardedIndexEngine: 1 to {MAX_SHARDS} shards, "
                             f"got {len(self.devices)}")
        self.n_shards = len(self.devices)
        self.batch_size = batch_size
        self._prepared_for = None
        self._indexes = None
        self._installed = False  # use_tables: the same tables for every mapper
        self.ed_stats = {"jobs": 0, "device_sized": 0, "device": 0}
        # host seconds spent building and uploading the shard tables, and
        # the tables' bytes on the devices
        self.table_seconds = 0.0
        self.table_bytes = 0

    # ------------- index partitioning -------------

    def use_tables(self, indexes) -> None:
        """Install shard tables built before (`sharded_index.shard_indexes`,
        one per device of this engine): every mapper the engine scans then
        uses them, and the caller vouches that they are its panel's."""
        if [ix.table.device for ix in indexes] != self.devices:
            raise ValueError("use_tables: one table per device of the engine, in order")
        self._indexes = list(indexes)
        self._installed = True
        self.table_bytes = table_bytes(self._indexes)

    def _prepare(self, mapper) -> None:
        if self._installed or self._prepared_for is mapper:
            return
        t0 = time.perf_counter()
        _, packs = pack_index_sharded(mapper.indexer, self.n_shards, build_form=False)
        self._indexes = shard_indexes(packs, self.devices)
        self.table_seconds += time.perf_counter() - t0
        self.table_bytes = table_bytes(self._indexes)
        self._prepared_for = mapper
        log.info(
            "sharded device index ready: %d shards x %d buckets (%.1f MB/shard)",
            self.n_shards, packs[0].n_buckets, self.table_bytes / self.n_shards / 1e6,
        )

    # ------------- batched map_read -------------

    def _map_batch(self, seqs: List[str]):
        """-> per-seq list of SeqMatch (the valid segments)."""
        n = len(seqs)
        L = _round_up(max(32, max((len(s) for s in seqs), default=32)), 32)
        pb = 8
        while pb < n:
            pb *= 2
        codes = np.full((pb, L), 255, np.uint8)
        lens = np.zeros(pb, np.int32)
        for i, s in enumerate(seqs):
            c = encode_bases(s)
            codes[i, : len(c)] = c
            lens[i] = len(c)
        st = self.settings
        dev = self.devices[0]
        r = sharded_map_read(
            torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev), self._indexes,
            st.major_gene_key_requirement, st.minor_gene_key_requirement,
            st.mismatch_threshold,
        )
        sv, ss, se, sc, sp = (t.cpu().numpy() for t in r)
        out = []
        for i in range(n):
            segs = [
                SeqMatch(
                    int(ss[i, t]), int(se[i, t]),
                    GenePos(int(sc[i, t]), int(sp[i, t])),
                )
                for t in range(2)
                if bool(sv[i, t])
            ]
            out.append(segs)
        return out

    def _ed(self) -> EdBatcher:
        return EdBatcher(stats=self.ed_stats, device=self.devices[0])

    # ------------- object-stream API -------------

    def scan_pairs(self, mapper, pairs: Iterable) -> None:
        self._prepare(mapper)
        batch = []
        for pair in pairs:
            batch.append(pair)
            if len(batch) >= self.batch_size:
                self._scan_pair_batch(mapper, batch)
                batch = []
        if batch:
            self._scan_pair_batch(mapper, batch)

    def scan_singles(self, mapper, reads: Iterable) -> None:
        self._prepare(mapper)
        batch = []
        for r in reads:
            batch.append(r)
            if len(batch) >= self.batch_size:
                self._scan_single_batch(mapper, batch)
                batch = []
        if batch:
            self._scan_single_batch(mapper, batch)

    def _scan_pair_batch(self, mapper, pairs: List) -> None:
        """pescanner.rs:427-518 decision tree, with map_read batched."""
        merged = [p.fast_merge() for p in pairs]
        # lane work-list: (pair idx, lane, read) — lane 0 merged, 1/2 = R1/R2
        work: List[Tuple[int, int, SequenceRead]] = []
        for i, (p, m) in enumerate(zip(pairs, merged)):
            if m is not None:
                work.append((i, 0, m))
            else:
                work.append((i, 1, p.left))
                work.append((i, 2, p.right))
        segs = self._map_batch([r.seq for _, _, r in work])
        ed = self._ed()
        retries: List[Tuple[int, int, SequenceRead]] = []
        for (i, lane, r), mapping in zip(work, segs):
            if len(mapping) < 2:
                continue  # not mapable: no RC retry (pescanner.rs:448-454)
            if mapper.indexer.in_required_direction(mapping):
                m = mapper.make_match(r, mapping, ed_batcher=ed)
                m.original_reads = [pairs[i].left, pairs[i].right]
                mapper.add_match(m)
            else:
                retries.append((i, lane, r.reverse_complement()))
        if retries:
            rsegs = self._map_batch([r.seq for _, _, r in retries])
            for (i, lane, rc), mapping in zip(retries, rsegs):
                if len(mapping) < 2:
                    continue
                if not mapper.indexer.in_required_direction(mapping):
                    continue
                m = mapper.make_match(rc, mapping, ed_batcher=ed)
                m.original_reads = [pairs[i].left, pairs[i].right]
                if lane != 0:
                    # merged-lane RC matches keep reversed=False
                    # (faithful: pescanner.rs:465-468 vs :487-490)
                    m.reversed = True
                mapper.add_match(m)
        ed.flush()

    def _scan_single_batch(self, mapper, reads: List) -> None:
        segs = self._map_batch([r.seq for r in reads])
        ed = self._ed()
        retries: List[Tuple[SequenceRead, SequenceRead]] = []
        for (r, mapping) in zip(reads, segs):
            if len(mapping) < 2:
                continue
            if mapper.indexer.in_required_direction(mapping):
                m = mapper.make_match(r, mapping, ed_batcher=ed)
                m.original_reads = [r]
                mapper.add_match(m)
            else:
                retries.append((r, r.reverse_complement()))
        if retries:
            rsegs = self._map_batch([rc.seq for _, rc in retries])
            for (r, rc), mapping in zip(retries, rsegs):
                if len(mapping) < 2:
                    continue
                if not mapper.indexer.in_required_direction(mapping):
                    continue
                m = mapper.make_match(rc, mapping, ed_batcher=ed)
                m.original_reads = [r]
                m.reversed = True
                mapper.add_match(m)
        ed.flush()
