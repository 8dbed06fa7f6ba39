"""TorchEngine: host merge + one-call device scan + host assembly, on torch
tensors and the CUDA kernels of this package.

Port of the JAX package's batch engine (`genefuserust_tpu/parallel/
engine.py::TpuEngine`), which replaces the reference's producer/consumer
thread pipeline (src/core/pescanner.rs:296-425):

  producer thread: FASTQ byte matrices -> native C++ overlap merge
        (gf_merge_pack_pe2, bit-exact with fast_merge / read.rs:313-440)
        -> width-bucketed lane compaction -> 2-bit code pack (+ non-ACGT
        exception list) -> upload. Quality scores never leave the host.
  device: one `ops/fused.py::fused_scan_lanes` call per batch: vote pass
        over the lanes -> survivor compaction in row order -> mask/segment
        pass over the first `cap` survivors. One (cap + 1, 13) result per
        batch comes back; the vote bitmap is read only on cap overflow.
  host assembly: segment -> direction check -> make_match + batched edit
        distances -> match bins; direction-rejected rows go to a deferred
        batched reverse-complement retry (pescanner.rs:455-513).
  Assembly is readiness-gated: up to `pipeline_depth` batches ride the
  device pipe at once. The single-end path is the same pipeline with one
  read lane; `scan_pair_block_multi` merges, packs and uploads a batch
  once for many panels (multi-CSV, fusion_scan.rs:62-188).

What differs from the JAX engine:

  - uploads go through pinned host buffers with non-blocking copies; the
    producer thread copies on its own stream and records an event that
    the scan's stream waits on (and `record_stream` keeps the allocator
    from reusing the buffers early);
  - the result comes back by a non-blocking copy into pinned memory, and
    readiness is a CUDA event query (no fetch thread);
  - nothing is compiled per shape, so the compile pool and the shape
    memos go: lanes are padded to a multiple of 32 rows and take their
    exact widths;
  - edit distances go through this package's EdBatcher, and the index
    table comes from this package's builder (`ops/index.py`);
  - several devices take whole batches in turn, where the JAX engine
    splits each batch over a mesh (`TpuEngine(mesh=...)`, jit's SPMD
    partitioning of one batch, tables replicated;
    genefuserust_tpu/parallel/engine.py:175-199). `devices` is a list of
    torch devices, which may repeat one: batch k goes to entry k mod n,
    each entry with its own upload and compute stream on its device, and
    each mapper's table sits once on each distinct device. A batch runs
    `fused_scan_lanes` exactly as on one device (the same survivor cap and
    compaction), its survivor-cap overflow rescans on its own entry, the
    reverse-complement retries and the edit distances run on entry 0, and
    assembly takes the batches in order, so the reports do not depend on
    the number of entries or on which finishes first. One entry is the
    single-device engine: it scans on the current stream.

Results are identical to the host oracle (tests/test_torch_engine.py).
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch

from .. import native
from ..config import KMER, MIN_OVERLAP, Settings
from ..core.indexer import GenePos, SeqMatch
from ..core.read import SequenceRead, SequenceReadPair
from ..core.scanner import scan_one_pair
from ..core.sequence import BASE_CODE_LUT
from ..ops.fused import fused_scan_lanes
from ..ops.index import TABLE_SPANS, build_packed_index, index_to_torch
from ..utils import spans
from ..utils.pbar import prepare_pbar
from .ed_batch import EdBatcher, _round_up

log = logging.getLogger("genefuse")


def resolve_device(device) -> torch.device:
    """A device the engine can run on; a CUDA device requires a GPU (no
    silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index ("cuda" -> "cuda:<current>"), so that
    one card named two ways holds one table copy."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _tokenize_bytes(strings: List[bytes], L: int) -> Tuple[np.ndarray, np.ndarray]:
    arr = np.zeros((len(strings), L), np.uint8)
    lens = np.zeros(len(strings), np.int32)
    for i, s in enumerate(strings):
        n = len(s)
        arr[i, :n] = np.frombuffer(s, np.uint8)
        lens[i] = n
    return arr, lens


class _Result:
    """A device result on its way to the host: CUDA tensors are copied
    into pinned memory behind an event; CPU tensors are ready at once."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t
            self._event = None

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class _Entry:
    """One entry of the engine's device list. Entries are told apart by
    position, not by device: a list may name one card several times, and
    each entry then has its own streams on it. `stream` is None for a
    CPU device and for the single-device engine (the current stream)."""

    __slots__ = ("device", "stream", "upload_stream", "batches")

    def __init__(self, device: torch.device, own_stream: bool):
        self.device = device
        self.stream = torch.cuda.Stream(device) if own_stream else None
        self.upload_stream = None  # made by the producer thread at first use
        self.batches = 0


class TorchEngine:
    """Batched paired-end / single-end engine on one torch device, or on a
    list of them (whole batches in turn)."""

    # Stage graph: 0 issue-scan -> 1 assemble -> 2 done. The whole device
    # scan is ONE call issued at stage 0; assembly waits until the batch's
    # result has landed (or the pipe is full).
    _N_STAGES = 2

    def __init__(self, settings: Settings, batch_size: int = 65536,
                 device="cuda", pipeline_depth: int = 6, devices=None):
        self.settings = settings
        self.batch_size = batch_size
        devs = [_indexed(resolve_device(d)) for d in (devices or [device])]
        if not devs:
            raise ValueError("TorchEngine: empty device list")
        self._entries = [_Entry(d, len(devs) > 1 and d.type == "cuda") for d in devs]
        self.devices = devs
        # entry 0: edit distances and reverse-complement retries
        self.device = devs[0]
        self._n_batches = 0
        # in-flight batch bound (the `-t` analog; see driver.make_engine)
        self.pipeline_depth = max(1, pipeline_depth)
        self._prepared_for = None
        self._default_entry = None
        self._tables = {}  # id(mapper) -> table entry dict
        self._progress_t0 = None
        self._progress_n = 0
        self._queue = []
        self._producer = None  # merge/pack/upload producer thread pool
        # producer parallelism: batches are independent and each keeps its
        # own future, so more workers change only the overlap, not results
        self._producer_workers = int(os.environ.get("GENEFUSE_PRODUCER_WORKERS", "1"))
        # deferred RC retries: id(mapper) -> (mapper, [(lane, rc, originals)]),
        # flushed at a threshold and on engine flush; the output is order-
        # invariant (deterministic sort before clustering)
        self._retry_pend = {}
        self._retry_flush_at = 4096
        # survivors carried by one batch's result; beyond it _p2_overflow
        # rescans the rest (the JAX engine's value, from its TPU A/B)
        self._surv_cap = 1024
        # the process's spans and counters (utils/spans.py): label ->
        # [total_s, calls] or [count, events]
        self._timers = spans.REGISTRY
        # edit-distance job counts (see EdBatcher)
        self.ed_stats = {"jobs": 0, "device_sized": 0, "device": 0}
        # host seconds this engine spent building and uploading device
        # index tables (its share of the table.* spans)
        self.table_seconds = 0.0

    def _submit_producer(self, entry: _Entry, fn, *args):
        if self._producer is None:
            self._producer = ThreadPoolExecutor(max_workers=self._producer_workers)
        return self._producer.submit(self._with_upload_stream, entry, fn, *args)

    def _next_entry(self) -> _Entry:
        """The entry of the next batch: batch k goes to entry k mod n."""
        e = self._entries[self._n_batches % len(self._entries)]
        self._n_batches += 1
        e.batches += 1
        return e

    @property
    def entry_batches(self) -> List[int]:
        """Batches placed on each entry of the device list so far."""
        return [e.batches for e in self._entries]

    def _ed(self) -> EdBatcher:
        return EdBatcher(stats=self.ed_stats, device=self.device)

    # ------------- uploads -------------

    def _put_batch(self, x, device: torch.device):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cpu":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def _with_upload_stream(self, entry: _Entry, produce, *args):
        """Run a producer on its entry's upload stream; the batch carries
        the event that orders its uploads before the scan."""
        if entry.device.type == "cpu":
            return produce(*args, entry=entry)
        if entry.upload_stream is None:
            entry.upload_stream = torch.cuda.Stream(entry.device)
        with torch.cuda.stream(entry.upload_stream):
            out = produce(*args, entry=entry)
            ev = torch.cuda.Event()
            ev.record(entry.upload_stream)
        out["upload_event"] = ev
        return out

    def _adopt_uploads(self, sh: dict) -> None:
        """Order the batch's uploads before the work on the current stream
        (the batch's entry's, inside `torch.cuda.stream(entry.stream)`)."""
        ev = sh.pop("upload_event", None)
        if ev is None:
            return
        cur = torch.cuda.current_stream(sh["entry"].device)
        cur.wait_event(ev)
        for t in (*sh["bufs_d"], sh["lens_d"], sh["exc_d"]):
            t.record_stream(cur)

    # ------------- index -------------

    def _entry_from_packed(self, packed) -> dict:
        """The table entry of a packed index: one copy on each distinct
        device of the list."""
        indexes = {}
        with spans.span("table.upload"):
            for e in self._entries:
                if e.device not in indexes:
                    indexes[e.device] = index_to_torch(packed, e.device)
        return dict(packed=packed, indexes=indexes)

    def _table_built(self, build: Callable):
        """build() -> its result, its table.* span seconds added to
        table_seconds."""
        t0 = spans.REGISTRY.seconds(*TABLE_SPANS)
        out = build()
        self.table_seconds += spans.REGISTRY.seconds(*TABLE_SPANS) - t0
        return out

    def use_packed(self, packed, mapper=None) -> None:
        """Install a pre-built table. With `mapper`, it is bound to that
        mapper at once; without, the first mapper `_table_entry` sees
        takes it."""
        entry = self._table_built(lambda: self._entry_from_packed(packed))
        if mapper is not None:
            entry["mapper"] = mapper
            self._tables[id(mapper)] = entry
        else:
            self._default_entry = entry
            self._prepared_for = None

    def _table_entry(self, mapper) -> dict:
        """The mapper's table, built at first use: entries are keyed by
        id(mapper) and pin their mapper, so the id cannot be reused by
        another mapper while the entry lives."""
        key = id(mapper)
        e = self._tables.get(key)
        if e is not None:
            assert e.get("mapper") is mapper
            return e
        if self._default_entry is not None and (
            self._prepared_for is None or self._prepared_for is mapper
        ):
            e, self._default_entry = self._default_entry, None
            e["mapper"] = mapper
            self._tables[key] = e
            return e
        s0 = self.table_seconds
        e = self._table_built(lambda: self._entry_from_packed(
            build_packed_index(mapper.indexer)))
        packed = e["packed"]
        e["mapper"] = mapper
        self._tables[key] = e
        log.info("device index ready: %d buckets, %.1f MB%s, %.2f s", packed.n_buckets,
                 packed.nbytes / 1e6, " (kv rows)" if hasattr(packed, "kv_tbl") else "",
                 self.table_seconds - s0)
        return e

    def _prepare(self, mapper) -> None:
        self._table_entry(mapper)

    def _pad_rows(self, n: int) -> int:
        return max(32, _round_up(n, 32))

    def _progress(self, n: int) -> None:
        """Scan progress: a spinner with reads/s on a TTY (reference
        progress bars: src/aux/pbar.rs), throughput log lines otherwise."""
        if self._progress_t0 is None:
            self._progress_t0 = time.time()
            self._pbar = prepare_pbar(0)
            self._pbar.set_message("scanning reads...")
        self._progress_n += n
        self._pbar.inc(n)
        dt = time.time() - self._progress_t0
        if self._pbar.is_hidden() and dt > 0 and self._progress_n % (self.batch_size * 8) < n:
            log.info("scanned %d reads (%.0f reads/s)", self._progress_n,
                     self._progress_n / dt)

    # ------------- public API: object streams -------------

    def scan_pairs(self, mapper, pairs: Iterable) -> None:
        self._prepare(mapper)
        batch: List = []
        for pair in pairs:
            batch.append(pair)
            if len(batch) >= self.batch_size:
                self._pairs_from_objects(mapper, batch)
                batch = []
        if batch:
            self._pairs_from_objects(mapper, batch)

    def scan_singles(self, mapper, reads: Iterable) -> None:
        self._prepare(mapper)
        batch: List = []
        for r in reads:
            batch.append(r)
            if len(batch) >= self.batch_size:
                self._singles_from_objects(mapper, batch)
                batch = []
        if batch:
            self._singles_from_objects(mapper, batch)

    # ------------- public API: block matrices -------------

    def scan_pair_block(self, mapper, block) -> None:
        """block: io.fastq_block.PairBlock."""
        self.scan_pair_block_multi([mapper], block)

    def scan_pair_block_multi(self, mappers: List, block) -> None:
        """Scan one pair block against MANY panels: per batch, one merge,
        pack and upload (panel-independent) fan out into per-panel scans
        and assemblies (fusion_scan.rs:62-188 analog)."""
        for m in mappers:
            self._prepare(m)
        n = len(block)
        lb, rb = block.left, block.right
        for s in range(0, n, self.batch_size):
            sl = slice(s, min(n, s + self.batch_size))
            self._scan_pair_matrices(
                mappers, lb.seq[sl], lb.qual[sl], lb.lens[sl],
                rb.seq[sl], rb.qual[sl], rb.lens[sl],
                lambda i, s=s: (block.left.read_obj(s + i), block.right.read_obj(s + i)),
            )

    def scan_single_block(self, mapper, rblock) -> None:
        self._prepare(mapper)
        n = len(rblock)
        for s in range(0, n, self.batch_size):
            sl = slice(s, min(n, s + self.batch_size))
            self._scan_single_matrices(mapper, rblock.seq[sl], rblock.lens[sl],
                                       lambda i, s=s: rblock.read_obj(s + i))

    # ------------- object adapters -------------

    def _pairs_from_objects(self, mapper, pairs: List) -> None:
        Lr = _round_up(
            max(KMER, max(max(len(p.left.seq), len(p.right.seq)) for p in pairs)), 32
        )
        b1, l1 = _tokenize_bytes([p.left.seq.encode("latin-1") for p in pairs], Lr)
        q1, _ = _tokenize_bytes([p.left.quality.encode("latin-1") for p in pairs], Lr)
        b2, l2 = _tokenize_bytes([p.right.seq.encode("latin-1") for p in pairs], Lr)
        q2, _ = _tokenize_bytes([p.right.quality.encode("latin-1") for p in pairs], Lr)
        self._scan_pair_matrices([mapper], b1, q1, l1, b2, q2, l2,
                                 lambda i: (pairs[i].left, pairs[i].right))

    def _singles_from_objects(self, mapper, reads: List) -> None:
        Lr = _round_up(max(KMER, max(len(r.seq) for r in reads)), 32)
        rows, lens = _tokenize_bytes([r.seq.encode("latin-1") for r in reads], Lr)
        self._scan_single_matrices(mapper, rows, lens, lambda i: reads[i])

    # ------------- core batch processing -------------

    def _scan_pair_matrices(self, mappers: List, b1, q1, l1, b2, q2, l2,
                            pair_obj: Callable) -> None:
        """Paired-end pipeline entry: host merge on the producer thread ->
        one-call scan -> readiness-gated assembly; flush() drains."""
        entry = self._next_entry()
        shared = dict(
            fut=self._submit_producer(entry, self._st0_produce, b1, q1, l1, b2, q2, l2),
            entry=entry,
            mappers=list(mappers),
            pair_obj=pair_obj,
            orig_B=b1.shape[0],
            fetched=False,
            merged_read_cache={},
        )
        self._enqueue_batch(shared, mappers)

    def _enqueue_batch(self, shared: dict, mappers: List) -> None:
        for j, m in enumerate(mappers):
            self._queue.append(dict(stage=0, mapper=m, tbl=self._table_entry(m),
                                    shared=shared, count_progress=(j == len(mappers) - 1)))
        # issue all older batches' scans (oldest first), then assemble
        # exactly those whose results have landed; the depth cap forces a
        # blocking assembly only when the pipe is full
        n_new = len(mappers)
        for c in list(self._queue[:-n_new]):
            if c["stage"] == 0:
                self._advance(c)
        depth = self.pipeline_depth * max(1, n_new)
        while self._queue and self._queue[0]["stage"] >= 1:
            c = self._queue[0]
            if c["stage"] >= self._N_STAGES:
                self._queue.pop(0)
                continue
            if self._scan_ready(c) or len(self._queue) > depth:
                self._advance(c)
            else:
                break

    def flush(self, mapper=None) -> None:
        while self._queue or any(v[1] for v in self._retry_pend.values()):
            # issue pending retry scans first, so that they ride the device
            # while the queue drains; draining may enqueue fresh retries
            issued = []
            for k in list(self._retry_pend):
                m, items = self._retry_pend.pop(k)
                if items:
                    issued.append((m, self._retry_issue(m, items)))
            while self._queue:
                c = self._queue.pop(0)
                while c["stage"] < self._N_STAGES:
                    self._advance(c)
            for m, ctxs in issued:
                ed = self._ed()
                self._retry_assemble(m, ctxs, ed)
                ed.flush()

    # ---- stage 0: host merge + compact + pack + upload (panel-
    # independent; runs on the producer thread) ----

    def _st0_produce(self, b1, q1, l1, b2, q2, l2, entry=None):
        """Host merge (native gf_merge_pack_pe2, bit-exact with the
        fast_merge oracle) + lane compaction + 2-bit pack + upload to the
        batch's entry (default: entry 0). The device sees only the code
        rows it scans (merged lanes at their widths, unmerged reads at read
        width). Exotic rows are left out of both lanes and go to the scalar
        oracle in _fetch_merge."""
        dev = (entry or self._entries[0]).device
        l1 = np.asarray(l1, np.int32).copy()
        l2 = np.asarray(l2, np.int32).copy()
        # R1/R2 blocks may have different widths (independently parsed
        # files); pad both sides to a common L (floor 32 also guards the
        # MIN_OVERLAP/KMER loops against all-short batches)
        L = _round_up(max(32, b1.shape[1], b2.shape[1]), 32)
        if b1.shape[1] != b2.shape[1]:
            Lin = max(b1.shape[1], b2.shape[1])

            def padw_in(a):
                if a.shape[1] == Lin:
                    return a
                out = np.zeros((a.shape[0], Lin), a.dtype)
                out[:, : a.shape[1]] = a
                return out

            b1, q1, b2, q2 = padw_in(b1), padw_in(q1), padw_in(b2), padw_in(q2)
        with spans.span("st0.merge_pack"):
            res = native.merge_pack_pe_batch(b1, q1, b2, q2, l1, l2, L)
        if res is None:  # pure-Python fallback (oracle fast_merge per row)
            res = native.merge_pack_pe_fallback(b1, q1, b2, q2, l1, l2, L)
        m_flag = res["m_flag"]
        m_len = res["m_len"]
        rwork = res["rwork"]
        rows_m = np.nonzero(m_flag)[0]
        n_m = len(rows_m)
        n_u = len(rwork)
        mbuf, ubuf = res["mbuf"], res["ubuf"]
        lens_m = m_len[rows_m]
        # merged rows split into a p95-width lane and a max-width lane, so
        # that the long insert-size tail does not widen every row
        if n_m:
            Wcap = _round_up(max(KMER, min(2 * L - MIN_OVERLAP, 4 * mbuf.shape[1])), 32)
            Wlong = min(Wcap, _round_up(max(KMER, int(lens_m.max())), 64))
            Wshort = min(Wlong, _round_up(max(KMER, int(np.percentile(lens_m, 95))), 32))
        else:
            Wshort = Wlong = 32
        mask_s = lens_m <= Wshort
        sel_s = np.nonzero(mask_s)[0]
        sel_l = np.nonzero(~mask_s)[0]
        # lanes: (kind, sel into the compacted m/u buffers, width)
        lane_defs = [
            ("m", sel_s, Wshort),
            ("m", sel_l, Wlong),
            ("u", np.arange(n_u), L),
        ]
        lane_meta = []
        bufs, lens_arrs = [], []
        offs = [0]
        # local position of each compacted mbuf row within its lane (for
        # exception remapping)
        m_pos = np.zeros(max(n_m, 1), np.int64)
        m_pos[sel_s] = np.arange(len(sel_s))
        m_pos[sel_l] = np.arange(len(sel_l))
        m_lane_off = np.zeros(max(n_m, 1), np.int64)
        for kind, sel, W in lane_defs:
            n_i = len(sel)
            P = self._pad_rows(n_i)
            wi4 = (W + 3) // 4
            buf = np.zeros((P, wi4), np.uint8)
            ln = np.zeros(P, np.int32)
            if kind == "m":
                if n_i:
                    wm = min(wi4, mbuf.shape[1])
                    buf[:n_i, :wm] = mbuf[sel][:, :wm]
                    ln[:n_i] = lens_m[sel]
                    m_lane_off[sel] = offs[-1]
                pair_rows = rows_m[sel]
            else:
                if n_i:
                    buf[:n_i] = ubuf
                    ln[:n_i] = rwork[:, 2]
                pair_rows = None
            lane_meta.append(dict(kind=kind, n=n_i, sel=sel, W=W, w4=wi4,
                                  pair_rows=pair_rows, off=offs[-1]))
            bufs.append(buf)
            lens_arrs.append(ln)
            offs.append(offs[-1] + P)
        N = offs[-1]
        # non-ACGT exceptions remapped into the concatenated row space; pad
        # entries point past every lane and are dropped
        m_exc, u_exc = res["m_exc"], res["u_exc"]
        n_exc = len(m_exc) + len(u_exc)
        exc = np.full((max(32, self._pad_rows(n_exc)), 2), max(Wlong, L), np.int32)
        exc[:, 0] = N
        if len(m_exc):
            exc[: len(m_exc), 0] = m_lane_off[m_exc[:, 0]] + m_pos[m_exc[:, 0]]
            exc[: len(m_exc), 1] = m_exc[:, 1]
        if len(u_exc):
            exc[len(m_exc) : n_exc, 0] = u_exc[:, 0] + offs[2]
            exc[len(m_exc) : n_exc, 1] = u_exc[:, 1]
        with spans.span("st0.upload"):
            out = dict(
                bufs_d=tuple(self._put_batch(b, dev) for b in bufs),
                # every lane's lengths in one upload: the scan takes each
                # lane's view of them and the compaction all of them
                lens_d=self._put_batch(np.concatenate(lens_arrs), dev),
                exc_d=self._put_batch(exc, dev),
            )
        out.update(
            rows_m=rows_m, m_len=m_len, rwork=rwork, exotic=res["exotic"],
            mbuf=mbuf, ubuf=ubuf, exc_np=exc[:n_exc], lane_meta=lane_meta,
            offs=offs, widths=tuple(w for _, _, w in lane_defs), n_m=n_m, n_u=n_u, L=L,
        )
        return out

    def _advance(self, c) -> None:
        if c["stage"] == 0:
            self._st1_issue_scan(c)
        elif c["stage"] == 1:
            self._st3_assemble(c)

    def _scan_ready(self, c) -> bool:
        f = c.get("scan_f")
        return f is None or f.ready()

    def _fetch_merge(self, sh: dict) -> None:
        """Join the producer and route exotic rows to the scalar oracle,
        once per batch (on the main thread, so match-bin order stays
        deterministic)."""
        if sh["fetched"]:
            return
        fut = sh.pop("fut")
        with spans.span("st1.producer_join"):
            sh.update(fut.result())
        exotic = sh["exotic"]
        if exotic.any():
            pair_obj = sh["pair_obj"]
            for i in np.nonzero(exotic)[0].tolist():
                lr = pair_obj(int(i))
                for m in sh["mappers"]:
                    scan_one_pair(m, SequenceReadPair(lr[0], lr[1]))
        sh["fetched"] = True

    # ---- stage 0 advance: join the producer, issue the one-call scan ----

    def _scan(self, tbl, bufs, lens, exc, widths, cap):
        """fused_scan_lanes on the device that `exc` lies on, with the
        table's copy there."""
        st = self.settings
        return fused_scan_lanes(
            bufs, lens, exc, tbl["indexes"][exc.device], widths=widths, cap=cap,
            major_req=st.major_gene_key_requirement,
            minor_req=st.minor_gene_key_requirement,
            mismatch_thr=st.mismatch_threshold,
        )

    def _st1_issue_scan(self, c) -> None:
        sh = c["shared"]
        self._fetch_merge(sh)
        c["scan_d"] = c["okw_d"] = c["scan_f"] = None
        if sh["n_m"] or sh["n_u"]:
            with spans.span("st1.issue_scan"), torch.cuda.stream(sh["entry"].stream):
                self._adopt_uploads(sh)
                out_d, okw_d = self._scan(
                    c["tbl"], sh["bufs_d"], sh["lens_d"], sh["exc_d"], sh["widths"],
                    self._surv_cap,
                )
                c["scan_d"], c["okw_d"] = out_d, okw_d
                c["scan_f"] = _Result(out_d)
        c["stage"] = 1

    @staticmethod
    def _locate(sh, sidx: int):
        """Map a concat-space survivor row to (pair_row, lane_flag) where
        lane_flag 0 = merged, 1 = R1, 2 = R2."""
        offs = sh["offs"]
        rw = sh["rwork"]
        for li, meta in enumerate(sh["lane_meta"]):
            if sidx < offs[li + 1]:
                local = sidx - offs[li]
                if meta["kind"] == "m":
                    return int(meta["pair_rows"][local]), 0
                return int(rw[local, 0]), int(rw[local, 1])
        raise IndexError(sidx)

    # ---- survivor-cap overflow: pass 2 for survivors beyond `cap` ----

    def _p2_overflow(self, c, n_count: int):
        """Pass 2 for the survivors beyond the cap: rescan those rows alone
        (identical votes, hence identical segments), on the batch's own
        entry."""
        sh = c["shared"]
        entry = sh["entry"]
        with torch.cuda.stream(entry.stream):
            okw = c["okw_d"].cpu().numpy().view(np.uint32)
        bits = np.unpackbits(
            okw.view(np.uint8).reshape(-1, 4), axis=1, bitorder="little"
        ).reshape(-1)
        tail = np.nonzero(bits)[0][self._surv_cap :].astype(np.int64)
        if len(tail) != n_count - self._surv_cap:
            raise RuntimeError("survivor bitmap disagrees with the survivor count")
        offs = sh["offs"]
        W = max(sh["widths"])
        pb = self._pad_rows(len(tail))
        sbuf = np.zeros((pb, (W + 3) // 4), np.uint8)
        lens = np.zeros(pb, np.int32)
        for k, sidx in enumerate(tail.tolist()):
            li = int(np.searchsorted(offs, sidx, side="right")) - 1
            meta = sh["lane_meta"][li]
            local = sidx - offs[li]
            if meta["kind"] == "m":
                src = sh["mbuf"][meta["sel"][local]]
                lens[k] = sh["m_len"][meta["pair_rows"][local]]
            else:
                src = sh["ubuf"][local]
                lens[k] = sh["rwork"][local, 2]
            src = src[: meta["w4"]]
            sbuf[k, : len(src)] = src
        new_row = {int(t): k for k, t in enumerate(tail)}
        exc_list = [(new_row[int(r)], int(col)) for r, col in sh["exc_np"]
                    if int(r) in new_row]
        exc = np.full((max(32, self._pad_rows(len(exc_list))), 2), W, np.int32)
        exc[:, 0] = pb + 8
        if exc_list:
            exc[: len(exc_list)] = exc_list
        dev = entry.device
        with torch.cuda.stream(entry.stream):
            out_t, _ = self._scan(
                c["tbl"], (self._put_batch(sbuf, dev),), self._put_batch(lens, dev),
                self._put_batch(exc, dev), (W,), pb,
            )
            res = out_t.cpu().numpy()
        rows = []
        for k in range(int(res[-1, 0])):
            r = res[k].copy()
            r[0] = tail[int(r[0])]
            rows.append(r)
        return rows

    # ---- stage 1 advance: take the scan result, assemble matches ----

    def _st3_assemble(self, c) -> None:
        mapper = c["mapper"]
        sh = c["shared"]
        if sh.get("se"):
            read_at = sh["read_at"]

            def read_for(i: int, lane: int) -> SequenceRead:
                return read_at(i)

            def originals(i: int) -> List[SequenceRead]:
                return [read_at(i)]

        else:
            pair_obj = sh["pair_obj"]
            cache = sh["merged_read_cache"]

            def read_for(i: int, lane: int) -> SequenceRead:
                lr = pair_obj(i)
                if lane != 0:
                    return lr[0] if lane == 1 else lr[1]
                if i not in cache:
                    m = SequenceReadPair(lr[0], lr[1]).fast_merge()
                    if m is None:
                        raise RuntimeError(f"pair {i}: native and host merge disagree")
                    cache[i] = m
                return cache[i]

            def originals(i: int) -> List[SequenceRead]:
                return list(pair_obj(i))

        ed = self._ed()
        retry: List[Tuple[int, int, SequenceRead]] = []
        rows = []
        if c["scan_f"] is not None:
            with spans.span("st3.result_wait"):
                out = c["scan_f"].get()  # (cap + 1, 13)
            n_count = int(out[-1, 0])
            spans.count("scan.survivors", n_count)
            if self.device.type == "cuda":
                # the vote kernel's warp path; the plain vote on the CPU
                # fills the same columns but has no such path to count
                spans.count("vote.rows", int(out[-1, 1]))
                spans.count("vote.rows_sorted", int(out[-1, 2]))
            rows = list(out[: min(n_count, self._surv_cap)])
            if n_count > self._surv_cap:
                with spans.span("st3.p2_overflow"):
                    rows.extend(self._p2_overflow(c, n_count))
        with spans.span("st3.assemble"):
            for r in rows:
                if not (r[2] and r[3]):
                    continue
                i, lane = self._locate(sh, int(r[0]))
                mapping = _mapping(r)
                if mapper.indexer.in_required_direction(mapping):
                    m = mapper.make_match(read_for(i, lane), mapping, ed_batcher=ed)
                    m.original_reads = originals(i)
                    mapper.add_match(m)
                else:
                    retry.append((i, lane, read_for(i, lane).reverse_complement()))
            if retry:
                self._enqueue_retries(
                    mapper, [(lane, rc, originals(i)) for i, lane, rc in retry]
                )
            ed.flush()
        if c["count_progress"]:
            self._progress(sh["orig_B"])
        c["stage"] = 2

    # ---- deferred reverse-complement retries ----

    def _enqueue_retries(self, mapper, items) -> None:
        """Queue [(lane, rc_read, originals)] for a later batched retry
        (originals are materialized so the source block can be dropped).
        Flushes when the pending set is large."""
        key = id(mapper)
        if key not in self._retry_pend:
            self._retry_pend[key] = (mapper, [])
        pend = self._retry_pend[key][1]
        pend.extend(items)
        if len(pend) >= self._retry_flush_at:
            self._drain_retries(mapper)

    def _drain_retries(self, mapper=None) -> None:
        keys = list(self._retry_pend) if mapper is None else [id(mapper)]
        for k in keys:
            entry = self._retry_pend.pop(k, None)
            if entry is None or not entry[1]:
                continue
            m, items = entry
            ed = self._ed()
            self._retry_assemble(m, self._retry_issue(m, items), ed)
            ed.flush()

    def _retry_issue(self, mapper, items):
        """Rescan direction-rejected reads reverse-complemented through the
        single-lane scan (pescanner.rs:455-513), on entry 0 whichever entry
        finished last. items: [(lane, rc_read, original_reads)] ->
        [(chunk, result)] for _retry_assemble."""
        with spans.span("retry.issue"):
            tbl = self._table_entry(mapper)
            entry = self._entries[0]
            dev = entry.device
            ctxs = []
            CHUNK = self._retry_flush_at
            for s in range(0, len(items), CHUNK):
                ch = items[s : s + CHUNK]
                W = _round_up(max(KMER, max(len(r.seq) for _, r, _ in ch)), 32)
                rows, lens = _tokenize_bytes([r.seq.encode("latin-1") for _, r, _ in ch], W)
                codes = BASE_CODE_LUT[rows]
                col = np.arange(W)[None, :]
                er, ec = np.nonzero((codes == 255) & (col < lens[:, None]))
                codes = np.where(codes == 255, 0, codes).astype(np.uint8)
                packed = (codes[:, 0::4] | (codes[:, 1::4] << 2)
                          | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))
                PAD = self._pad_rows(len(ch))
                buf = np.zeros((PAD, W // 4), np.uint8)
                buf[: len(ch)] = packed
                ln = np.zeros(PAD, np.int32)
                ln[: len(ch)] = lens
                exc = np.full((max(32, self._pad_rows(len(er))), 2), W, np.int32)
                exc[:, 0] = PAD
                exc[: len(er), 0] = er
                exc[: len(er), 1] = ec
                with torch.cuda.stream(entry.stream):
                    out_d, _ = self._scan(
                        tbl, (self._put_batch(buf, dev),), self._put_batch(ln, dev),
                        self._put_batch(exc, dev), (W,), PAD,
                    )
                    ctxs.append((ch, _Result(out_d)))
        return ctxs

    def _retry_assemble(self, mapper, ctxs, ed_batcher=None) -> None:
        """Consume _retry_issue results. Survivors come back compacted in
        ascending row order, so matches are appended in item order."""
        with spans.span("retry.assemble"):
            for ch, fetch in ctxs:
                out = fetch.get()
                body = out[:-1]
                n = int(out[-1, 0])
                for k in range(min(n, len(body))):
                    r = body[k]
                    i = int(r[0])
                    if i >= len(ch) or not (r[2] and r[3]):
                        continue
                    lane, rc_read, originals = ch[i]
                    mapping = _mapping(r)
                    if not mapper.indexer.in_required_direction(mapping):
                        continue
                    m = mapper.make_match(rc_read, mapping, ed_batcher=ed_batcher)
                    m.original_reads = originals
                    if lane != 0:
                        # merged-lane RC matches keep reversed=False
                        # (faithful: pescanner.rs:465-468 vs :487-490)
                        m.reversed = True
                    mapper.add_match(m)

    # ------------- single-end -------------

    def _scan_single_matrices(self, mapper, rows, lens, read_at: Callable) -> None:
        """Single-end pipeline entry: the paired path's scan and assembly
        with a single read lane (no merge; the host pack is numpy)."""
        rows = np.ascontiguousarray(rows)
        lens = np.asarray(lens, np.int32).copy()
        entry = self._next_entry()
        shared = dict(
            fut=self._submit_producer(entry, self._st0_produce_se, rows, lens),
            entry=entry,
            mappers=[mapper],
            read_at=read_at,
            se=True,
            orig_B=len(lens),
            fetched=False,
            merged_read_cache={},
        )
        self._enqueue_batch(shared, [mapper])

    def _st0_produce_se(self, rows, lens, entry=None):
        """Single-end producer: 2-bit pack + non-ACGT exception capture +
        upload. One 'u'-kind lane; exotic bytes need no oracle routing
        here (without a merge no byte comparison runs, so invalid codes
        already match the oracle's k-mer encoding)."""
        B, Lin = rows.shape
        L = _round_up(max(32, Lin), 32)
        w4 = (L + 3) // 4
        codes = BASE_CODE_LUT[rows]
        col = np.arange(Lin)[None, :]
        er, ec = np.nonzero((codes == 255) & (col < lens[:, None]))
        codes = np.where(codes == 255, 0, codes).astype(np.uint8)
        if Lin != 4 * w4:
            codes = np.concatenate([codes, np.zeros((B, 4 * w4 - Lin), np.uint8)], axis=1)
        packed = (codes[:, 0::4] | (codes[:, 1::4] << 2)
                  | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))
        P = self._pad_rows(B)
        buf = np.zeros((P, w4), np.uint8)
        buf[:B] = packed
        ln = np.zeros(P, np.int32)
        ln[:B] = lens
        rwork = np.stack([np.arange(B, dtype=np.int32), np.ones(B, np.int32), lens], axis=1)
        n_exc = len(er)
        exc = np.full((max(32, self._pad_rows(n_exc)), 2), L, np.int32)
        exc[:, 0] = P
        exc[:n_exc, 0] = er
        exc[:n_exc, 1] = ec
        dev = (entry or self._entries[0]).device
        with spans.span("st0.upload"):
            out = dict(
                bufs_d=(self._put_batch(buf, dev),),
                lens_d=self._put_batch(ln, dev),
                exc_d=self._put_batch(exc, dev),
            )
        out.update(
            rows_m=np.zeros(0, np.int64), m_len=np.zeros(B, np.int32), rwork=rwork,
            exotic=np.zeros(B, bool), mbuf=np.zeros((0, 1), np.uint8), ubuf=packed,
            exc_np=exc[:n_exc],
            lane_meta=[dict(kind="u", n=B, sel=np.arange(B), W=L, w4=w4,
                            pair_rows=None, off=0)],
            offs=[0, P], widths=(L,), n_m=0, n_u=B, L=L,
        )
        return out


def _mapping(r) -> List[SeqMatch]:
    return [
        SeqMatch(int(r[4 + t]), int(r[6 + t]), GenePos(int(r[8 + t]), int(r[10 + t])))
        for t in range(2)
    ]
