"""TorchEngine: the batch engine of `genefuserust_tpu.parallel.engine` on
torch tensors and the CUDA kernels of this package.

The pipeline is the JAX engine's, inherited from `TpuEngine` (whose
module imports no JAX): the producer thread merges and 2-bit packs each
batch on the host (native gf_merge_pack_pe2) and uploads it; the main
thread issues one `fused_scan_lanes` per batch and assembles matches from
the (cap + 1, 13) result once it has landed. Only the hooks that reached
JAX are replaced:

  - uploads go through pinned host buffers with non-blocking copies; the
    producer thread copies on its own stream and records an event that
    the scan's stream waits on (and `record_stream` keeps the allocator
    from reusing the buffers early);
  - the result comes back by a non-blocking copy into pinned memory, and
    readiness is a CUDA event query (no fetch thread);
  - there is no compile, so the compile pool, signature memo and the
    shape-reuse memos (`_pad_rows`, `_sticky_width`) go: lanes are padded
    to a multiple of 32 rows and take their exact widths;
  - edit distances go through this package's EdBatcher;
  - the index table comes from this package's builder (`ops/index.py`).

Results are identical to the host oracle (tests/test_torch_engine.py).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from genefuserust_tpu.config import KMER, Settings
from genefuserust_tpu.core.indexer import GenePos, SeqMatch
from genefuserust_tpu.core.read import SequenceRead, SequenceReadPair
from genefuserust_tpu.core.sequence import BASE_CODE_LUT
from genefuserust_tpu.parallel.engine import TpuEngine, _round_up, _tokenize_bytes, log

from ..ops.fused import fused_scan_lanes
from ..ops.index import build_packed_index, index_to_torch
from .ed_batch import EdBatcher


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


class TorchEngine(TpuEngine):
    """Batched paired-end / single-end engine on one torch device."""

    def __init__(self, settings: Settings, batch_size: int = 65536,
                 device="cuda", pipeline_depth: int = 6):
        super().__init__(settings, batch_size=batch_size, mesh=None,
                         pipeline_depth=pipeline_depth)
        self.device = resolve_device(device)
        self._upload_stream = None
        # edit-distance job counts (see EdBatcher)
        self.ed_stats = {"jobs": 0, "device_sized": 0, "device": 0}
        # host seconds spent building and uploading device index tables
        self.table_seconds = 0.0

    def _ed(self) -> EdBatcher:
        return EdBatcher(stats=self.ed_stats, device=self.device)

    # ------------- uploads -------------

    def _put_batch(self, x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    _put_repl = _put_batch

    def _with_upload_stream(self, produce, *args):
        """Run a producer on the upload stream; the batch carries the event
        that orders its uploads before the scan."""
        if self.device.type == "cpu":
            return produce(*args)
        if self._upload_stream is None:
            self._upload_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._upload_stream):
            out = produce(*args)
            ev = torch.cuda.Event()
            ev.record(self._upload_stream)
        out["upload_event"] = ev
        return out

    def _st0_produce(self, *args):
        return self._with_upload_stream(super()._st0_produce, *args)

    def _st0_produce_se(self, *args):
        return self._with_upload_stream(super()._st0_produce_se, *args)

    def _adopt_uploads(self, sh: dict) -> None:
        ev = sh.pop("upload_event", None)
        if ev is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for t in (*sh["bufs_d"], *sh["lens_d"], sh["exc_d"]):
            t.record_stream(cur)

    # ------------- index -------------

    def _entry_from_packed(self, packed) -> dict:
        return dict(packed=packed, index=index_to_torch(packed, self.device))

    def _table_entry(self, mapper) -> dict:
        """`TpuEngine._table_entry` with the port's table builder: entries
        are keyed by id(mapper) and pin their mapper; a table installed by
        `use_packed` without a mapper goes to the first mapper asking."""
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
        t0 = time.perf_counter()
        packed = build_packed_index(mapper.indexer)
        e = self._entry_from_packed(packed)
        self.table_seconds += time.perf_counter() - t0
        e["mapper"] = mapper
        self._tables[key] = e
        log.info("device index ready: %d buckets, %.1f MB%s", packed.n_buckets,
                 packed.nbytes / 1e6, " (kv rows)" if hasattr(packed, "kv_tbl") else "")
        return e

    # ------------- shapes: no compile to amortize -------------

    def _pad_rows(self, n: int) -> int:
        return max(32, _round_up(n, 32))

    def _sticky_width(self, need: int, tol: int = 32) -> int:
        return need

    # ------------- scan -------------

    def _scan(self, tbl, bufs, lens, exc, widths, cap):
        st = self.settings
        return fused_scan_lanes(
            bufs, lens, exc, tbl["index"], widths=widths, cap=cap,
            major_req=st.major_gene_key_requirement,
            minor_req=st.minor_gene_key_requirement,
            mismatch_thr=st.mismatch_threshold,
        )

    def _st1_issue_scan(self, c) -> None:
        sh = c["shared"]
        self._fetch_merge(sh)
        c["scan_d"] = c["okw_d"] = c["scan_f"] = None
        if sh["n_m"] or sh["n_u"]:
            self._adopt_uploads(sh)
            out_d, okw_d = self._scan(
                c["tbl"], sh["bufs_d"], sh["lens_d"], sh["exc_d"], sh["widths"],
                self._surv_cap,
            )
            c["scan_d"], c["okw_d"] = out_d, okw_d
            c["scan_f"] = _Result(out_d)
        c["stage"] = 1

    def _scan_ready(self, c) -> bool:
        f = c.get("scan_f")
        return f is None or f.ready()

    def _p2_overflow(self, c, n_count: int):
        """Pass 2 for the survivors beyond the cap: rescan those rows alone
        (identical votes, hence identical segments)."""
        sh = c["shared"]
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
        out_t, _ = self._scan(
            c["tbl"], (self._put_batch(sbuf),), (self._put_batch(lens),),
            self._put_repl(exc), (W,), pb,
        )
        res = out_t.cpu().numpy()
        rows = []
        for k in range(int(res[-1, 0])):
            r = res[k].copy()
            r[0] = tail[int(r[0])]
            rows.append(r)
        return rows

    # ------------- assembly -------------

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
        if c["scan_f"] is not None:
            out = c["scan_f"].get()  # (cap + 1, 13)
            n_count = int(out[-1, 0])
            rows = list(out[: min(n_count, self._surv_cap)])
            if n_count > self._surv_cap:
                rows.extend(self._p2_overflow(c, n_count))
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

    def flush(self, mapper=None) -> None:
        while self._queue or any(v[1] for v in self._retry_pend.values()):
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
        single-lane scan (pescanner.rs:455-513). items: [(lane, rc_read,
        original_reads)] -> [(chunk, result)] for _retry_assemble."""
        tbl = self._table_entry(mapper)
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
            out_d, _ = self._scan(
                tbl, (self._put_batch(buf),), (self._put_batch(ln),),
                self._put_repl(exc), (W,), PAD,
            )
            ctxs.append((ch, _Result(out_d)))
        return ctxs


def _mapping(r) -> List[SeqMatch]:
    return [
        SeqMatch(int(r[4 + t]), int(r[6 + t]), GenePos(int(r[8 + t]), int(r[10 + t])))
        for t in range(2)
    ]
