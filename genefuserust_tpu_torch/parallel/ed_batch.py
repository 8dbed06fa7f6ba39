"""Deferred, batched edit-distance evaluation.

Same interface as the JAX package's `parallel/ed_batch.py::EdBatcher`: the
mapper submits (query, ref, setter) jobs during a batch's assembly and
`flush()` evaluates them. A flush smaller than the device's threshold
(`DEVICE_MIN_JOBS` on CUDA, `CPU_MIN_JOBS` on the CPU) runs the host
Myers of `core/edit_distance.py`. A larger flush follows the JAX batcher:
jobs with an empty side, with a byte outside ACGTNacgtn (the device
alphabet buckets unknown bytes together) or with a pattern wider than the
kernel's words go to the host Myers; the rest go through
`ops.edit_distance.edit_distance_batch` on the engine's device, the
kernel on CUDA and its plain version on the CPU. The pattern is the
shorter side (the distance is symmetric), and the rows are padded only
to 64 columns: the JAX package's power-of-two row padding limited XLA
compiles, which the kernel does not have.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..core.edit_distance import edit_distance
from ..ops.edit_distance import ED_ALPHA, ED_CODE_LUT, ED_MAX_WORDS, edit_distance_batch
from ..utils.spans import span

# Flushes of at least this many jobs go to the kernel. Over the jobs the
# scans of chip_smoke.py phases 5 and 10 flushed (read halves of ~92
# bases; phase 10's sweep, NVIDIA H100 80GB HBM3 at a 700 W power limit),
# the batched path (encode, upload, kernel, download) and host Myers tie
# at 4 jobs, ~0.3 ms each (the sweep's crossover read 8, then 4, in two
# runs); from 8 jobs on, host Myers takes at least twice as long. Those
# scans' flushes held 30 to 2,062 jobs, which any value from 2 to 16
# routes alike.
DEVICE_MIN_JOBS = 8
# The plain version runs ~20 torch ops per text step and word whatever the
# flush size, ~0.25 s a flush of read-half jobs on one CPU thread; host
# Myers takes ~0.2 ms a job, so the plain version pays only from ~2,048.
CPU_MIN_JOBS = 2048


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def min_jobs(device) -> int:
    """The smallest flush that `EdBatcher` evaluates batched on `device`."""
    return DEVICE_MIN_JOBS if torch.device(device).type == "cuda" else CPU_MIN_JOBS


def _encode(seqs: List[bytes], width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Byte strings -> ((n, width) uint8 ED codes, zero-padded; (n,) int32
    lengths)."""
    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
    codes = np.zeros((len(seqs), width), np.uint8)
    flat = np.frombuffer(b"".join(seqs), np.uint8)
    rows = np.repeat(np.arange(len(seqs)), lens)
    cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    codes[rows, cols] = ED_CODE_LUT[flat]
    return codes, lens.astype(np.int32)


def encode_jobs(pairs: List[Tuple[str, str]]):
    """(query, ref) pairs -> (host, (pc, pl, tc, tl)): `host` marks the jobs
    for host Myers (an empty side, an exotic byte, a pattern wider than the
    kernel's words); the others' codes and lengths, in order, padded to 64
    columns, for `edit_distance_batch(pc, pl, tc, tl, pc.shape[1] // 32)`."""
    # pattern = the shorter side, as min()/max() pick them in the JAX batcher
    pats = [(q if len(q) <= len(r) else r).encode("latin-1", "replace") for q, r in pairs]
    txts = [(r if len(q) <= len(r) else q).encode("latin-1", "replace") for q, r in pairs]
    pc, pl = _encode(pats, _round_up(max(map(len, pats)), 64))
    tc, tl = _encode(txts, _round_up(max(map(len, txts)), 64))
    # padding is code 0, so "other" codes are the exotic bytes themselves
    exotic = (pc == ED_ALPHA - 1).any(1) | (tc == ED_ALPHA - 1).any(1)
    host = exotic | (pl == 0) | (pl > 32 * ED_MAX_WORDS)
    sel = np.nonzero(~host)[0]
    if not len(sel):
        return host, None
    Lp = _round_up(int(pl[sel].max()), 64)
    Lt = _round_up(int(tl[sel].max()), 64)
    return host, tuple(np.ascontiguousarray(a) for a in
                       (pc[sel, :Lp], pl[sel], tc[sel, :Lt], tl[sel]))


class EdBatcher:
    """Collects edit-distance jobs; flush() evaluates them and adds to
    `stats["jobs"]` (all), `stats["device_sized"]` (jobs in flushes of at
    least the device's threshold) and `stats["device"]` (jobs evaluated
    batched)."""

    def __init__(self, stats: dict, device="cpu"):
        self.stats = stats
        self.device = torch.device(device)
        self.min_jobs = min_jobs(self.device)
        self._jobs: List[Tuple[str, str, Callable[[int], None]]] = []

    def submit(self, query: str, ref: str, setter: Callable[[int], None]) -> None:
        self._jobs.append((query, ref, setter))

    def __len__(self) -> int:
        return len(self._jobs)

    def flush(self) -> None:
        jobs, self._jobs = self._jobs, []
        self.stats["jobs"] += len(jobs)
        with span("ed.flush"):
            if len(jobs) < self.min_jobs:
                for q, r, setter in jobs:
                    setter(edit_distance(q, r))
                return
            self.stats["device_sized"] += len(jobs)
            self.stats["device"] += evaluate_batched(jobs, self.device)


def evaluate_batched(jobs: List[Tuple[str, str, Callable[[int], None]]], device) -> int:
    """Set every job's distance: the jobs `encode_jobs` marks by host Myers,
    the rest in one `edit_distance_batch` call on `device` -> the number
    evaluated batched."""
    if not jobs:
        return 0
    host, arrays = encode_jobs([(q, r) for q, r, _ in jobs])
    for i in np.nonzero(host)[0].tolist():
        q, r, setter = jobs[i]
        setter(edit_distance(q, r))
    if arrays is None:
        return 0
    pc, pl, tc, tl = (torch.from_numpy(a).to(device) for a in arrays)
    out = edit_distance_batch(pc, pl, tc, tl, pc.shape[1] // 32).cpu().numpy()
    sel = np.nonzero(~host)[0]
    for i, d in zip(sel.tolist(), out.tolist()):
        jobs[i][2](d)
    return len(sel)
