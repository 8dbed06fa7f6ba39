"""Deferred, batched edit-distance evaluation (JAX-free).

Same interface as `genefuserust_tpu.parallel.ed_batch.EdBatcher`: the
mapper submits (query, ref, setter) jobs during a batch's assembly and
`flush()` evaluates them. Every job runs the host Myers of
`core/edit_distance.py`, so the distances are those of the host oracle.

A device Myers kernel is not ported yet. The batcher counts the jobs it
flushes, and among them those flushed in batches of at least
`DEVICE_MIN_JOBS`: the jobs such a kernel would carry under the JAX
package's threshold.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

from genefuserust_tpu.core.edit_distance import edit_distance

# the JAX batcher's device threshold (its `min_device_jobs` default)
DEVICE_MIN_JOBS = 512


class EdBatcher:
    """Collects edit-distance jobs; flush() evaluates them on the host and
    adds to `stats["jobs"]` and `stats["device_sized"]`."""

    def __init__(self, stats: dict):
        self.stats = stats
        self._jobs: List[Tuple[str, str, Callable[[int], None]]] = []

    def submit(self, query: str, ref: str, setter: Callable[[int], None]) -> None:
        self._jobs.append((query, ref, setter))

    def __len__(self) -> int:
        return len(self._jobs)

    def flush(self) -> None:
        jobs, self._jobs = self._jobs, []
        self.stats["jobs"] += len(jobs)
        if len(jobs) >= DEVICE_MIN_JOBS:
            self.stats["device_sized"] += len(jobs)
        for q, r, setter in jobs:
            setter(edit_distance(q, r))
