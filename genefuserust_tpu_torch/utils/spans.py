"""Named host spans and counters of the port, in one process-wide registry.

`span(label)` times a block: it adds its `time.perf_counter` seconds and
one call to `label`, always. While a torch profiler runs it is also a
`torch.profiler.record_function` named "gf.<label>", so the block lies on
the profiler's clock beside the device's intervals; with no profiler
running it never enters one (a `record_function` costs ~10 us, the
profiler test ~0.1 us). `count(label, n)` adds n and one event to a
counter. `REGISTRY` maps each label to [total_s, calls] for a span and to
[count, events] for a counter; `TorchEngine._timers` is this registry.

Spans sit at stage boundaries (once a batch, a panel-batch, a flush or a
panel's report), never in a loop over reads, matches or k-mers. Updates
hold a lock, since the engine's producer threads (GENEFUSE_PRODUCER_WORKERS)
add to their labels at once.
"""

from __future__ import annotations

import sys
import threading
import time

PREFIX = "gf."


class Registry(dict):
    """label -> [total, calls]; `add` and `items` hold the lock, so a copy
    taken while another thread adds is whole."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()

    def add(self, label: str, amount) -> None:
        with self._lock:
            e = self.get(label)
            if e is None:
                e = self[label] = [0, 0]
            e[0] += amount
            e[1] += 1

    def items(self):
        with self._lock:
            return [(k, (v[0], v[1])) for k, v in super().items()]

    def seconds(self, *labels: str) -> float:
        """The total of the spans `labels`."""
        with self._lock:
            return sum(self[k][0] for k in labels if k in self)


REGISTRY = Registry()


def _profiling() -> bool:
    """Whether a torch profiler runs (none can before torch is imported,
    so the host modules that hold spans need not import it)."""
    p = sys.modules.get("torch.autograd.profiler")
    return p is not None and p._is_profiler_enabled


class span:
    """`with span(label):` times the block into REGISTRY (see the module)."""

    __slots__ = ("label", "_t0", "_rf")

    def __init__(self, label: str):
        self.label = label

    def __enter__(self) -> "span":
        self._rf = None
        if _profiling():
            import torch

            self._rf = torch.profiler.record_function(PREFIX + self.label)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        REGISTRY.add(self.label, dt)


def count(label: str, n: int) -> None:
    """Add n (and one event) to the counter `label`."""
    REGISTRY.add(label, n)
