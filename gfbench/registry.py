"""Everything a cell is made of, found by name: its entry in BENCHMARK.json
at the checkout's root, `configs/<config>.json`, `traffic/<traffic>.json`,
and a reader `metrics/<metric>.py` a per-layer metric. A new cell, mix or
metric is a new file and an entry; no code names them."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _load(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} file for {name!r}: {path}")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _load("configs", name)


def traffic(name: str) -> dict:
    return _load("traffic", name)


def reader(name: str) -> ModuleType:
    """The module of a per-layer metric: its `read(record)` gives the
    metric's value, or None where the run holds nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"gfbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(cell: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` metrics that cell reports: those
    whose `workloads` list names it, and those without the key."""
    return [m for m in benchmark()[kind] if cell in m.get("workloads", [cell])]
