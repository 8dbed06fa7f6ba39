"""Reading a torch.profiler trace of one sample: the device's busy time,
its kernels by symbol, and its idle gaps by what the host was doing.

The busy time is the union of the device's intervals (kernels, copies,
sets; the upload stream may overlap the compute stream), a frozen copy of
chip_smoke.py phase 7's arithmetic. A gap is an interval of the traced
window in which no device interval runs; it is named after the innermost
host span of the benchmark (`torch.profiler.record_function`) that holds
its middle.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def union_length(intervals: Iterable[Interval]) -> float:
    """The length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, t in sorted(intervals):
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    return busy


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(t, hi)) for s, t in intervals if t > lo and s < hi]


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi) that no interval covers, in order."""
    out, at = [], lo
    for s, t in sorted(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, t)
    if at < hi:
        out.append((at, hi))
    return out


def name_gaps(holes: Iterable[Interval], spans: Dict[str, List[Interval]]) -> Dict[str, float]:
    """Idle time by the innermost span that holds each gap's middle
    ("other" where none does)."""
    out: Dict[str, float] = {}
    for s, t in holes:
        mid = (s + t) / 2
        best, width = "other", float("inf")
        for name, ivs in spans.items():
            for a, b in ivs:
                if a <= mid < b and b - a < width:
                    best, width = name, b - a
        out[best] = out.get(best, 0.0) + (t - s)
    return out


_TEMPLATE = re.compile(r"<[^<>]*>")


def symbol(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters ("void probe_kernel<4>(int*, ...)" ->
    "probe_kernel"); a copy or a set keeps its name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name.replace("(anonymous namespace)", "")
    while _TEMPLATE.search(s):
        s = _TEMPLATE.sub("", s)
    s = s.split("(")[0].strip()
    return s.split()[-1].split("::")[-1] if s else name


def summarize(device: List[Tuple[str, float, float]], host: Dict[str, List[Interval]],
              window: Interval) -> Optional[dict]:
    """device: (name, start, end) of each device interval; host: the
    benchmark's spans by name; window: the traced window. Times in any one
    unit; the result in the same unit."""
    lo, hi = window
    if hi <= lo:
        return None
    ivs = clip([(s, t) for _, s, t in device], lo, hi)
    by_symbol: Dict[str, float] = {}
    for name, s, t in device:
        c = clip([(s, t)], lo, hi)
        if c:
            k = symbol(name)
            by_symbol[k] = by_symbol.get(k, 0.0) + (c[0][1] - c[0][0])
    return dict(window=hi - lo, busy=union_length(ivs), by_symbol=by_symbol,
                idle=name_gaps(gaps(ivs, lo, hi), host))


def from_profiler(prof, window_span: str) -> Optional[dict]:
    """summarize() of a torch.profiler run, in seconds; the traced window
    is the host span `window_span`."""
    import torch

    device, host = [], {}
    for e in prof.events():
        tr = (e.time_range.start, e.time_range.end)
        if e.name.startswith("gf."):
            # the benchmark's spans (record_function also puts a copy of
            # each on the device's timeline, which is no device work)
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.setdefault(e.name, []).append(tr)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((e.name, *tr))
    if window_span not in host:
        return None
    lo = min(s for s, _ in host[window_span])
    hi = max(t for _, t in host[window_span])
    out = summarize(device, host, (lo, hi))
    if out is None:
        return None
    us = 1e-6
    return dict(window_s=out["window"] * us, busy_s=out["busy"] * us,
                by_symbol={k: v * us for k, v in out["by_symbol"].items()},
                idle={k: v * us for k, v in out["idle"].items()})


def device_busy(prof) -> Optional[float]:
    """Seconds in which some interval ran on the device over a whole
    torch.profiler run (the union of its intervals), or None where the
    trace holds none."""
    import torch

    ivs = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("gf.")]
    return union_length(ivs) * 1e-6 if ivs else None
