"""Engine, device call (ops/fused.py::fused_scan_lanes and what follows it
on the card): 1 - the device's busy time (the union of its intervals) over
the traced sample's wall time, from torch.profiler."""


def read(rec):
    p = rec.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
