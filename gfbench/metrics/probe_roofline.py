"""Kernel probe (csrc/probe.cu): the probe kernels' share of their bound in
the traced sample, in %. Their time is the profile's, summed over every
probe symbol; the bound is gfbench/probe_work.py's count of the sample's
pass-1 work (1 byte a base of each row scanned and a 32-byte sector a
k-mer looked up, a pass a panel) over HBM's 3.35 TB/s."""


def read(rec):
    p = rec.profile
    if not p:
        return None
    probe_s = sum(s for k, s in p["by_symbol"].items() if "probe" in k)
    if probe_s <= 0:
        return None
    return 100.0 * rec.probe_bound()["bound_ms"] * 1e-3 / probe_s
