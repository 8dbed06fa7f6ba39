"""The least time the card could take for a kernel's work: the bound that
chip_smoke.py and profiling/device_merge.py print beside each kernel's
time.

The peaks are those of NVIDIA's data sheet for the H100 SXM at 700 W:
HBM's bytes/s, and the 32-bit rate outside the tensor cores, 67 T/s, taken
for the kernels' int32 operations (the card's int32 rate is no higher, so
the bound stays a lower bound).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over HBM's rate or
    operations over the int32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return dict(bytes=int(nbytes), ops=int(ops), bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
