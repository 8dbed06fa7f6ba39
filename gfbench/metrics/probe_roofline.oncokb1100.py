"""`probe_roofline` in the cell of the 1,100-gene panel (oncokb1100-pe-targeted),
whose table is packed split: the profile's probe symbols there are
`probe_split_kernel`'s. The bound is the same layout-free lower bound
(gfbench/probe_work.py), so the share reads lower than kv2's."""

from gfbench.metrics.probe_roofline import read  # noqa: F401
