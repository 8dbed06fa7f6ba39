"""`report_write_s_per_sample` in the cells that report `device_ms_per_mpair` in place of
`pairs_per_s` (cancer15-pe-fusionrich): the same reading under a name of its
own, since a per-layer metric moves one end-to-end metric."""

from gfbench.metrics.report_write_s_per_sample import read  # noqa: F401
