"""`ed_jobs_per_kpair` in the cells that report `device_ms_per_mpair` in place of
`pairs_per_s` (cancer15-pe-targeted): the same reading under a name of its
own, since a per-layer metric moves one end-to-end metric."""

from gfbench.metrics.ed_jobs_per_kpair import read  # noqa: F401
