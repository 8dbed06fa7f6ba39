"""`table_pack_s` in the cell of the 1,100-gene panel (oncokb1100-pe-targeted):
the same reading under a name of its own, since that cell reports
`device_ms_per_mpair` and its table is packed in the split layout."""

from gfbench.metrics.table_pack_s import read  # noqa: F401
