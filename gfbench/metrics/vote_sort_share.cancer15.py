"""Kernel vote: of the rows that the vote kernel's warp path voted on, the
share it sorted (more than its cap of distinct keys) rather than peeled,
from the port's counters `vote.rows` and `vote.rows_sorted` (the engine's,
once a batch) over the window. A program without the counters leaves the
metric out."""


def read(rec):
    rows, events = rec.timer("vote.rows")
    return rec.timer("vote.rows_sorted")[0] / rows if events and rows else None
