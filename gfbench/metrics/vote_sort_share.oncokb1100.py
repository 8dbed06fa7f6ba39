"""`vote_sort_share.cancer15` in the cell of the 1,100-gene panel
(oncokb1100-pe-targeted), whose split table holds more dupe rows: of the
rows the vote kernel's warp path voted on, the share it sorted, from the
port's counters `vote.rows` and `vote.rows_sorted` over the window. A
program without the counters leaves the metric out."""


def read(rec):
    rows, events = rec.timer("vote.rows")
    return rec.timer("vote.rows_sorted")[0] / rows if events and rows else None
