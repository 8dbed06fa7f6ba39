"""Reports, filters, sort and clustering: the match bins that a sample's
finish_scan walks (each of its walks visits them), from the port's
`report.bins_walked` counter (utils/spans.py, once a finish_scan) over the
window. With sparse bins it is the bins a match landed in; a dense mapper
walks all genes^2 of them. A program without the counter leaves the metric
out."""


def read(rec):
    bins, events = rec.timer("report.bins_walked")
    return bins / rec.samples if events and rec.samples else None
