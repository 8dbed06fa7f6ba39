"""Reports, filters, sort and clustering (core/mapper.py: the complexity,
distance and indel filters, the sort of every bin, the clustering into
fusion results): seconds a sample, from the port's `report.filter`,
`report.sort` and `report.cluster` spans (utils/spans.py) over the window.
A program without those spans leaves the metric out."""

LABELS = ("report.filter", "report.sort", "report.cluster")


def read(rec):
    got = [rec.timer(label) for label in LABELS]
    if not rec.samples or not all(calls for _, calls in got):
        return None
    return sum(s for s, _ in got) / rec.samples
