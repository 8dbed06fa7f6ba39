"""Reports, alignability filter (core/mapper.py::remove_alignables: the
Matcher's genome index built, every match looked up in it): seconds a
sample, summed over its panels, from the port's `report.alignable` span
(utils/spans.py) over the window."""


def read(rec):
    s, calls = rec.timer("report.alignable")
    return s / rec.samples if calls and rec.samples else None
