"""Reports, writers (report/html.py and report/json.py, each reporter's
run() in core/scanner.py::finish_scan): seconds a sample of writing the
HTML and JSON reports, summed over its panels, from the port's
`report.write` span (utils/spans.py) over the window."""


def read(rec):
    s, calls = rec.timer("report.write")
    return s / rec.samples if calls and rec.samples else None
