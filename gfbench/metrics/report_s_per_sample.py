"""Reports (core/scanner.py::finish_scan, report/*): seconds a sample of the
filters, clustering and HTML and JSON reports, summed over the sample's
panels, from the benchmark's span around each finish_scan."""


def read(rec):
    return rec.span_total("finish_scan") / rec.samples if rec.samples else None
