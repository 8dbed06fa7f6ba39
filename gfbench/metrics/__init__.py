"""One reader a per-layer metric, found by the metric's name
(registry.reader). Each defines `read(record) -> float | None`, where the
record is cell.Record; None leaves the metric out of the result line."""
