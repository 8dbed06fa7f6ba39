"""Sample (scan, flush and every panel's reports, back to back): pairs of
the traced run's whole samples over their wall time, as `pairs_per_s` is
taken, in the cells whose runs spread too widely on the host's clock for
it to stand end to end (cancer15-pe-targeted). The traced run profiles
one of its samples, so it reads a little below an untraced run."""


def read(rec):
    return rec.pairs / rec.window_s if rec.pairs and rec.window_s > 0 else None
