"""Panel index (core/mapper.py, core/indexer.py): seconds of the set-up's
FusionMapper constructions, a CSV each, from the benchmark's span."""


def read(rec):
    return rec.span_total("index_build")
