"""Table build (ops/index.py::build_packed_index, TorchEngine.use_packed):
seconds of the set-up's packs and uploads, a panel each, from the
benchmark's span (TorchEngine.table_seconds does not see use_packed)."""


def read(rec):
    return rec.span_total("table_pack")
