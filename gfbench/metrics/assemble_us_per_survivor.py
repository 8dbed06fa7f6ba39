"""Assembly (parallel/engine.py::_st3_assemble): microseconds of the
engine's `st3.assemble` span (each survivor located, its match made and
binned, direction misses queued for the reverse-complement retry, the
batch's edit-distance flush) a vote survivor, the survivors from the
`scan.survivors` counter, both over the window (utils/spans.py)."""


def read(rec):
    s, calls = rec.timer("st3.assemble")
    survivors, _ = rec.timer("scan.survivors")
    return 1e6 * s / survivors if calls and survivors > 0 else None
