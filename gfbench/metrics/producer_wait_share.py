"""Engine pipeline (stages 1-3 of parallel/engine.py): the share of the
window the main thread waits on stage 0, from the engine's
`st1.producer_join` timer over the window's wall time."""


def read(rec):
    s, calls = rec.timer("st1.producer_join")
    return s / rec.window_s if calls and rec.window_s > 0 else None
