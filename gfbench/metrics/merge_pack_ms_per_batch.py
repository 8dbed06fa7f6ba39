"""Engine, host stage 0 (TorchEngine._st0_produce): milliseconds a batch of
the native merge and 2-bit pack over the window, from the engine's own
`st0.merge_pack` timer (GENEFUSE_STAGE_TIMERS, set in traced runs)."""


def read(rec):
    s, calls = rec.timer("st0.merge_pack")
    return 1e3 * s / calls if calls else None
