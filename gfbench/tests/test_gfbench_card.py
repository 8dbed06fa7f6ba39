"""On the card (skipped without one): both cells at a small size through
the CUDA kernels, correct, with a device trace in the traced run. Run on
the card with
`python -m pytest -p no:cacheprovider -q -m cuda gfbench/tests/test_gfbench_card.py`."""

import time

import pytest

from gfbench.cell import run_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cancer15-pe-targeted", "multicsv16-pe-targeted"])
def test_small_run_on_the_card(cell, small, card):
    out = run_cell(cell, 2**31 + 3, 0.1, True, time.perf_counter(), device=card, sizes=small,
                   say=lambda o: None)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    sfx = ".cancer15" if cell.startswith("cancer15") else ""
    assert 0 < out["metrics"]["device_idle_share" + sfx]["value"] < 1
    assert 0 < out["metrics"]["probe_roofline" + sfx]["value"] <= 100


@pytest.mark.cuda
def test_a_run_reads_the_device_time_of_its_whole_window(small, card):
    out = run_cell("cancer15-pe-targeted", 2**31 + 4, 0.1, False, time.perf_counter(),
                   device=card, sizes=small, say=lambda o: None)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"device_ms_per_mpair", "setup_s"}
    assert out["metrics"]["device_ms_per_mpair"]["value"] > 0
