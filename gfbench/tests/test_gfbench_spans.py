"""The per-layer metrics read from the port's own spans and counters
(genefuserust_tpu_torch/utils/spans.py): a small traced CPU run of each
cell that lists them reports each, above 0, and reads `correct`."""

import time

import pytest

from gfbench import registry
from gfbench.cell import run_cell

READERS = ("assemble_us_per_survivor", "alignable_s_per_sample", "report_write_s_per_sample")


@pytest.mark.parametrize("cell", ["multicsv16-pe-targeted", "cancer15-pe-fusionrich"])
def test_a_traced_run_reads_the_programs_spans(cell, small):
    mix = registry.traffic(registry.workload(cell)["traffic"])
    # the mix's share of planted pairs at the small sample's size
    share = len(mix["planted"]["fusions"]) * mix["planted"]["pairs_each"] / mix["pairs_per_sample"]
    each = max(1, round(share * small["traffic"]["pairs_per_sample"] / 2))
    small["traffic"]["planted"] = {**mix["planted"], "pairs_each": each}
    out = run_cell(cell, 2**31 + 21, 0.1, True, time.perf_counter(), device="cpu",
                   sizes=small, say=lambda o: None)
    assert out["correct"], out["checks"]
    sfx = ".cancer15" if cell.startswith("cancer15") else ""
    listed = {m["name"] for m in registry.metrics_of(cell, "per_layer")}
    for name in READERS:
        assert name + sfx in listed
        assert out["metrics"][name + sfx]["value"] > 0, name


def test_the_readers_find_nothing_in_a_program_without_the_spans():
    """Before the port had these spans its registry lacked their labels:
    each reader then leaves its metric out and does not raise."""

    class Bare:
        samples, pairs, window_s = 3, 3 << 20, 9.0

        def timer(self, label):
            return (0.0, 0)

    for name in READERS:
        for sfx in ("", ".cancer15"):
            assert registry.reader(name + sfx).read(Bare()) is None
