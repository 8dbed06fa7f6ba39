"""The 1,100-gene panel (gfbench cell `oncokb1100-pe-targeted`) through the
port's normal path on the CPU, at a small span a gene: 1,100 genes are past
the kv layouts' packed-payload budget, so the table is packed split, and the
mapper holds 1.21M match bins. The run is held to the benchmark's plain
reference (gfbench/reference) as a card run is."""

import time

import pytest

from gfbench import registry
from gfbench.cell import run_cell

CELL = "oncokb1100-pe-targeted"
GENES = 1100
# 8 kbp a gene (the planted junctions stay inside their genes), batches of
# 1,024, 3,072 pairs with 1% random chimeras, so that bins across the
# panel's gene pairs fill and are filtered
SIZES = {"config": {"panel_bp": GENES * 8000, "batch_pairs": 1024},
         "traffic": {"pairs_per_sample": 3072, "chimera": 0.01}}
READERS = ("table_pack_s", "report_sort_cluster_s_per_sample", "bins_walked_per_sample")


@pytest.fixture(scope="module")
def traced():
    said = []
    out = run_cell(CELL, 2**31 + 2323, 0.1, True, time.perf_counter(), device="cpu",
                   sizes={k: dict(v) for k, v in SIZES.items()}, say=said.append)
    prov = next(s["provenance"] for s in said if "provenance" in s)
    return out, prov


def test_the_configuration_is_the_whole_list_at_cancer15s_span():
    cfg = registry.config(registry.workload(CELL)["config"])
    assert cfg["genes"] == GENES and cfg["csvs"] == 1 and cfg["reduced"] == []
    assert cfg["panel_bp"] // cfg["genes"] == 15_100_000 // 136


def test_the_panel_packs_split_and_reads_correct(traced):
    out, prov = traced
    assert prov["table_layouts"] == ["split"]
    assert out["correct"], out["checks"]
    assert out["checks"]["pairs_differing"]["value"] == 0
    assert out["checks"]["reports_differing"]["value"] == 0


def test_the_new_readers_read_the_run(traced):
    out, prov = traced
    for name in READERS:
        assert out["metrics"][f"{name}.oncokb1100"]["value"] > 0, name
    # a sample's finish_scan walks the bins its matches landed in, not the
    # panel's 1.21M
    walked = out["metrics"]["bins_walked_per_sample.oncokb1100"]["value"]
    assert walked < 0.01 * GENES * GENES


def test_a_cpu_run_leaves_the_vote_share_out(traced):
    """The vote's row counter counts the card's warp path: on the CPU the
    engine adds no `vote.rows`, and the reader leaves its metric out."""
    out, _ = traced
    assert "vote_sort_share.oncokb1100" not in out["metrics"]


def test_the_readers_find_nothing_in_a_program_without_the_spans():
    """On a program without these spans and this counter each reader
    leaves its metric out and does not raise."""

    class Bare:
        samples, pairs, window_s, profile = 3, 3 << 20, 9.0, None

        def timer(self, label):
            return (0.0, 0)

    for name in ("report_sort_cluster_s_per_sample", "bins_walked_per_sample",
                 "probe_roofline"):
        assert registry.reader(f"{name}.oncokb1100").read(Bare()) is None
