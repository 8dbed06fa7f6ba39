"""The port's spans and counters (genefuserust_tpu_torch/utils/spans.py):
the registry's sums, its lock under threads, `record_function` only while
a profiler runs, the labels the port uses, and what a CPU TorchEngine
scan and finish_scan add to them with no environment set."""

import ast
import os
import sys
import threading

import pytest
import torch

from genefuserust_tpu_torch.config import Settings
from genefuserust_tpu_torch.core.mapper import FusionMapper
from genefuserust_tpu_torch.core.scanner import finish_scan
from genefuserust_tpu_torch.io.fastq_block import read_pair_block
from genefuserust_tpu_torch.ops.index import TABLE_SPANS, build_packed_index
from genefuserust_tpu_torch.parallel.engine import TorchEngine
from genefuserust_tpu_torch.utils import spans
from genefuserust_tpu_torch.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_fastq_files,
    write_panel_files,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the benchmark's own span names (gfbench/cell.py): a program span named as
# one of them would be read as the benchmark's
BENCHMARK_SPANS = {"sample", "scan", "flush", "finish_scan", "index_build", "table_pack"}
PORT_LABELS = {
    "st0.merge_pack", "st0.upload", "st1.producer_join", "st1.issue_scan",
    "st3.result_wait", "st3.assemble", "st3.p2_overflow", "ed.flush", "retry.issue",
    "retry.assemble", "report.finish_scan", "report.alignable", "report.write",
    "table.pack", "table.upload", "scan.survivors", "report.matcher_index",
    "matcher.index_reuse", "report.filter", "report.sort", "report.cluster",
    "report.bins_walked", "table.entries", "vote.rows", "vote.rows_sorted",
}


@pytest.fixture
def registry(monkeypatch):
    reg = spans.Registry()
    monkeypatch.setattr(spans, "REGISTRY", reg)
    return reg


def test_sums_calls_nesting_and_counters(registry):
    for _ in range(3):
        with spans.span("outer"):
            with spans.span("inner"):
                pass
            with spans.span("inner"):
                pass
    spans.count("things", 5)
    spans.count("things", 0)
    spans.count("things", 7)
    got = dict(registry.items())
    assert got["outer"][1] == 3 and got["inner"][1] == 6
    assert 0 < got["inner"][0] <= got["outer"][0]
    assert got["things"] == (12, 3)
    assert registry.seconds("outer", "absent") == got["outer"][0]
    with pytest.raises(ValueError):
        with spans.span("raised"):
            raise ValueError
    assert registry["raised"][1] == 1


def test_two_threads_lose_no_update(registry):
    n = 20000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with spans.span("shared"):
                    pass
                spans.count("hits", 1)

        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert registry["shared"][1] == 2 * n
    assert tuple(registry["hits"]) == (2 * n, 2 * n)


def test_no_record_function_without_a_profiler(registry, monkeypatch):
    def refuse(*_):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with spans.span("quiet"):
        pass
    assert registry["quiet"][1] == 1


def test_spans_are_on_the_profilers_clock(registry):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("traced.outer"):
            with spans.span("traced.inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"gf.traced.outer", "gf.traced.inner"} <= names
    assert registry["traced.outer"][1] == registry["traced.inner"][1] == 1


def _labels_in_port():
    """The first argument of every spans.span / spans.count / span(...)
    call in the port's modules."""
    out = set()
    for root, dirs, files in os.walk(os.path.join(REPO, "genefuserust_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        for f in files:
            if not f.endswith(".py"):
                continue
            for node in ast.walk(ast.parse(open(os.path.join(root, f)).read())):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                fn = node.func
                hit = (isinstance(fn, ast.Name) and fn.id == "span") or (
                    isinstance(fn, ast.Attribute) and fn.attr in ("span", "count")
                    and isinstance(fn.value, ast.Name) and fn.value.id == "spans")
                if hit:
                    assert isinstance(node.args[0], ast.Constant), (f, node.lineno)
                    out.add(node.args[0].value)
    return out


def test_every_port_label_is_gf_prefixed_and_not_the_benchmarks():
    labels = _labels_in_port()
    assert labels == PORT_LABELS
    assert set(TABLE_SPANS) <= labels
    for label in labels:
        assert (spans.PREFIX + label).startswith("gf.")
        assert label not in BENCHMARK_SPANS and not label.startswith("gf.")


def test_a_two_panel_scan_fills_the_registry_with_no_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("GENEFUSE_STAGE_TIMERS", raising=False)
    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=10, n_background=60)
    _, csv = write_panel_files(panel, str(tmp_path))
    block = read_pair_block(*write_fastq_files(pairs, str(tmp_path)))
    mappers = [FusionMapper(panel.contigs, csv, Settings(), multi_csv_mode=True)
               for _ in range(2)]
    eng = TorchEngine(Settings(), batch_size=32, device="cpu")
    assert eng._timers is spans.REGISTRY
    survivors = []
    assemble = eng._st3_assemble

    def counted(c):
        if c["scan_f"] is not None:
            survivors.append(int(c["scan_f"].get()[-1, 0]))
        assemble(c)

    monkeypatch.setattr(eng, "_st3_assemble", counted)
    before = dict(spans.REGISTRY.items())

    def delta(label):
        now = dict(spans.REGISTRY.items()).get(label, (0, 0))
        was = before.get(label, (0, 0))
        return now[0] - was[0], now[1] - was[1]

    eng.scan_pair_block_multi(mappers, block)
    eng.flush()
    for k, m in enumerate(mappers):
        finish_scan(m, str(tmp_path / f"{k}.html"), str(tmp_path / f"{k}.json"), "t", Settings())
    batches = -(-len(pairs) // 32)
    assert delta("st3.assemble")[1] == batches * len(mappers)
    assert delta("st3.result_wait")[1] == batches * len(mappers)
    assert delta("st1.producer_join")[1] == batches
    assert delta("st1.issue_scan")[1] == batches * len(mappers)
    assert delta("st0.merge_pack")[1] == delta("st0.upload")[1] == batches
    assert delta("scan.survivors") == (sum(survivors), batches * len(mappers))
    assert sum(survivors) >= 10 * len(mappers)
    for label in ("report.finish_scan", "report.alignable", "report.write"):
        assert delta(label)[1] == len(mappers), label
    assert delta("report.finish_scan")[0] >= delta("report.write")[0] > 0
    assert eng.table_seconds > 0  # the two tables _table_entry built


def test_table_seconds_counts_use_packed(tmp_path):
    panel = make_panel()
    _, csv = write_panel_files(panel, str(tmp_path))
    m = FusionMapper(panel.contigs, csv, Settings())
    packed = build_packed_index(m.indexer)
    eng = TorchEngine(Settings(), device="cpu")
    up0 = spans.REGISTRY.seconds("table.upload")
    eng.use_packed(packed, mapper=m)
    assert eng.table_seconds > 0
    assert eng.table_seconds == pytest.approx(spans.REGISTRY.seconds("table.upload") - up0)
