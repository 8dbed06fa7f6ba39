"""BENCHMARK.json and the files it names: every configuration, traffic
mix and per-layer reader is found by name, and a new traffic file is
taken with no code edited."""

import json
import os
import re

import pytest

from gfbench import panel, registry, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_named_file_is_found():
    b = registry.benchmark()
    for c in b["configs"]:
        assert c["file"] == f"gfbench/configs/{c['name']}.json"
        assert registry.config(c["name"])["name"] == c["name"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert registry.config(w["config"]) and registry.traffic(w["traffic"])
        assert w["chips"] == 1
    for m in b["per_layer"]:
        assert callable(registry.reader(m["name"]).read)
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_names_and_units():
    b = registry.benchmark()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[kind]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {"setup_s", "pairs_per_s"} <= {m["name"] for m in b["end_to_end"]}


def test_every_cell_reports_set_up_another_end_to_end_metric_and_a_layer():
    b = registry.benchmark()
    for w in b["workloads"]:
        e2e = {m["name"] for m in registry.metrics_of(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = registry.metrics_of(w["name"], "per_layer")
        assert layers and all(m["moves"] in e2e for m in layers)
    for m in b["end_to_end"] + b["per_layer"]:
        for w in m.get("workloads", []):
            registry.workload(w)
    assert os.path.getsize(os.path.join(registry.ROOT, "BENCHMARK.json")) < 64 * 1024


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        registry.workload("no-such-cell")
    with pytest.raises(KeyError):
        registry.traffic("no-such-mix")
    with pytest.raises(KeyError):
        registry.reader("no_such_metric")


def test_a_new_traffic_file_is_taken_without_code(tmp_path, small):
    mix = {**registry.traffic("pe-targeted"), **small["traffic"], "name": "gfbench-test-mix",
           "on_target": 0.5, "chimera": 0.05}
    path = os.path.join(registry.HERE, "traffic", "gfbench-test-mix.json")
    with open(path, "w") as f:
        json.dump(mix, f)
    try:
        got = registry.traffic("gfbench-test-mix")
        cfg = {**registry.config("cancer15"), **small["config"]}
        p = panel.make_panel(cfg, 3, str(tmp_path))
        s = traffic.generate(got, p.genes, p.exon_starts, p.gene_start, 3)
        assert (s.kind == traffic.CHIMERA).sum() == int(4096 * 0.05)
        assert (s.kind == traffic.ON).sum() == int(4096 * 0.5)
    finally:
        os.remove(path)
