"""TorchEngine and the port's CLI against the host oracle and the JAX
engine: same matches, same fusions, byte-identical reports."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.read import SequenceRead, SequenceReadPair
from genefuserust_tpu.core.scanner import HostEngine, Scanner
from genefuserust_tpu.core.sequence import reverse_complement
from genefuserust_tpu.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_fastq_files,
    write_panel_files,
)
from genefuserust_tpu_torch.parallel.engine import TorchEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")


def _strip_ts(text: str) -> str:
    return _TS.sub("<ts>", text)


def _full_scan_pairs(panel):
    """Planted junction pairs + background, unmergeable junction pairs
    (R1/R2 mapped separately) and RC-oriented pairs (the retry path)."""
    pairs = plant_fusion_pairs(panel, n_support=8, n_background=120)
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    fused = panel.contigs[c1][s1 + 4600 : s1 + 5001] + panel.contigs[c2][s2 + 6000 : s2 + 6400]
    for k in range(4):
        off = 250 + 9 * k
        r1, r2 = fused[off : off + 150], fused[off + 260 : off + 400]
        pairs.append(SequenceReadPair(
            SequenceRead(f"@SYNTH:nomerge:{k}", r1, "+", "I" * len(r1)),
            SequenceRead(f"@SYNTH:nomerge:{k}", reverse_complement(r2), "+", "I" * len(r2)),
        ))
    for k in range(3):
        off = 255 + 8 * k
        r1 = reverse_complement(fused[off : off + 150])
        r2 = fused[off + 40 : off + 190]
        pairs.append(SequenceReadPair(
            SequenceRead(f"@SYNTH:rc:{k}", r1, "+", "I" * 150),
            SequenceRead(f"@SYNTH:rc:{k}", r2, "+", "I" * 150),
        ))
    return pairs


def _n_laced_pairs(panel):
    rng = np.random.default_rng(11)
    out = []
    for k, p in enumerate(plant_fusion_pairs(panel, n_support=6, n_background=40)):
        if k % 2 == 0:
            out.append(p)
            continue
        s = bytearray(p.left.seq.encode())
        for _ in range(int(rng.integers(1, 4))):
            s[int(rng.integers(0, len(s)))] = ord("N") if rng.random() < 0.7 else ord("a")
        out.append(SequenceReadPair(
            SequenceRead(p.left.name, s.decode(), "+", p.left.quality), p.right))
    return out


# name -> (pairs builder, batch size, survivor cap, single-end)
WORKLOADS = {
    "full_scan": (_full_scan_pairs, 64, None, False),
    "survivor_cap_overflow": (
        lambda panel: plant_fusion_pairs(panel, n_support=10, n_background=40), 64, 2, False),
    "n_bases": (_n_laced_pairs, 32, None, False),
    "single_end": (
        lambda panel: plant_fusion_pairs(panel, n_support=8, n_background=60), 32, None, True),
}


def _scan(panel, items, tmp_path, engine, name, single_end=False):
    _, csv_path = write_panel_files(panel, str(tmp_path))
    scanner = Scanner(csv_path, panel.contigs, "", str(tmp_path / name), Settings(),
                      engine=engine, command="torch-equality-test")
    mapper = scanner.scan_singles(items) if single_end else scanner.scan_pairs(items)
    text = (tmp_path / name).read_text()
    return mapper, "\n".join(l for l in text.splitlines() if not l.startswith('\t"time"'))


def _items(panel, build, single_end):
    pairs = build(panel)
    if single_end:
        return [p.left for p in pairs] + [p.left.reverse_complement() for p in pairs[:5]]
    return pairs


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_engine_matches_host_and_jax(tmp_path, workload):
    from genefuserust_tpu.parallel.engine import TpuEngine

    build, batch, cap, se = WORKLOADS[workload]
    panel = make_panel()
    items = _items(panel, build, se)
    m_host, j_host = _scan(panel, items, tmp_path, HostEngine(), "host.json", se)
    results = {}
    for name, eng in (("torch", TorchEngine(Settings(), batch_size=batch, device="cpu")),
                      ("jax", TpuEngine(Settings(), batch_size=batch))):
        if cap is not None:
            eng._surv_cap = cap
        results[name] = _scan(panel, items, tmp_path, eng, f"{name}.json", se)
    m_t, j_t = results["torch"]
    assert j_t == j_host == results["jax"][1]
    assert len(m_t.fusion_results) == len(m_host.fusion_results) > 0
    for a, b in zip(m_host.fusion_results, m_t.fusion_results):
        assert (a.title, a.unique) == (b.title, b.unique)
        assert [(m.read.name, m.read_break, m.reversed) for m in a.matches] == [
            (m.read.name, m.read_break, m.reversed) for m in b.matches]


@pytest.mark.parametrize("cap", [1024, 2])
def test_goldens(tmp_path, cap):
    """tests/goldens/planted.{json,html} byte for byte (timestamps
    stripped); cap 2 takes the survivor-overflow path."""
    panel = make_panel(seed=33)
    pairs = plant_fusion_pairs(panel, n_support=7, n_background=80, seed=9)
    _, csv_path = write_panel_files(panel, str(tmp_path))
    eng = TorchEngine(Settings(), batch_size=64, device="cpu")
    eng._surv_cap = cap
    html, js = str(tmp_path / "g.html"), str(tmp_path / "g.json")
    Scanner(csv_path, panel.contigs, html, js, Settings(), engine=eng,
            command="golden-run").scan_pairs(pairs)
    assert _strip_ts(open(js).read()) == open(os.path.join(GOLDEN_DIR, "planted.json")).read()
    assert _strip_ts(open(html).read()) == open(os.path.join(GOLDEN_DIR, "planted.html")).read()
    assert eng.ed_stats["jobs"] > 0


def _cli_files(tmp_path):
    panel = make_panel(seed=21)
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=50, seed=4)
    ref, csv = write_panel_files(panel, str(tmp_path))
    r1, r2 = write_fastq_files(pairs, str(tmp_path))
    return ref, csv, r1, r2


@pytest.mark.parametrize("paired", [True, False])
def test_cli_matches_jax_host_cli(tmp_path, paired):
    from genefuserust_tpu import cli as jax_cli
    from genefuserust_tpu_torch import cli

    ref, csv, r1, r2 = _cli_files(tmp_path)
    reads = ["-1", r1] + (["-2", r2] if paired else [])
    out = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("host", jax_cli.main, ["--engine", "host"])):
        h, j = str(tmp_path / f"{name}.html"), str(tmp_path / f"{name}.json")
        assert main([*reads, "-f", csv, "-r", ref, "-h", h, "-j", j, *extra]) == 0
        out[name] = (_strip_ts(open(h).read()), _strip_ts(open(j).read()))
    assert out["torch"] == out["host"]
    assert '"fusions"' in out["torch"][1]


def test_port_scan_never_imports_jax(tmp_path):
    ref, csv, r1, r2 = _cli_files(tmp_path)
    code = (
        "import sys\n"
        "from genefuserust_tpu_torch import cli\n"
        f"cli.main(['-1', {r1!r}, '-2', {r2!r}, '-f', {csv!r}, '-r', {ref!r},\n"
        f"          '-h', {str(tmp_path / 'o.html')!r}, '-j', {str(tmp_path / 'o.json')!r},\n"
        "          '--device', 'cpu'])\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('NOJAX')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX" in r.stdout
    assert (tmp_path / "o.json").exists()


@pytest.mark.parametrize("layout", ["kvs", "kv16"])
def test_single_probe_layouts_raise_in_engine(tmp_path, monkeypatch, layout):
    panel = make_panel()
    monkeypatch.setenv("GENEFUSE_TABLE_LAYOUT", layout)
    with pytest.raises(NotImplementedError, match="kvs and kv16"):
        _scan(panel, plant_fusion_pairs(panel, n_support=2, n_background=2), tmp_path,
              TorchEngine(Settings(), batch_size=32, device="cpu"), "x.json")


def test_unported_modes_raise(tmp_path):
    from genefuserust_tpu_torch import cli
    from genefuserust_tpu_torch.driver import make_engine

    ref, csv, r1, r2 = _cli_files(tmp_path)
    lst = tmp_path / "panels.txt"
    lst.write_text(csv + "\n")
    with pytest.raises(NotImplementedError, match="multi-CSV"):
        cli.main(["-1", r1, "-2", r2, "-f", str(lst), "-r", ref, "--device", "cpu",
                  "-h", str(tmp_path / "a.html"), "-j", str(tmp_path / "a.json")])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        make_engine("cuda", Settings(), device="cpu", mesh="4")


def test_cuda_device_requires_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEngine(Settings(), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_cuda_engine_matches_host(tmp_path, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build, batch, cap, se = WORKLOADS[workload]
    panel = make_panel()
    items = _items(panel, build, se)
    _, j_host = _scan(panel, items, tmp_path, HostEngine(), "host.json", se)
    eng = TorchEngine(Settings(), batch_size=batch, device="cuda")
    if cap is not None:
        eng._surv_cap = cap
    assert _scan(panel, items, tmp_path, eng, "cuda.json", se)[1] == j_host
