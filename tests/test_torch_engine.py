"""TorchEngine and the port's CLI against the host oracle and the JAX
engine: same matches, same fusions, byte-identical reports. TorchEngine
runs under the port's own Scanner; the oracle and the JAX engine under
the JAX package's."""

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
from genefuserust_tpu_torch.config import Settings as PortSettings
from genefuserust_tpu_torch.core.scanner import Scanner as PortScanner
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


def _scanner(engine):
    """The port's Scanner and Settings for TorchEngine, the JAX package's
    for its own engines."""
    if isinstance(engine, TorchEngine):
        return PortScanner, PortSettings
    return Scanner, Settings


def _scan(panel, items, tmp_path, engine, name, single_end=False):
    _, csv_path = write_panel_files(panel, str(tmp_path))
    scanner_cls, settings = _scanner(engine)
    scanner = scanner_cls(csv_path, panel.contigs, "", str(tmp_path / name), settings(),
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
    for name, eng in (("torch", TorchEngine(PortSettings(), batch_size=batch, device="cpu")),
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
    eng = TorchEngine(PortSettings(), batch_size=64, device="cpu")
    eng._surv_cap = cap
    html, js = str(tmp_path / "g.html"), str(tmp_path / "g.json")
    PortScanner(csv_path, panel.contigs, html, js, PortSettings(), engine=eng,
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
    lst = tmp_path / "panels.txt"
    lst.write_text(csv + "\n")
    code = (
        "import sys\n"
        "from genefuserust_tpu_torch import cli\n"
        f"for f, o in (({csv!r}, 'o'), ({str(lst)!r}, 'm')):\n"
        f"    cli.main(['-1', {r1!r}, '-2', {r2!r}, '-f', f, '-r', {ref!r},\n"
        f"              '-h', {str(tmp_path)!r} + '/' + o + '.html',\n"
        f"              '-j', {str(tmp_path)!r} + '/' + o + '.json', '--device', 'cpu'])\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = [m for m in sys.modules\n"
        "       if m == 'genefuserust_tpu' or m.startswith('genefuserust_tpu.')]\n"
        "assert not ref, ref\n"
        "print('NOJAX')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX" in r.stdout
    assert (tmp_path / "o.json").exists()
    assert (tmp_path / "m_panel.json").exists()


@pytest.mark.parametrize("layout", ["kvs", "kv16"])
def test_single_probe_layouts_scan_like_jax_and_kv2(tmp_path, monkeypatch, layout):
    """A full scan with GENEFUSE_TABLE_LAYOUT pinned to a single-probe
    layout: TorchEngine's fusions and JSON equal JAX TpuEngine's under the
    same variable (tests/test_kvs.py:272) and the port's own kv2 scan."""
    from genefuserust_tpu.parallel.engine import TpuEngine
    from genefuserust_tpu_torch.ops.index import layout_name

    panel = make_panel()
    pairs = _full_scan_pairs(panel)
    m_kv2, j_kv2 = _scan(panel, pairs, tmp_path,
                         TorchEngine(PortSettings(), batch_size=64, device="cpu"), "kv2.json")
    monkeypatch.setenv("GENEFUSE_TABLE_LAYOUT", layout)
    eng = TorchEngine(PortSettings(), batch_size=64, device="cpu")
    m_t, j_t = _scan(panel, pairs, tmp_path, eng, "torch.json")
    m_j, j_j = _scan(panel, pairs, tmp_path, TpuEngine(Settings(), batch_size=64), "jax.json")
    assert [layout_name(e["packed"]) for e in eng._tables.values()] == [layout]
    assert j_t == j_j == j_kv2
    assert len(m_t.fusion_results) == len(m_j.fusion_results) == len(m_kv2.fusion_results) > 0
    for a, b, c in zip(m_t.fusion_results, m_j.fusion_results, m_kv2.fusion_results):
        assert a.title == b.title == c.title
        assert a.unique == b.unique == c.unique


def test_unported_modes_raise(capsys):
    """The cuda engine takes `--mesh` (multi-device data parallelism is
    ported): `--mesh 4` on the one CPU is refused for the device count, as
    the JAX driver refuses it, not as a mode that is not ported."""
    from genefuserust_tpu_torch.driver import make_engine

    with pytest.raises(SystemExit):
        make_engine("cuda", PortSettings(), device="cpu", mesh="4")
    assert "--mesh 4 requested but only 1 devices are available" in capsys.readouterr().out


def _multi_csv_files(tmp_path):
    """_cli_files plus a second panel CSV and the CSV-list file naming both."""
    ref, csv, r1, r2 = _cli_files(tmp_path)
    csv2 = tmp_path / "panel2.csv"
    csv2.write_text(open(csv).read())
    lst = tmp_path / "panels.txt"
    lst.write_text(f"{csv}\n{csv2}\n")
    return ref, str(lst), r1, r2


@pytest.mark.parametrize("paired", [True, False])
def test_multi_csv_cli_matches_jax_host_cli(tmp_path, capsys, paired):
    from genefuserust_tpu import cli as jax_cli
    from genefuserust_tpu_torch import cli

    ref, lst, r1, r2 = _multi_csv_files(tmp_path)
    reads = ["-1", r1] + (["-2", r2] if paired else [])
    out = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("host", jax_cli.main, ["--engine", "host"])):
        d = tmp_path / name
        d.mkdir()
        assert main([*reads, "-f", lst, "-r", ref, "-h", str(d / "o.html"),
                     "-j", str(d / "o.json"), *extra]) == 0
        assert "#Fusion:" not in capsys.readouterr().out
        out[name] = [_strip_ts((d / f"o_{stem}.{ext}").read_text())
                     for stem in ("panel", "panel2") for ext in ("html", "json")]
    assert out["torch"] == out["host"]
    assert out["torch"][1].replace("panel.csv", "panel2.csv") == out["torch"][3]
    assert '"fusions":{"' in out["torch"][1].replace("\n", "").replace("\t", "")


def test_fusion_rich_batch_takes_the_batched_edit_distance(tmp_path):
    """Enough junction pairs in one batch that its flush reaches the CPU's
    threshold: the batched Myers (plain version on the CPU) carries them,
    and the report still equals the host oracle's."""
    from genefuserust_tpu_torch.parallel.ed_batch import CPU_MIN_JOBS

    panel = make_panel()
    # plant_fusion_pairs' junction moves 7 bp a pair and leaves R1 after
    # ~14 pairs: cycle the spanning ones under new names
    spanning = plant_fusion_pairs(panel, n_support=12, n_background=0)
    pairs = plant_fusion_pairs(panel, n_support=0, n_background=60)
    for j in range(CPU_MIN_JOBS // 2 + 8):
        p = spanning[j % len(spanning)]
        name = f"@SYNTH:rich:{j}"
        pairs.append(SequenceReadPair(SequenceRead(name, p.left.seq, "+", p.left.quality),
                                      SequenceRead(name, p.right.seq, "+", p.right.quality)))
    m_host, j_host = _scan(panel, pairs, tmp_path, HostEngine(), "host.json")
    eng = TorchEngine(PortSettings(), device="cpu")
    m_t, j_t = _scan(panel, pairs, tmp_path, eng, "torch.json")
    assert j_t == j_host and len(m_t.fusion_results) > 0
    assert eng.ed_stats["device_sized"] >= CPU_MIN_JOBS
    assert eng.ed_stats["device"] > 0


def _single_end_workload(panel):
    """Single-end reads: R1 of planted pairs and background, plus the
    reverse complements of a few (the retry path)."""
    pairs = plant_fusion_pairs(panel, n_support=9, n_background=120, seed=5)
    return [p.left for p in pairs] + [p.left.reverse_complement() for p in pairs[:4]]


def _scan_reports(panel, reads, tmp_path, engine, tag):
    _, csv_path = write_panel_files(panel, str(tmp_path))
    html, js = tmp_path / f"{tag}.html", tmp_path / f"{tag}.json"
    scanner_cls, settings = _scanner(engine)
    scanner_cls(csv_path, panel.contigs, str(html), str(js), settings(), engine=engine,
                command="torch-single-end").scan_singles(reads)
    return _strip_ts(html.read_text()), _strip_ts(js.read_text())


def test_single_end_exotic_bytes_route_to_oracle(tmp_path):
    """Single-end analog of tests/test_edge_paths.py::test_exotic_bytes_route_to_oracle."""
    panel = make_panel()
    reads = [p.left for p in plant_fusion_pairs(panel, n_support=5, n_background=10)]
    for k in (0, 2):
        s = list(reads[k].seq)
        s[5], s[40] = "R", "Y"
        reads[k] = SequenceRead(reads[k].name, "".join(s), "+", reads[k].quality)
    host = _scan_reports(panel, reads, tmp_path, HostEngine(), "h")
    got = _scan_reports(panel, reads, tmp_path,
                        TorchEngine(PortSettings(), batch_size=16, device="cpu"), "t")
    assert got == host
    assert '"fusions":{"' in host[1].replace("\n", "").replace("\t", "")


def test_single_end_batch_size_invariance(tmp_path):
    """Single-end analog of tests/test_determinism.py::test_batch_size_invariance."""
    panel = make_panel(seed=21)
    reads = _single_end_workload(panel)
    ref = _scan_reports(panel, reads, tmp_path,
                        TorchEngine(PortSettings(), batch_size=4096, device="cpu"), "b4096")
    assert '"fusions":{"' in ref[1].replace("\n", "").replace("\t", "")
    for bs in (17, 64):
        got = _scan_reports(panel, reads, tmp_path,
                            TorchEngine(PortSettings(), batch_size=bs, device="cpu"), f"b{bs}")
        assert got == ref, f"reports differ at batch_size={bs}"


def test_single_end_pipeline_depth_invariance(tmp_path):
    """Single-end analog of tests/test_determinism.py::test_pipeline_depth_invariance."""
    panel = make_panel(seed=21)
    reads = _single_end_workload(panel)

    def run(depth):
        eng = TorchEngine(PortSettings(), batch_size=32, device="cpu", pipeline_depth=depth)
        return _scan_reports(panel, reads, tmp_path, eng, f"d{depth}")[1]

    ref = run(6)
    for d in (1, 2):
        assert run(d) == ref, f"JSON differs at pipeline_depth={d}"


def test_cuda_device_requires_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEngine(PortSettings(), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_cuda_engine_matches_host(tmp_path, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build, batch, cap, se = WORKLOADS[workload]
    panel = make_panel()
    items = _items(panel, build, se)
    _, j_host = _scan(panel, items, tmp_path, HostEngine(), "host.json", se)
    eng = TorchEngine(PortSettings(), batch_size=batch, device="cuda")
    if cap is not None:
        eng._surv_cap = cap
    assert _scan(panel, items, tmp_path, eng, "cuda.json", se)[1] == j_host
