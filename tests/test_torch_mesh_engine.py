"""The port's data-parallel engine: TorchEngine over a device list, whole
batches in turn (batch k on entry k mod n), against the JAX TpuEngine on
the 8-device virtual CPU mesh (one batch split over the mesh), the port's
one-device engine and the host oracle. Reports are byte-identical (JSON
and HTML, timestamps masked), paired-end and single-end, for n = 1, 2, 3
and 8 entries of the CPU: the inputs of tests/test_mesh_engine.py with
enough pairs for 2n batches of 64 at n = 8. One case overflows the
survivor cap on more than one entry and retries reverse complements."""

import re

import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.read import SequenceRead, SequenceReadPair
from genefuserust_tpu.core.scanner import HostEngine, Scanner
from genefuserust_tpu.core.sequence import reverse_complement
from genefuserust_tpu.utils.synthetic import make_panel, plant_fusion_pairs, write_panel_files
from genefuserust_tpu_torch.config import Settings as PortSettings
from genefuserust_tpu_torch.core.scanner import Scanner as PortScanner
from genefuserust_tpu_torch.parallel.engine import TorchEngine

_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")
BATCH = 64
N_ENTRIES = (1, 2, 3, 8)
CPU = torch.device("cpu")


def _scan(panel, csv_path, items, tmp_path, tag, engine, se):
    port = isinstance(engine, TorchEngine)
    html, json = tmp_path / f"{tag}.html", tmp_path / f"{tag}.json"
    scanner = (PortScanner if port else Scanner)(
        csv_path, panel.contigs, str(html), str(json), (PortSettings if port else Settings)(),
        engine=engine, command="mesh-test")
    (scanner.scan_singles if se else scanner.scan_pairs)(items)
    return _TS.sub("<ts>", html.read_text()), _TS.sub("<ts>", json.read_text())


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """tests/test_mesh_engine.py's panel and planted pairs, with 1,024
    background pairs: 17 batches of 64."""
    tmp = tmp_path_factory.mktemp("mesh")
    panel = make_panel(seed=42)
    pairs = plant_fusion_pairs(panel, n_support=8, n_background=2 * max(N_ENTRIES) * BATCH,
                               seed=13)
    assert len(pairs) >= 2 * max(N_ENTRIES) * BATCH
    _, csv_path = write_panel_files(panel, str(tmp))
    return panel, csv_path, pairs, tmp


@pytest.fixture(scope="module")
def workload(inputs):
    """`inputs` -> with the reports of the JAX mesh engine, JAX's
    one-device engine and the host oracle, PE and SE, made once."""
    import jax

    from genefuserust_tpu.parallel.engine import TpuEngine
    from genefuserust_tpu.parallel.mesh import make_mesh

    panel, csv_path, pairs, tmp = inputs
    mesh = make_mesh(jax.devices()[:8])
    refs = {}
    for se, items in ((False, pairs), (True, [p.left for p in pairs])):
        refs[se] = [_scan(panel, csv_path, items, tmp, f"{tag}{se}", eng, se) for tag, eng in (
            ("jax_mesh", TpuEngine(Settings(), batch_size=BATCH, mesh=mesh)),
            ("jax_one", TpuEngine(Settings(), batch_size=BATCH)),
            ("host", HostEngine()))]
        assert refs[se][0] == refs[se][1] == refs[se][2]
        assert '"unique"' in refs[se][0][1]
    return panel, csv_path, pairs, tmp, refs


@pytest.mark.parametrize("n", N_ENTRIES)
@pytest.mark.parametrize("se", [False, True], ids=["pe", "se"])
def test_device_list_equals_jax_mesh_one_device_and_host(tmp_path, workload, n, se):
    panel, csv_path, pairs, _, refs = workload
    items = [p.left for p in pairs] if se else pairs
    eng = TorchEngine(PortSettings(), batch_size=BATCH, devices=[CPU] * n)
    got = _scan(panel, csv_path, items, tmp_path, "port", eng, se)
    one = _scan(panel, csv_path, items, tmp_path, "one",
                TorchEngine(PortSettings(), batch_size=BATCH, device="cpu"), se)
    assert got == one == refs[se][0]
    n_batches = -(-len(items) // BATCH)
    assert eng.entry_batches == [len(range(k, n_batches, n)) for k in range(n)]
    assert min(eng.entry_batches) >= 2


def _overflow_pairs(panel):
    """Junction pairs in every batch of 32 (the cap of 2 overflows in each)
    and reverse-complement-oriented junction pairs among them (the retry
    path), between background pairs."""
    base = plant_fusion_pairs(panel, n_support=12, n_background=100, seed=5)
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    fused = panel.contigs[c1][s1 + 4600 : s1 + 5001] + panel.contigs[c2][s2 + 6000 : s2 + 6400]
    rc = []
    for k in range(6):
        off = 255 + 8 * k
        r1 = reverse_complement(fused[off : off + 150])
        r2 = fused[off + 40 : off + 190]
        rc.append(SequenceReadPair(SequenceRead(f"@SYNTH:rc:{k}", r1, "+", "I" * 150),
                                   SequenceRead(f"@SYNTH:rc:{k}", r2, "+", "I" * 150)))
    junction = [p for p in base if "fusion" in p.left.name]
    background = [p for p in base if "fusion" not in p.left.name]
    out = []
    for b in range(4):  # batches of 32: 3 junction pairs, up to 2 RC pairs each
        out += junction[3 * b : 3 * b + 3] + rc[2 * b : 2 * b + 2]
        out += background[25 * b : 25 * b + 25]
    return out + background[100:]


@pytest.mark.parametrize("n", [2, 3])
def test_survivor_overflow_and_retries_on_several_entries(tmp_path, n):
    """Survivor cap 2 at batches of 32: the overflow rescans on each
    batch's own entry (two entries at least), the reverse-complement
    retries on entry 0, and the reports equal the host oracle's, JAX's and
    the one-device port's at the same cap."""
    from genefuserust_tpu.parallel.engine import TpuEngine

    panel = make_panel()
    pairs = _overflow_pairs(panel)
    _, csv_path = write_panel_files(panel, str(tmp_path))
    host = _scan(panel, csv_path, pairs, tmp_path, "host", HostEngine(), False)
    jax_eng = TpuEngine(Settings(), batch_size=32)
    jax_eng._surv_cap = 2
    one = TorchEngine(PortSettings(), batch_size=32, device="cpu")
    eng = TorchEngine(PortSettings(), batch_size=32, devices=[CPU] * n)
    overflow, retried = [], []
    p2, retry = eng._p2_overflow, eng._retry_issue

    def p2_rec(c, n_count):
        overflow.append(eng._entries.index(c["shared"]["entry"]))
        return p2(c, n_count)

    def retry_rec(mapper, items):
        retried.append(len(items))
        return retry(mapper, items)

    eng._p2_overflow, eng._retry_issue = p2_rec, retry_rec
    reports = {}
    for tag, e in (("jax", jax_eng), ("one", one), ("port", eng)):
        e._surv_cap = 2
        reports[tag] = _scan(panel, csv_path, pairs, tmp_path, tag, e, False)
    assert reports["port"] == reports["one"] == reports["jax"] == host
    assert '"unique"' in host[1]
    assert len(set(overflow)) >= 2, overflow
    assert sum(retried) >= 2  # direction-rejected survivors, retried on entry 0


@pytest.mark.cuda
@pytest.mark.parametrize("se", [False, True], ids=["pe", "se"])
def test_entries_on_one_card_equal_the_cpu(tmp_path, inputs, se):
    """Three entries of the one card, each with its own streams, give the
    one-device CPU engine's reports (held to JAX's above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    panel, csv_path, pairs, _ = inputs
    items = [p.left for p in pairs] if se else pairs
    eng = TorchEngine(PortSettings(), batch_size=BATCH, devices=["cuda:0"] * 3)
    got = _scan(panel, csv_path, items, tmp_path, "card", eng, se)
    assert got == _scan(panel, csv_path, items, tmp_path, "cpu",
                        TorchEngine(PortSettings(), batch_size=BATCH, device="cpu"), se)
    assert '"unique"' in got[1] and min(eng.entry_batches) >= 2
