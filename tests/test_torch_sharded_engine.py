"""The port's ShardedIndexEngine, its CLI choice and `--mesh` against the
host oracle and the JAX package's sharded engine: byte-identical reports
(timestamps stripped). The shards sit on the CPU here, several on one
device, as the JAX tests put them on virtual CPU devices."""

import re

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.scanner import HostEngine, Scanner
from genefuserust_tpu.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_fastq_files,
    write_panel_files,
)
from genefuserust_tpu_torch.config import Settings as PortSettings
from genefuserust_tpu_torch.core.scanner import Scanner as PortScanner
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.parallel.sharded_engine import ShardedIndexEngine

_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")
CPU = torch.device("cpu")


def _scan(panel, csv_path, items, tmp_path, tag, engine, single_end=False):
    html, js = tmp_path / f"{tag}.html", tmp_path / f"{tag}.json"
    port = isinstance(engine, ShardedIndexEngine)
    scanner = (PortScanner if port else Scanner)(
        csv_path, panel.contigs, str(html), str(js), (PortSettings if port else Settings)(),
        engine=engine, command="sharded-test")
    (scanner.scan_singles if single_end else scanner.scan_pairs)(items)
    return _TS.sub("<ts>", html.read_text()), _TS.sub("<ts>", js.read_text())


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """tests/test_sharded_engine.py's panel and pairs."""
    panel = make_panel(seed=17)
    pairs = plant_fusion_pairs(panel, n_support=7, n_background=60, seed=3)
    _, csv_path = write_panel_files(panel, str(tmp_path_factory.mktemp("panel")))
    return panel, pairs, csv_path


@pytest.mark.parametrize("single_end", [False, True])
def test_sharded_engine_matches_host_and_jax(tmp_path, workload, single_end):
    import jax

    from genefuserust_tpu.parallel.mesh import make_mesh
    from genefuserust_tpu.parallel.sharded_engine import ShardedIndexEngine as JaxSharded

    panel, pairs, csv_path = workload
    items = ([p.left for p in pairs] + [p.left.reverse_complement() for p in pairs[:4]]
             if single_end else pairs)
    host = _scan(panel, csv_path, items, tmp_path, "host", HostEngine(), single_end)
    assert '"unique"' in host[1]
    mesh = make_mesh(jax.devices()[:4], axis="shard")
    for tag, eng in (("port", ShardedIndexEngine(PortSettings(), devices=[CPU] * 4,
                                                 batch_size=32)),
                     ("jax", JaxSharded(Settings(), mesh=mesh, batch_size=32))):
        assert _scan(panel, csv_path, items, tmp_path, tag, eng, single_end) == host, tag


@pytest.mark.parametrize("shards", [1, 3])
def test_sharded_engine_shard_count_invariance(tmp_path, workload, shards):
    """One shard, and three (a count that is no power of two, on a 2-gene
    panel: one shard owns no k-mer), give the host oracle's reports."""
    panel, pairs, csv_path = workload
    host = _scan(panel, csv_path, pairs, tmp_path, "host", HostEngine())
    eng = ShardedIndexEngine(PortSettings(), devices=[CPU] * shards, batch_size=17)
    assert _scan(panel, csv_path, pairs, tmp_path, "port", eng) == host
    assert eng.n_shards == shards and eng.table_bytes > 0 and eng.ed_stats["jobs"] > 0


def test_installed_tables_serve_every_mapper(tmp_path, workload):
    """use_tables: another engine's shard tables, used for each mapper
    without a pack of its own; one table a device, in order."""
    panel, pairs, csv_path = workload
    host = _scan(panel, csv_path, pairs, tmp_path, "host", HostEngine())
    built = ShardedIndexEngine(PortSettings(), devices=[CPU] * 2, batch_size=32)
    assert _scan(panel, csv_path, pairs, tmp_path, "built", built) == host
    eng = ShardedIndexEngine(PortSettings(), devices=[CPU] * 2, batch_size=32)
    eng.use_tables(built._indexes)
    for k in range(2):  # a new mapper each scan
        assert _scan(panel, csv_path, pairs, tmp_path, f"installed{k}", eng) == host
    assert eng.table_seconds == 0 and eng.table_bytes == built.table_bytes
    with pytest.raises(ValueError, match="one table per device"):
        ShardedIndexEngine(PortSettings(), devices=[CPU] * 3).use_tables(built._indexes)


def _cli_files(tmp_path):
    panel = make_panel(seed=21)
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=50, seed=4)
    ref, csv = write_panel_files(panel, str(tmp_path))
    r1, r2 = write_fastq_files(pairs, str(tmp_path))
    return ref, csv, r1, r2


@pytest.mark.parametrize("paired", [True, False])
def test_sharded_cli_matches_host_cli(tmp_path, paired):
    from genefuserust_tpu import cli as jax_cli
    from genefuserust_tpu_torch import cli

    ref, csv, r1, r2 = _cli_files(tmp_path)
    reads = ["-1", r1] + (["-2", r2] if paired else [])
    out = {}
    for name, main, extra in (
            ("sharded", cli.main, ["--engine", "sharded-index", "--device", "cpu", "--mesh", "1"]),
            ("host", jax_cli.main, ["--engine", "host"])):
        h, j = str(tmp_path / f"{name}.html"), str(tmp_path / f"{name}.json")
        assert main([*reads, "-f", csv, "-r", ref, "-h", h, "-j", j, *extra]) == 0
        out[name] = (_TS.sub("<ts>", open(h).read()), _TS.sub("<ts>", open(j).read()))
    assert out["sharded"] == out["host"]
    assert '"fusions"' in out["sharded"][1]


def test_driver_takes_a_device_list():
    from genefuserust_tpu_torch.driver import make_engine

    eng = make_engine("sharded-index", PortSettings(), device="cpu", devices=["cpu"] * 3)
    assert isinstance(eng, ShardedIndexEngine) and eng.n_shards == 3
    eng = make_engine("sharded-index", PortSettings(), device="cpu", mesh="auto")
    assert eng.n_shards == 1 and eng.devices == [CPU]
    with pytest.raises(ValueError, match="1 to 8 shards"):
        ShardedIndexEngine(PortSettings(), devices=[CPU] * (tm.MAX_SHARDS + 1))


@pytest.mark.parametrize("spec", ["2", "9"])
def test_mesh_above_the_device_count_exits_as_the_jax_driver(capsys, spec):
    """`--mesh N` above the device count exits with the JAX driver's
    message (genefuserust_tpu/driver.py::_resolve_mesh, 8 virtual devices
    here), naming the port's count (one CPU)."""
    from genefuserust_tpu.driver import _resolve_mesh
    from genefuserust_tpu_torch.driver import make_engine
    from genefuserust_tpu_torch.parallel.mesh import resolve_mesh

    with pytest.raises(SystemExit):
        _resolve_mesh("9")
    jax_msg = capsys.readouterr().out
    with pytest.raises(SystemExit):
        make_engine("sharded-index", PortSettings(), device="cpu", mesh=spec)
    port_msg = capsys.readouterr().out
    assert port_msg == jax_msg.replace("--mesh 9", f"--mesh {spec}").replace("only 8", "only 1")
    assert resolve_mesh("auto", "cpu") == resolve_mesh("1", "cpu") == [CPU]


def test_cuda_engine_mesh_still_raises(capsys):
    """`--mesh 2` with the cuda engine on the one CPU exits with the JAX
    driver's message, as the sharded engine does (the data-parallel engine
    takes `--mesh`; it no longer raises NotImplementedError)."""
    from genefuserust_tpu.driver import _resolve_mesh
    from genefuserust_tpu_torch.driver import make_engine

    with pytest.raises(SystemExit):
        _resolve_mesh("9")
    jax_msg = capsys.readouterr().out
    with pytest.raises(SystemExit):
        make_engine("cuda", PortSettings(), device="cpu", mesh="2")
    assert capsys.readouterr().out == jax_msg.replace("--mesh 9", "--mesh 2").replace(
        "only 8", "only 1")


# ---------------- on the card ----------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_sharded_kernels_match_plain(workload, shards, cuda_device):
    """Each kernel of the sharded path bit-equal to its plain version on
    S shard tables on one card: the split probe, the vote's counts mode,
    the merge, the flags and mask+segments from flags; and the whole
    sharded map_read."""
    from genefuserust_tpu_torch.core.indexer import Indexer
    from genefuserust_tpu_torch.core.sequence import encode_bases
    from genefuserust_tpu_torch.models.fusion import Fusion
    from genefuserust_tpu_torch.parallel import sharded_index as tsi

    panel, pairs, csv_path = workload
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), PortSettings())
    ix.make_index()
    _, packs = tsi.pack_index_sharded(ix, shards)
    cpu = tsi.shard_indexes(packs, [CPU] * shards)
    dev = tsi.shard_indexes(packs, [cuda_device] * shards)
    seqs = [s for p in pairs for s in (p.left.seq, p.right.seq)]
    codes = np.full((len(seqs), 160), 255, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_bases(s)
    ct = torch.from_numpy(codes)
    lt = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    cd, ld = ct.to(cuda_device), lt.to(cuda_device)
    votes = []
    for c, d in zip(cpu, dev):
        pr = tm.probe(ct, lt, 2, c)
        assert torch.equal(tm.probe(cd, ld, 2, d).cpu(), pr)
        votes.append(tm.vote_counts_plain(pr, c))
        assert torch.equal(tm.vote_counts(pr.to(cuda_device), d).cpu(), votes[-1])
    ok, gp = tm.merge_top2_plain(votes, 40, 20)
    got = tm.merge_top2([v.to(cuda_device) for v in votes], 40, 20)
    assert torch.equal(got[0].cpu(), ok) and torch.equal(got[1].cpu(), gp)
    NK = 160 - 15
    words = wd = None
    for c, d in zip(cpu, dev):
        pr1 = tm.probe(ct, lt, 1, c)
        words = tm.shard_flags([pr1], lt, gp, [c], words)
        wd = tm.shard_flags([pr1.to(cuda_device)], ld, gp.to(cuda_device), [d], wd)
        assert torch.equal(wd.cpu(), words)
    exp = tm.mask_from_flags_plain(words, lt, gp, NK, 10)
    assert torch.equal(tm.mask_from_flags(wd, ld, gp.to(cuda_device), NK, 10).cpu(), exp)
    got = tsi.sharded_map_read(cd, ld, dev)
    for g, e in zip(got, tsi.sharded_map_read(ct, lt, cpu)):
        assert torch.equal(g.cpu(), e)
    assert ok.any()


@pytest.mark.cuda
def test_sharded_map_read_across_devices(workload, cuda_device):
    """Shards on two devices (the card and the CPU, in turn): each shard's
    steps run on its own device, the vote rows and flag words meet on the
    first, and the result equals the all-CPU one."""
    from genefuserust_tpu_torch.core.indexer import Indexer
    from genefuserust_tpu_torch.core.sequence import encode_bases
    from genefuserust_tpu_torch.models.fusion import Fusion
    from genefuserust_tpu_torch.parallel import sharded_index as tsi

    panel, pairs, csv_path = workload
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), PortSettings())
    ix.make_index()
    _, packs = tsi.pack_index_sharded(ix, 4)
    seqs = [p.left.seq for p in pairs]
    codes = np.full((len(seqs), 160), 255, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_bases(s)
    ct = torch.from_numpy(codes)
    lt = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    exp = tsi.sharded_map_read(ct, lt, tsi.shard_indexes(packs, [CPU] * 4))
    for first in (cuda_device, CPU):
        other = CPU if first == cuda_device else cuda_device
        mixed = tsi.shard_indexes(packs, [first, other, first, other])
        got = tsi.sharded_map_read(ct.to(first), lt.to(first), mixed)
        for g, e in zip(got, exp):
            assert g.device.type == first.type and torch.equal(g.cpu(), e)


@pytest.mark.cuda
@pytest.mark.parametrize("single_end", [False, True])
def test_cuda_sharded_engine_matches_host(tmp_path, workload, single_end, cuda_device):
    panel, pairs, csv_path = workload
    items = [p.left for p in pairs] if single_end else pairs
    host = _scan(panel, csv_path, items, tmp_path, "host", HostEngine(), single_end)
    eng = ShardedIndexEngine(PortSettings(), devices=[cuda_device] * 4, batch_size=32)
    assert _scan(panel, csv_path, items, tmp_path, "cuda", eng, single_end) == host
