"""The port's multi-process helpers (genefuserust_tpu_torch/parallel/
distributed.py) and the driver's device lists for the data-parallel
engine.

Two REAL processes on localhost (gloo on the CPU, 4 devices listed by
each) initialise a process group through distributed.init, form the
8-place global (data, shard) mesh with distributed.make_mesh and
all-reduce each process's local half of a length-8 array: the sum of
tests/test_distributed.py, whose JAX run makes the same mesh of 2
processes x 4 virtual CPU devices."""

import os
import re
import socket
import subprocess
import sys

import pytest

from genefuserust_tpu.utils.synthetic import make_panel, plant_fusion_pairs, write_fastq_files
from genefuserust_tpu.utils.synthetic import write_panel_files
from genefuserust_tpu_torch.config import Settings as PortSettings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")

_WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from genefuserust_tpu_torch.parallel import distributed

addr, pid = sys.argv[1], int(sys.argv[2])
assert distributed.init(init_method=addr, world_size=2, rank=pid, backend="gloo")
assert dist.get_world_size() == 2 and dist.get_rank() == pid
assert distributed.local_devices() == [torch.device("cpu")]

mesh = distributed.make_mesh(data_axis=8, shard_axis=1, devices=["cpu"] * 4)
assert mesh.axis_names == ("data", "shard") and mesh.shape == (8, 1)
assert mesh.ranks[:, 0].tolist() == [0] * 4 + [1] * 4, mesh.ranks
assert set(mesh.devices.reshape(-1)) == {"cpu"}
assert np.argwhere(mesh.ranks == pid).tolist() == [[4 * pid + k, 0] for k in range(4)]

# each process contributes its local half of a global length-8 array
local = np.arange(4, dtype=np.int32) + 100 * (pid + 1)
total = torch.tensor([int(local.sum())], dtype=torch.int64)
dist.all_reduce(total)
expected = (100 * 1 + 100 * 2) * 4 + 2 * (0 + 1 + 2 + 3)
assert int(total[0]) == expected, total
assert "jax" not in sys.modules
dist.destroy_process_group()
print(f"proc {pid} OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_init_mesh_and_all_reduce():
    addr = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, addr, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} OK" in out


def test_single_process_init_is_a_noop_and_mesh_is_local(monkeypatch):
    """One process: no process group (as jax.distributed.initialize is
    skipped), and the mesh is this process's devices, with the JAX
    function's defaulting of the axes and its assert on their product."""
    import torch
    import torch.distributed as dist

    from genefuserust_tpu_torch.parallel import distributed

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.init() is False and not dist.is_initialized()
    assert distributed.init(world_size=1) is False
    assert distributed.local_devices() == [torch.device("cpu")]
    m = distributed.make_mesh(devices=["cpu"] * 6)
    assert m.shape == (6, 1) and (m.ranks == 0).all()
    assert distributed.make_mesh(0, 3, devices=["cpu"] * 6).shape == (2, 3)
    assert distributed.make_mesh(2, 0, devices=["cpu"] * 6).shape == (2, 3)
    with pytest.raises(AssertionError):
        distributed.make_mesh(4, 1, devices=["cpu"] * 6)
    with pytest.raises(RuntimeError, match="nccl"):
        distributed.init(init_method="tcp://127.0.0.1:1", world_size=1, rank=0,
                         backend="nccl")


# ---------------- the driver's device lists ----------------


def _driver_files(tmp_path):
    panel = make_panel(seed=21)
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=70, seed=4)
    ref, csv = write_panel_files(panel, str(tmp_path))
    r1, r2 = write_fastq_files(pairs, str(tmp_path))
    return ref, csv, r1, r2


def _run(tmp_path, tag, files, paired, **kw):
    from genefuserust_tpu_torch import driver

    ref, csv, r1, r2 = files
    html, js = tmp_path / f"{tag}.html", tmp_path / f"{tag}.json"
    eng = driver.scan(driver.RunConfig(r1_file=r1, r2_file=r2 if paired else "",
                                       fusion_file=csv, html=str(html), json=str(js),
                                       ref_file=ref, device="cpu",
                                       settings=PortSettings(), **kw), "devices-test")
    return eng, (_TS.sub("<ts>", html.read_text()), _TS.sub("<ts>", js.read_text()))


@pytest.mark.parametrize("paired", [True, False])
def test_driver_device_list_gives_the_one_device_reports(tmp_path, monkeypatch, paired):
    """RunConfig.devices = ["cpu"] * 3: a TorchEngine of three entries,
    each given batches, with reports equal to the one-device run's
    (`--mesh auto` on the CPU). Batches of 16 pairs, so batch k goes to
    entry k mod 3."""
    from genefuserust_tpu_torch import driver
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    make_engine = driver.make_engine

    def small_batches(*args, **kw):
        eng = make_engine(*args, **kw)
        eng.batch_size = 16
        return eng

    monkeypatch.setattr(driver, "make_engine", small_batches)
    files = _driver_files(tmp_path)
    one_eng, one = _run(tmp_path, "one", files, paired)
    eng, three = _run(tmp_path, "three", files, paired, devices=["cpu"] * 3)
    assert isinstance(eng, TorchEngine) and len(eng.devices) == 3
    n = one_eng.entry_batches[0]
    assert n >= 4 and eng.entry_batches == [len(range(k, n, 3)) for k in range(3)]
    assert three == one
    assert '"fusions"' in one[1]
