"""The port's entry() (genefuserust_tpu_torch/entry.py) against the JAX
package's `__graft_entry__.py::entry`: the same panel, batch and table
layout, and map_read's outputs equal bit for bit."""

import numpy as np
import pytest
import torch


def test_entry_matches_jax_entry():
    import jax

    import __graft_entry__ as jax_entry
    from genefuserust_tpu_torch.entry import entry

    jfn, jargs = jax_entry.entry()
    exp = jax.jit(jfn)(*jargs)
    fn, args = entry("cpu")
    assert [tuple(a.shape) for a in args] == [(64, 128), (64,)]
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    got = fn(*args)
    for g, e in zip(got, exp):
        assert np.array_equal(g.numpy(), np.asarray(e))
    assert got.seg_valid.all(1).sum() > 0


def test_entry_cli_runs_on_the_cpu(capsys):
    from genefuserust_tpu_torch.entry import main

    assert main(["--device", "cpu"]) == 0
    assert "entry: ok" in capsys.readouterr().out


@pytest.mark.cuda
def test_entry_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from genefuserust_tpu_torch.entry import entry

    fn, args = entry("cuda")
    cfn, cargs = entry("cpu")
    for g, e in zip(fn(*args), cfn(*cargs)):
        assert torch.equal(g.cpu(), e)


def test_dryrun_multichip_on_three_cpu_entries(capsys):
    """The four multi-device paths on 3 entries of the CPU (PE, SE, the
    sharded index on 3 shards, multi-CSV through the driver), each equal to
    its one-device or host twin."""
    from genefuserust_tpu_torch.entry import device_list, dryrun_multichip

    assert device_list(3, "cpu") == [torch.device("cpu")] * 3
    dryrun_multichip(3, device="cpu")
    assert "dryrun_multichip(3): ok" in capsys.readouterr().out


def test_dryrun_multichip_switch(capsys):
    from genefuserust_tpu_torch.entry import main

    assert main(["--device", "cpu", "--dryrun-multichip", "2"]) == 0
    assert "dryrun_multichip(2): ok - 4 paths on [cpu, cpu]" in capsys.readouterr().out


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from genefuserust_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out
