"""The rest of a run, past the harness's look for a card, with the timed
path broken underneath: `correct` has to come out false for each fault the
cells can have. The cells run on one card, so an exchange between chips
is not among them."""

import time

import pytest
import torch

from gfbench.cell import run_cell


def _run(small, cell="cancer15-pe-targeted"):
    return run_cell(cell, 2**31 + 41, 0.1, False, time.perf_counter(), device="cpu",
                    sizes=small, say=lambda o: None)


def _no_survivors(monkeypatch):
    """A step that returns its state unchanged: the scan finds nothing."""
    from genefuserust_tpu_torch.parallel import engine

    def scan(bufs, lens, exc, index, *, widths, cap, **kw):
        return (torch.zeros((cap + 1, 13), dtype=torch.int32, device=exc.device),
                torch.zeros(-(-lens.shape[0] // 32), dtype=torch.int32, device=exc.device))

    monkeypatch.setattr(engine, "fused_scan_lanes", scan)


def _half_batch(monkeypatch):
    """Half of each batch left out: the engine scans its first half."""
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    orig = TorchEngine._scan_pair_matrices

    def half(self, mappers, b1, q1, l1, b2, q2, l2, pair_obj):
        h = len(l1) // 2
        return orig(self, mappers, b1[:h], q1[:h], l1[:h], b2[:h], q2[:h], l2[:h], pair_obj)

    monkeypatch.setattr(TorchEngine, "_scan_pair_matrices", half)


def _distance_altered(monkeypatch):
    """An answer altered where it is produced: every edit distance that
    assembly computes comes out one higher."""
    from genefuserust_tpu_torch.parallel.ed_batch import EdBatcher

    orig = EdBatcher.submit

    def submit(self, query, ref, setter):
        return orig(self, query, ref, lambda v: setter(v + 1))

    monkeypatch.setattr(EdBatcher, "submit", submit)


def _break_altered(monkeypatch):
    """An answer altered where it is produced: each match's break moves
    one base."""
    from genefuserust_tpu_torch.core.mapper import FusionMapper

    orig = FusionMapper.make_match

    def make_match(self, r, mapping, ed_batcher=None):
        m = orig(self, r, mapping, ed_batcher=ed_batcher)
        if m is not None:
            m.read_break += 1
        return m

    monkeypatch.setattr(FusionMapper, "make_match", make_match)


@pytest.mark.parametrize("fault,number", [
    (_no_survivors, "pairs_differing"),
    (_half_batch, "pairs_differing"),
    (_distance_altered, "pairs_differing"),
    (_break_altered, "pairs_differing"),
])
def test_a_broken_timed_path_is_not_correct(fault, number, small, monkeypatch):
    fault(monkeypatch)
    out = _run(small)
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_a_fault_in_one_panel_of_many_is_not_correct(small, monkeypatch):
    _half_batch(monkeypatch)
    out = _run(small, "multicsv16-pe-targeted")
    assert out["correct"] is False
