"""Fixtures of the benchmark's own tests (run them with
`python -m pytest gfbench/tests -q` from the checkout's root)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# small sizes of both cells that a CPU run holds: 30 genes of 12 kb (the
# planted fusions' genes stay), 4,096 pairs in batches of 1,024
SMALL = {"config": {"genes": 30, "panel_bp": 360_000, "batch_pairs": 1024},
         "traffic": {"pairs_per_sample": 4096, "chimera": 0.01}}


@pytest.fixture
def small():
    return {k: dict(v) for k, v in SMALL.items()}


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present (decided here, at
    run time, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
