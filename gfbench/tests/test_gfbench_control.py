"""The control: the reference with its gene positions held in 16 bits in
the program's place comes out as not correct, on each number compared; the
reference in its own place comes out equal. At a size a test run holds; on
the card's machine it runs at the cells' size (python3 -m gfbench.control)."""

import pytest

from gfbench.control import control_numbers


@pytest.fixture
def wide(small):
    """Genes of 100,000 bases, so that positions pass 16 bits, as the
    cells' genes of 111,029 do."""
    small["config"]["panel_bp"] = 3_000_000
    return small


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 3_000_000_019])
def test_control_is_not_correct(seed, wide):
    out = control_numbers("cancer15-pe-targeted", seed, wide)
    assert all(v == 0 for v in out["reference_vs_itself"].values())
    assert out["control_correct"] is False
    assert all(v > 0 for v in out["control"].values()), out["control"]


def test_control_is_not_correct_over_sixteen_panels(wide):
    out = control_numbers("multicsv16-pe-targeted", 12, wide)
    assert all(v == 0 for v in out["reference_vs_itself"].values())
    assert out["control_correct"] is False
    assert all(v > 0 for v in out["control"].values()), out["control"]
