"""The reference against the port's plain path at a tiny size on the CPU,
through the harness itself: one train cell's first sub-steps (NeRF-W on
the Blender layout, and with BARF pose refinement on the Phototourism
layout) and rendered frames.  On the CPU the program runs its plain
versions in float32, the same arithmetic as the reference in another
order, so the gaps are rounding."""
import pytest

from tiny import run_tiny

CELLS = ["nerfw_lego.train", "barf_brandenburg.train", "nerfw_lego.render"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_plain_path(cell):
    result, checks = run_tiny(cell)
    numbers = {n: v for n, v, _ in checks}
    assert result["failed"] == 0 and result["attempted"] > 0
    for name, value in numbers.items():
        assert value < 2e-5, (name, value, result["detail"])
    assert result["correct"], result["checks"]


def test_same_seed_same_numbers():
    a, _ = run_tiny("nerfw_lego.train", seed=5)
    b, _ = run_tiny("nerfw_lego.train", seed=5)
    c, _ = run_tiny("nerfw_lego.train", seed=6)
    assert a["detail"]["loss_program"] == b["detail"]["loss_program"]
    assert a["detail"]["loss_program"] != c["detail"]["loss_program"]
