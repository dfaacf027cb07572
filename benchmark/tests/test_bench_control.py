"""On the card: the control, the program in bfloat16 (the precision below
the configurations' float32), fails the check of every cell at a size a
test holds, and the program as configured passes it.  Run with
`python -m pytest benchmark/tests -m cuda`; the full-size readings come
from `benchmark/calibrate.py`."""
import pytest

from tiny import run_tiny

CELLS = ["nerfw_lego.train", "barf_brandenburg.train", "nerfw_lego.render"]


def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    dev = card()
    ok, _ = run_tiny(cell, device=dev)
    assert ok["correct"], ok["checks"]
    bad, _ = run_tiny(cell, device=dev, compute_dtype="bfloat16")
    assert not bad["correct"], bad["checks"]
