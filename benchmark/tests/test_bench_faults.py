"""The check fails a run whose timed path is broken underneath: the harness
runs as the benchmark runs it, past the look for a card, at a tiny size on
the CPU, with one fault planted in the program's path each time, and
`correct` has to come out false.  Faults: a step that leaves the state
unchanged, half of each batch left out (the mean taken over the rest), an
answer altered where it is produced.  (No cell spans chips, so there is no
exchange to leave out.)"""
import pytest

from tiny import run_tiny

FAULTS = [("nerfw_lego.train", "frozen"), ("nerfw_lego.train", "half_batch"),
          ("barf_brandenburg.train", "frozen"),
          ("barf_brandenburg.train", "half_batch"),
          ("nerfw_lego.render", "alter")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault):
    result, checks = run_tiny(cell, fault=fault)
    assert not result["correct"], result["checks"]
    assert any(v > lim for _, v, lim in checks)
