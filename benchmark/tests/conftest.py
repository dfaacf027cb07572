"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
checkout's root (or from this directory).  Tests that need a card carry
the `cuda` marker and decide inside the test whether one is present."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
