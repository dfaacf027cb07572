"""Nothing under benchmark/ imports JAX, optax, flax or the JAX package,
and nothing under benchmark/reference/ imports the program: each import's
top-level module name is compared whole (the port's name begins with the
JAX package's)."""
import ast
from pathlib import Path

import pytest

from benchmark import spec

JAX = {"jax", "jaxlib", "optax", "flax", "nerf_fl_tpu"}
FILES = sorted(spec.HERE.rglob("*.py"))


def imported(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not set(imported(path)) & JAX


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").rglob("*.py"):
        names = set(imported(path))
        assert "nerf_fl_torch" not in names and "benchmark" not in names, \
            path


def test_names_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import nerf_fl_torch.ops\nfrom nerf_fl_tpu import x\n")
    assert set(imported(p)) == {"nerf_fl_torch", "nerf_fl_tpu"}
    assert not {"nerf_fl_torch"} & JAX
