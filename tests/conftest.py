"""Test harness config: force the CPU backend with 8 virtual devices so
multi-chip sharding paths run without TPU hardware (the JAX-native analog of
multi-GPU simulation; SURVEY.md section 4)."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tests.fixtures import make_blender_scene  # noqa: E402

# ----------------------------------------------------------------------
# test tiers: `pytest -m "not slow"` is the <5-minute smoke tier; the
# full suite (~20-30 min: e2e CLI runs, 2-process multihost jobs, bitwise
# reproducibility double-runs) stays the default.  Slow tests are marked
# centrally here so the tier lives in one place.
# ----------------------------------------------------------------------

SLOW_MODULES = {
    "test_end_to_end",       # full train/eval CLI round trips
    "test_multihost",        # spawns 2-process jax.distributed jobs
    "test_reproducibility",  # trains twice per test for bitwise checks
    "test_graft_entry",      # subprocess dryruns with fresh JAX startups
    "test_barf_recovery",    # three training arms for the BARF protocol
}

SLOW_TESTS = {
    # >=10 s each on an idle machine (pytest --durations), mostly compiles
    "test_loss_decreases",
    "test_steps_per_execution_matches_sequential",
    "test_device_pool_step_matches_host_fed",
    "test_device_pool_dp_sharded",
    "test_multidevice_dp_matches_single_device",
    "test_model_parallel_matches_single_device",
    "test_adam_training_trajectories_match",
    "test_refine_pose_updates_poses",
    "test_frozen_poses_stay_frozen_and_used",
    "test_render_chunked_a_override_matches_direct",
    "test_fused_grads_match_xla",
    "test_bench_smoke_emits_json",  # subprocess bench run, ~3 min CPU
    "test_scale_stress_machinery",  # cache build + train window + val
    "test_quality_gate_smoke_preset",  # 7 train arms + 8 evals, ~5 min
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running e2e/multihost/parity tests "
        "(deselect with -m 'not slow' for a <5-min smoke)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one; "
        "run on the card with pytest --noconftest -m cuda "
        "tests/test_torch_cuda.py)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        base = item.name.split("[", 1)[0]
        if mod in SLOW_MODULES or base in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def blender_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("lego_mini")
    make_blender_scene(str(root), n_train=4, n_val=2, n_test=2, size=40)
    return str(root)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
