"""Test-time appearance optimization on the port against the JAX package,
on the CPU.

``optimize_appearance`` fits one appearance vector with the weights frozen
(NeRF-W's eval protocol): 5 Adam steps at lr 0.1 on 64 rays of a NeRF-W
(8 + 8 samples, N_vocab 8, f32, the JAX package's weights), narrow through
the plain MLP path and at full width through the fused path (the port's
autograd Function with its plain forward and backward, JAX's Pallas kernel
in interpret mode).  The loss curve within rtol 1e-4 and the fitted vector
within 1e-4 of its largest entry: both run the same Adam on gradients that
agree to f32 roundoff.  The weights stay as they were and get no
gradient; ``RenderConfig.eval_variant`` is JAX's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.render.appearance import \
    optimize_appearance as joptimize_appearance
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch.bridge import from_jax_params, to_numpy_tree
from nerf_fl_torch.render import RenderConfig
from nerf_fl_torch.render.appearance import optimize_appearance


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32)], 1)
    rgbs = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    return rays, np.full(n, 5, np.int32), rgbs


@pytest.mark.parametrize("narrow", [True, False], ids=["plain", "fused"])
def test_optimize_appearance_matches_jax(narrow):
    kw = dict(N_samples=8, N_importance=8, encode_a=True, encode_t=True,
              white_back=True, perturb=1.0, noise_std=1.0, beta_min=0.1)
    if narrow:
        kw.update(mlp_depth=4, mlp_width=32)
    jcfg = JRenderConfig(use_pallas=not narrow, **kw)
    tcfg = RenderConfig(use_fused=not narrow, **kw)
    jp = jsys.build_params(jax.random.PRNGKey(0), jcfg, 8)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    before = to_numpy_tree(tp)
    rays, ts, rgbs = _rays(64)
    ja, jl = joptimize_appearance(jp, rays, ts, rgbs, jcfg, steps=5, lr=0.1)
    ta, tl = optimize_appearance(tp, rays, ts, rgbs, tcfg, steps=5, lr=0.1)
    assert ta.shape == (48,) and tl.shape == (5,)
    assert ta.dtype == tl.dtype == torch.float32
    ja, jl = np.asarray(ja), np.asarray(jl)
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0,
                               atol=1e-4 * np.abs(ja).max())
    row = np.asarray(jp["embedding_a"])[5]
    assert np.abs(ja - row).max() > 0.1         # the fit moved it
    jax.tree_util.tree_map(np.testing.assert_array_equal, before,
                           to_numpy_tree(tp))
    assert all(p.grad is None for m in tp.values()
               for p in (m.parameters() if isinstance(m, torch.nn.Module)
                         else [m]))


def test_optimize_appearance_with_no_steps_keeps_the_row():
    cfg = RenderConfig(N_samples=4, N_importance=4, encode_a=True,
                       mlp_depth=2, mlp_width=16)
    jp = jsys.build_params(jax.random.PRNGKey(1),
                           JRenderConfig(N_samples=4, N_importance=4,
                                         encode_a=True, mlp_depth=2,
                                         mlp_width=16), 8)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg)
    rays, ts, rgbs = _rays(16, 2)
    a, losses = optimize_appearance(tp, rays, ts, rgbs, cfg, steps=0)
    np.testing.assert_array_equal(a.numpy(), np.asarray(jp["embedding_a"])[5])
    assert losses.shape == (0,)


def test_eval_variant_matches_jax():
    kw = dict(N_samples=16, perturb=1.0, noise_std=0.5, refine_pose=True,
              barf_schedule="paper")
    want = dataclasses.asdict(JRenderConfig(**kw).eval_variant())
    got = dataclasses.asdict(RenderConfig(**kw).eval_variant())
    assert got["perturb"] == got["noise_std"] == 0.0
    for k, v in got.items():
        if k in want:
            assert want[k] == v, k
    assert RenderConfig(**kw).perturb == 1.0          # a copy, not a change
