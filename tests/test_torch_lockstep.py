"""Lockstep training of the port against the JAX package, on the CPU.

Both packages start from the same weights and train on the same batches
(f32, perturb 0, noise 0, white background, NeRF-W with N_vocab 8):
  (a) narrow width (depth 4, width 32), plain MLP path, 20 Adam steps;
  (b) full width through the fused path, 16 rays x (8 + 8) samples: JAX's
      Pallas kernel in interpret mode, the port's autograd Function with
      its plain forward and backward, 5 steps;
  (c) microbatch 2, 3 steps;
  (d) the NeRF-A arm of the quality gate (appearance without the
      transient head) as (a).
Metrics per step (loss, psnr, every loss term): rtol 2e-3, atol 2e-5, as
tests/test_training_parity.py.  Parameters after the last step: max 2e-3
(four steps of lr 5e-4) and mean 1e-4 per leaf.  Adam divides each update
by the root of its second moment, so a gradient that is near zero and
differs in sign between the two packages moves its weight by up to 2 lr
per step; the coarse net's first layers are ill-conditioned (a float64 run
of the port agrees with its f32 run to 1e-5 there, the JAX package's f32
to 2e-3).
"""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.render import render_rays as jrender
from nerf_fl_tpu.training import losses as jlosses
from nerf_fl_tpu.training import optimizers as jopt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch.bridge import (from_jax_params, grads_to_numpy_tree,
                                  to_numpy_tree)
from nerf_fl_torch.data import RayBatcher
from nerf_fl_torch.render import RenderConfig, render_rays
from nerf_fl_torch.training import losses, optimizers, system

LR = 5e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _data(n_pool=2048, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 1, (n_pool, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_pool, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n_pool, 1), 2, np.float32),
                           np.full((n_pool, 1), 6, np.float32)], 1)
    ts = rng.integers(0, 8, n_pool).astype(np.int32)
    return rays, ts, (0.5 + 0.4 * d).astype(np.float32)


def _configs(narrow, dtype="float32", encode_t=True):
    kw = dict(N_samples=8, N_importance=8, encode_a=True, encode_t=encode_t,
              white_back=True, perturb=0.0, noise_std=0.0, beta_min=0.1,
              compute_dtype=dtype)
    if narrow:
        kw.update(mlp_depth=4, mlp_width=32)
    return (JRenderConfig(use_pallas=not narrow, **kw),
            RenderConfig(use_fused=not narrow, **kw))


def _lockstep(narrow, steps, batch, microbatch=1, encode_t=True):
    jcfg, tcfg = _configs(narrow, encode_t=encode_t)
    jp = jsys.build_params(jax.random.PRNGKey(0), jcfg, 8)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    h = types.SimpleNamespace(optimizer="adam", lr=LR, weight_decay=0.0)
    tx = jopt.build_optimizer(h)
    jstep = jsys.make_train_step(jcfg, tx, jopt.make_trainable_mask(jp, False),
                                 donate=False, microbatch=microbatch)
    opt_state = tx.init(jp)
    opt = optimizers.build_optimizer(h, optimizers.trainable_parameters(
        tp, optimizers.make_trainable_mask(tp, False)))
    tstep = system.make_train_step(tcfg, opt, microbatch=microbatch)
    rays, ts, rgbs = _data()
    batcher = RayBatcher(rays, ts, rgbs, batch, seed=7)
    batches = itertools.chain.from_iterable(batcher.epoch(e) for e in
                                            itertools.count())
    ours, theirs = [], []
    for i in range(steps):
        b = next(batches)
        jp, opt_state, jm = jstep(jp, opt_state,
                                  {k: jnp.asarray(v) for k, v in b.items()},
                                  jnp.float32(LR), jnp.float32(0.0),
                                  jax.random.PRNGKey(i))
        tm = tstep(tp, {k: _t(v) for k, v in b.items()}, LR)
        assert set(tm) == set(jm)
        theirs.append([float(jm[k]) for k in sorted(jm)])
        ours.append([float(tm[k]) for k in sorted(jm)])
    ours, theirs = np.array(ours), np.array(theirs)
    # every metric (loss, psnr, each term) tracks; psnr in dB is absolute
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-5)
    got = to_numpy_tree(tp)
    diffs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - b), jp, got))
    assert max(float(d.max()) for d in diffs) <= 2e-3
    assert max(float(d.mean()) for d in diffs) <= 1e-4
    return ours


def test_lockstep_narrow_plain():
    _lockstep(True, 20, 128)


def test_lockstep_full_width_fused():
    _lockstep(False, 5, 16)


def test_lockstep_microbatch():
    _lockstep(True, 3, 128, microbatch=2)


def test_lockstep_nerfa_arm():
    """The quality gate's NeRF-A arm (appearance, no transient head),
    narrow, 20 steps."""
    _lockstep(True, 20, 128, encode_t=False)


def test_bf16_full_width_gradients():
    """One bf16 step through the fused path, gradients leaf for leaf:
    norm-relative 0.1 per leaf and 2e-2 over all leaves together.  Both
    packages round every activation and cotangent to bf16 at the same
    points, but XLA's bf16 dot transposes also round the weight grads,
    which the port keeps in f32, and the coarse sigma path is
    ill-conditioned (2e-3 apart already in f32)."""
    jcfg, tcfg = _configs(False, "bfloat16")
    jp = jsys.build_params(jax.random.PRNGKey(0), jcfg, 8)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    rays, ts, rgbs = (x[:16] for x in _data())

    def loss_j(p):
        res = jrender(p, jnp.asarray(rays), jnp.asarray(ts), None, jcfg)
        return sum(jlosses.nerfw_loss(res, jnp.asarray(rgbs)).values())

    jg = jax.grad(loss_j)(jp)
    res = render_rays(tp, _t(rays), _t(ts), tcfg)
    sum(losses.nerfw_loss(res, _t(rgbs)).values()).backward()
    tg = grads_to_numpy_tree(tp)
    pairs = [(np.asarray(a, np.float32), b) for a, b in zip(
        jax.tree_util.tree_leaves(jg), jax.tree_util.tree_leaves(tg))]
    for a, b in pairs:
        assert a.shape == b.shape and np.isfinite(b).all()
        assert np.linalg.norm(a - b) <= 0.1 * np.linalg.norm(a)
    num = sum(float(np.sum((a - b) ** 2)) for a, b in pairs)
    den = sum(float(np.sum(a ** 2)) for a, _ in pairs)
    assert (num / den) ** 0.5 <= 2e-2


def test_device_pool_step_matches_host_fed():
    """The pool step gathers perm[i*B:(i+1)*B] and trains exactly as the
    host-fed step on RayBatcher's batches (the same permutation)."""
    _, tcfg = _configs(True)
    rays, ts, rgbs = _data(n_pool=256)
    runs = []
    for pool in (True, False):
        params = system.build_params(tcfg, 8, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
        opt = optimizers.build_optimizer(
            types.SimpleNamespace(optimizer="adam", lr=LR),
            optimizers.trainable_parameters(
                params, optimizers.make_trainable_mask(params, False)))
        losses_ = []
        if pool:
            run = system.make_device_pool_step(tcfg, opt, batch_size=64)
            data = {"rays": _t(rays), "ts": _t(ts), "rgbs": _t(rgbs)}
            perm = _t(system.epoch_perm(3, 0, 256, 256))
            for i in range(4):
                losses_.append(float(run(params, data, perm, i,
                                         LR)["train/loss"]))
        else:
            step = system.make_train_step(tcfg, opt)
            for b in RayBatcher(rays, ts, rgbs, 64, seed=3).epoch(0):
                losses_.append(float(step(params, {k: _t(v) for k, v in
                                                   b.items()},
                                          LR)["train/loss"]))
        runs.append((losses_, to_numpy_tree(params)))
    assert runs[0][0] == runs[1][0]
    jax.tree_util.tree_map(np.testing.assert_array_equal, runs[0][1],
                           runs[1][1])
