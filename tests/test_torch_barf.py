"""BARF pose refinement on the port against the JAX package, on the CPU.

  * the pose-noise harness (``perturb_poses``, ``gauge_transform``,
    ``pose_errors``) equals JAX's copy: the noisy poses bit for bit, the
    gauge and the errors within 1e-12 (the same float64 numpy);
  * lockstep train steps with pose refinement on camera-frame rays (the
    narrow NeRF-W of tests/test_torch_lockstep.py, four cameras, BARF's
    paper schedule annealing over epochs 0-2, ``pose_lr_mult`` 0.25 and a
    warmup of one epoch that the steps cross at step 4): for adam, radam
    and ranger the pose deltas are exactly zero through the warmup in both
    packages and then move as JAX's do, within 1e-2 of their largest
    update plus 1e-8 (an Adam step's sign near a zero gradient); the
    metrics within the lockstep test's rtol 2e-3 / atol 2e-5 and the
    parameters within its max 2e-3 / mean 1e-4 a leaf;
  * the pose gradients at full width through the fused path (the port's
    autograd Function with its plain forward and backward, JAX's Pallas
    kernel in interpret mode), with BARF's annealed scale rows: the
    ``learn_poses.r`` / ``.t`` gradients within 2e-3 of their norm, the
    f32 gradient limit of the coarse net's ill-conditioning (ROADMAP C).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fl_tpu.models import poses as jposes
from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.render import render_rays as jrender
from nerf_fl_tpu.training import losses as jlosses
from nerf_fl_tpu.training import optimizers as jopt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch.bridge import (from_jax_params, grads_to_numpy_tree,
                                  to_numpy_tree)
from nerf_fl_torch.models import poses
from nerf_fl_torch.render import RenderConfig, render_rays
from nerf_fl_torch.training import losses, optimizers, system

LR = 5e-4
N_CAMS = 4
BARF = dict(refine_pose=True, barf_schedule="paper", barf_epoch_start=0,
            barf_epoch_end=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _look_at(i, n, radius=4.0):
    """A camera on a circle about z, looking at the origin (c2w 4 x 4)."""
    a = 2 * np.pi * i / n
    c = np.array([radius * np.cos(a), radius * np.sin(a), 1.0])
    z = c / np.linalg.norm(c)                      # backward axis
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    m = np.eye(4)
    m[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    m[:3, 3] = c
    return m


def _true_poses(n, dtype=np.float32):
    return np.stack([_look_at(i, n) for i in range(n)]).astype(dtype)


@pytest.mark.parametrize("rot,trans,seed", [(2.0, 0.02, 0), (5.0, 0.0, 3),
                                            (0.0, 0.05, 7)])
def test_pose_noise_harness_matches_jax(rot, trans, seed):
    true = _true_poses(12)
    noisy = poses.perturb_poses(true, rot, trans, seed=seed)
    assert noisy.dtype == np.float32
    np.testing.assert_array_equal(
        noisy, jposes.perturb_poses(true, rot, trans, seed=seed))
    np.testing.assert_allclose(poses.gauge_transform(noisy, true),
                               jposes.gauge_transform(noisy, true),
                               atol=1e-12)
    for align in (True, False):
        np.testing.assert_allclose(
            poses.pose_errors(noisy, true, align=align),
            jposes.pose_errors(noisy, true, align=align), atol=1e-12)


def test_gauge_transform_inverts_a_rigid_motion_as_jax_does():
    true = _true_poses(10, np.float64)
    th = 0.3
    G = np.array([[np.cos(th), -np.sin(th), 0, 0.2],
                  [np.sin(th), np.cos(th), 0, -0.1],
                  [0, 0, 1, 0.05], [0, 0, 0, 1.0]])
    moved = np.einsum("ij,njk->nik", G, true)
    T = poses.gauge_transform(moved, true)
    np.testing.assert_allclose(T @ G, np.eye(4), atol=1e-10)
    np.testing.assert_allclose(T, jposes.gauge_transform(moved, true),
                               atol=1e-12)
    r, t = poses.pose_errors(moved, true)
    assert r < 1e-6 and t < 1e-8


def _camdir_data(n, seed=0):
    """Camera-frame rays (dir, near, far) of N_CAMS cameras, ids and
    colours."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)),
                        -np.ones((n, 1))], 1).astype(np.float32)
    rays = np.concatenate([d, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32)], 1)
    ts = rng.integers(0, N_CAMS, n).astype(np.int32)
    rgbs = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return {"rays": rays, "ts": ts, "rgbs": rgbs}


def _noisy_init():
    return poses.perturb_poses(_true_poses(N_CAMS), 3.0, 0.02, seed=1)


def _kw(narrow):
    kw = dict(N_samples=8, N_importance=8, encode_a=True, encode_t=True,
              white_back=True, perturb=0.0, noise_std=0.0, beta_min=0.1,
              **BARF)
    if narrow:
        kw.update(mlp_depth=4, mlp_width=32)
    return kw


def _port_state(jp, tcfg, name, **step_kw):
    """The port's params from JAX's ``jp``, the deltas trainable in their
    own optimizer group, and its camdir train step."""
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    mask = optimizers.make_trainable_mask(tp, True)
    for leaf, p in optimizers.named_leaves(tp):
        p.requires_grad_(mask[leaf])
    h = types.SimpleNamespace(optimizer=name, lr=LR, weight_decay=0.0)
    opt = optimizers.build_optimizer(h, optimizers.param_groups(tp, mask))
    return tp, opt, system.make_train_step(tcfg, opt, ray_format="camdir",
                                           **step_kw)


@pytest.mark.parametrize("name", ["adam", "radam", "ranger"])
def test_pose_refinement_lockstep_matches_jax(name):
    """8 steps at epochs 0.5, 0.625, ..., 1.375 (BARF's continuous
    schedule), warmup 1 epoch, pose lr x 0.25."""
    jcfg, tcfg = JRenderConfig(**_kw(True)), RenderConfig(**_kw(True))
    jp = jsys.build_params(jax.random.PRNGKey(0), jcfg, 8,
                           init_poses=_noisy_init())
    h = types.SimpleNamespace(optimizer=name, lr=LR, weight_decay=0.0)
    tx = jopt.build_optimizer(h)
    step_kw = dict(pose_lr_mult=0.25, pose_warmup_epochs=1.0)
    jstep = jsys.make_train_step(jcfg, tx, jopt.make_trainable_mask(jp, True),
                                 donate=False, ray_format="camdir", **step_kw)
    opt_state = tx.init(jp)
    tp, _, tstep = _port_state(jp, tcfg, name, **step_kw)
    data = _camdir_data(8 * 128, seed=2)
    ours, theirs, deltas = [], [], []
    for i in range(8):
        epoch = 0.5 + i / 8
        b = {k: v[i * 128:(i + 1) * 128] for k, v in data.items()}
        jp, opt_state, jm = jstep(jp, opt_state,
                                  {k: jnp.asarray(v) for k, v in b.items()},
                                  jnp.float32(LR), jnp.float32(epoch),
                                  jax.random.PRNGKey(i))
        tm = tstep(tp, {k: _t(v) for k, v in b.items()}, LR, epoch=epoch)
        theirs.append([float(jm[k]) for k in sorted(jm)])
        ours.append([float(tm[k]) for k in sorted(jm)])
        jd = {k: np.asarray(jp["learn_poses"][k]) for k in ("r", "t")}
        td = {k: getattr(tp["learn_poses"], k).detach().numpy().copy()
              for k in ("r", "t")}
        deltas.append((epoch, jd, td))
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-5)
    for epoch, jd, td in deltas:
        for k in ("r", "t"):
            if epoch < 1.0:         # the warmup: exactly still in both
                assert not jd[k].any() and not td[k].any(), (epoch, k)
            else:
                assert np.abs(jd[k]).max() > 0
                np.testing.assert_allclose(
                    td[k], jd[k], rtol=0,
                    atol=1e-2 * np.abs(jd[k]).max() + 1e-8)
    got = to_numpy_tree(tp)
    diffs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - b), jp, got))
    assert max(float(d.max()) for d in diffs) <= 2e-3
    assert max(float(d.mean()) for d in diffs) <= 1e-4


@pytest.mark.parametrize("epoch", [0.7, 1.5])
def test_pose_gradients_through_the_fused_path_match_jax(epoch):
    """Full width, 16 camera-frame rays x (8 + 8) samples, f32, BARF's
    scale rows at ``epoch`` (part of the bands annealed in)."""
    kw = _kw(False)
    jcfg = JRenderConfig(use_pallas=True, **kw)
    tcfg = RenderConfig(use_fused=True, **kw)
    jp = jsys.build_params(jax.random.PRNGKey(0), jcfg, 8,
                           init_poses=_noisy_init())
    jp["learn_poses"] = {**jp["learn_poses"], **{
        k: jnp.asarray(np.random.default_rng(4 + j).normal(
            0, 0.01, (N_CAMS, 3)), jnp.float32)
        for j, k in enumerate(("r", "t"))}}
    b = _camdir_data(16, seed=5)

    def loss_j(p):
        rays = jsys.assemble_world_rays(p, jnp.asarray(b["rays"]),
                                        jnp.asarray(b["ts"]),
                                        ray_format="camdir")
        res = jrender(p, rays, jnp.asarray(b["ts"]), None, jcfg,
                      epoch=jnp.float32(epoch))
        return sum(jlosses.nerfw_loss(res, jnp.asarray(b["rgbs"])).values())

    jg = jax.grad(loss_j)(jp)["learn_poses"]
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    rays = system.assemble_world_rays(tp, _t(b["rays"]), _t(b["ts"]),
                                      ray_format="camdir")
    res = render_rays(tp, rays, _t(b["ts"]), tcfg, epoch=epoch)
    sum(losses.nerfw_loss(res, _t(b["rgbs"])).values()).backward()
    tg = grads_to_numpy_tree(tp)["learn_poses"]
    for k in ("r", "t"):
        a = np.asarray(jg[k])
        assert np.linalg.norm(a) > 0 and np.isfinite(tg[k]).all()
        assert np.linalg.norm(tg[k] - a) <= 2e-3 * np.linalg.norm(a), k
