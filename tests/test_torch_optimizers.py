"""SGD, RAdam and Ranger of the port against the JAX package's optax chains.

Both packages start from the same parameters (a narrow NeRF-W tree,
depth 2 width 32, with its appearance and transient tables, carried from
JAX through the bridge) and take the same gradients, drawn with numpy seed
0 in the JAX layout: RAdam and Ranger for 20 steps (steps 1-5 are
un-rectified, rho_t < 5, step 6 is the first rectified one and Ranger's
lookahead syncs at steps 6, 12 and 18), SGD for 12 with and without weight
decay and momentum, its lr a tensor set once every K steps.  After each
step every leaf agrees within f32 max |x - y| <= 1e-6 (1 + |y|).  SGD's
K-step train step equals K single steps bit for bit.
"""
import io
import types

import jax
import numpy as np
import optax
import pytest
import torch

from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.training import optimizers as jopt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch.bridge import from_jax_params, to_numpy_tree
from nerf_fl_torch.render import RenderConfig
from nerf_fl_torch.training import optimizers

STEPS = 20
KW = dict(N_samples=4, N_importance=4, encode_a=True, encode_t=True,
          mlp_depth=2, mlp_width=32)


def _rho(t, b2=0.999):
    t = np.float32(t)
    b2t = np.float32(b2) ** t
    return np.float32(2 / (1 - b2) - 1) - np.float32(2) * t * b2t / (1 - b2t)


def _set_grads(tp, gtree, cfg):
    mods = from_jax_params(gtree, cfg)
    for (_, p), (_, g) in zip(optimizers.named_leaves(tp),
                              optimizers.named_leaves(mods)):
        p.grad = g.detach().clone()


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_optimizer_matches_optax_in_lockstep(name, wd):
    cfg = RenderConfig(**KW)
    jp = jax.tree_util.tree_map(
        np.asarray, jsys.build_params(jax.random.PRNGKey(0),
                                      JRenderConfig(**KW), 6))
    tp = from_jax_params(jp, cfg)
    h = types.SimpleNamespace(optimizer=name, lr=1e-2, weight_decay=wd)
    tx = jopt.build_optimizer(h)
    state = tx.init(jp)
    opt = optimizers.build_optimizer(h, optimizers.trainable_parameters(
        tp, optimizers.make_trainable_mask(tp, False)))
    assert isinstance(opt, optimizers.Ranger if name == "ranger"
                      else optimizers.RAdam)
    rng = np.random.default_rng(0)
    for t in range(1, STEPS + 1):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(0, 1, x.shape).astype(np.float32), jp)
        deltas, state = tx.update(grads, state, jp, np.float32(h.lr))
        jp = jax.tree_util.tree_map(np.asarray,
                                    optax.apply_updates(jp, deltas))
        _set_grads(tp, grads, cfg)
        optimizers.set_lr(opt, h.lr)
        opt.step()
        for x, y in zip(_leaves(to_numpy_tree(tp)), _leaves(jp)):
            err = np.abs(x - y) / (1 + np.abs(y))
            assert err.max() <= 1e-6, (t, float(err.max()))
    # the run crossed both branches and, for ranger, three syncs
    rect = [_rho(t) >= 5 for t in range(1, STEPS + 1)]
    assert rect.index(True) == 5 and not any(rect[:5])
    st = next(iter(opt.state.values()))
    assert float(st["step"]) == STEPS


def test_ranger_centralises_over_fan_in_and_tables():
    """A grad that is constant along each row's fan-in (and along each
    table row) is centralised to zero: no update but weight decay's."""
    w = torch.nn.Parameter(torch.ones(4, 3))
    table = torch.nn.Parameter(torch.ones(5, 2))
    bias = torch.nn.Parameter(torch.ones(4))
    opt = optimizers.Ranger([w, table, bias], lr=0.1)
    w.grad = torch.arange(4.0)[:, None].expand(4, 3).clone()
    table.grad = torch.arange(5.0)[:, None].expand(5, 2).clone()
    bias.grad = torch.ones(4)
    opt.step()
    assert torch.equal(w.detach(), torch.ones(4, 3))
    assert torch.equal(table.detach(), torch.ones(5, 2))
    assert not torch.equal(bias.detach(), torch.ones(4))


@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_optimizer_state_round_trips(name):
    """state_dict / load_state_dict, through torch.save, carry the step,
    the moments and the slow weights: a reloaded optimizer's next step
    equals the original's."""
    torch.manual_seed(0)
    h = types.SimpleNamespace(optimizer=name, lr=1e-2, weight_decay=0.0)
    ps = [torch.nn.Parameter(torch.randn(3, 4)), torch.nn.Parameter(
        torch.randn(4))]
    opt = optimizers.build_optimizer(h, ps)
    for _ in range(7):
        for p in ps:
            p.grad = torch.randn_like(p)
        opt.step()
    qs = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    opt2 = optimizers.build_optimizer(h, qs)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    opt2.load_state_dict(torch.load(buf))
    for p, q in zip(ps, qs):
        p.grad = torch.randn_like(p)
        q.grad = p.grad.clone()
    opt.step()
    opt2.step()
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)


SGD_STEPS = 12


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_sgd_matches_optax_in_lockstep(wd, momentum, k):
    """The port's SGD against the JAX package's sgd chain (decay added to
    the gradient, optax.trace, -lr) on the narrow NeRF-W tree: the lr a
    0-d tensor written by set_lr once every k steps, as a K-step call
    writes it on the card (k = 1: every step), its value changing between
    calls; every leaf within f32 max |x - y| <= 1e-6 (1 + |y|) after each
    of 12 steps."""
    cfg = RenderConfig(**KW)
    jp = jax.tree_util.tree_map(
        np.asarray, jsys.build_params(jax.random.PRNGKey(0),
                                      JRenderConfig(**KW), 6))
    tp = from_jax_params(jp, cfg)
    h = types.SimpleNamespace(optimizer="sgd", lr=1e-2, weight_decay=wd,
                              momentum=momentum)
    tx = jopt.build_optimizer(h)
    state = tx.init(jp)
    opt = optimizers.build_optimizer(h, optimizers.trainable_parameters(
        tp, optimizers.make_trainable_mask(tp, False)))
    assert isinstance(opt, optimizers.SGD)
    for g in opt.param_groups:
        g["lr"] = torch.tensor(h.lr)             # the card's device lr
    rng = np.random.default_rng(0)
    for t in range(SGD_STEPS):
        lr = np.float32(h.lr / (1 + t // k))
        if t % k == 0:
            optimizers.set_lr(opt, float(lr))
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(0, 1, x.shape).astype(np.float32), jp)
        deltas, state = tx.update(grads, state, jp, lr)
        jp = jax.tree_util.tree_map(np.asarray,
                                    optax.apply_updates(jp, deltas))
        _set_grads(tp, grads, cfg)
        opt.step()
        for x, y in zip(_leaves(to_numpy_tree(tp)), _leaves(jp)):
            err = np.abs(x - y) / (1 + np.abs(y))
            assert err.max() <= 1e-6, (t, float(err.max()))
    assert bool(opt.state) == (momentum > 0)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_k_step_equals_single_steps(momentum):
    """``make_train_step`` with sgd and steps_per_execution 4 (the sub-steps
    run eagerly on the CPU, the step a CUDA graph on the card) trains as 4
    single steps, bit for bit: the parameters, the momentum buffers and the
    metrics."""
    from nerf_fl_torch.training import system
    cfg = RenderConfig(white_back=True, perturb=0.0, noise_std=0.0, **KW)
    h = types.SimpleNamespace(optimizer="sgd", lr=1e-2, weight_decay=1e-4,
                              momentum=momentum)
    rng = np.random.default_rng(2)
    n, b = 4, 32
    d = rng.normal(0, 1, (n * b, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 1, (n * b, 3)), d,
                           np.full((n * b, 1), 2.0),
                           np.full((n * b, 1), 6.0)], 1)
    data = {"rays": torch.tensor(rays, dtype=torch.float32),
            "ts": torch.tensor(rng.integers(0, 6, n * b)),
            "rgbs": torch.tensor(0.5 + 0.4 * d, dtype=torch.float32)}
    batches = [{k: v[i * b:(i + 1) * b] for k, v in data.items()}
               for i in range(n)]
    runs = []
    for k in (1, n):
        params = system.build_params(
            cfg, 6, generator=torch.Generator().manual_seed(0), device="cpu")
        opt = optimizers.build_optimizer(h, optimizers.trainable_parameters(
            params, optimizers.make_trainable_mask(params, False)))
        step = system.make_train_step(cfg, opt, steps_per_execution=k)
        if k == 1:
            losses = [step(params, bt, h.lr)["train/loss"] for bt in batches]
        else:
            st, valid = system.stack_batches(batches, k)
            losses = list(step(params, st, h.lr, valid=valid)["train/loss"])
        runs.append(([p.detach().clone()
                      for _, p in optimizers.named_leaves(params)],
                     [v.get("momentum_buffer") for v in opt.state.values()],
                     torch.stack([torch.as_tensor(x).reshape(())
                                  for x in losses])))
    (p1, m1, l1), (pk, mk, lk) = runs
    assert torch.equal(l1, lk)
    assert all(torch.equal(a, b) for a, b in zip(p1, pk))
    assert len(m1) == len(mk) == (len(p1) if momentum else 0)
    assert all(torch.equal(a, b) for a, b in zip(m1, mk))
