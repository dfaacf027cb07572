"""RAdam and Ranger of the port against the JAX package's optax chains.

Both start from the same parameters (a narrow NeRF-W tree, depth 2 width
32, with its appearance and transient tables, carried from JAX through the
bridge) and take the same gradients, drawn with numpy seed 0 in the JAX
layout, for 20 steps.  Steps 1-5 are un-rectified (rho_t < 5), step 6 is
the first rectified one and Ranger's lookahead syncs at steps 6, 12 and 18.
After each step every leaf agrees within f32 max |x - y| <= 1e-6 (1 + |y|).
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
