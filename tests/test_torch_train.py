"""The port's training modules against the JAX package, on the CPU:
losses, the lr schedule, the sgd/adam updates, the batch order, the
softplus gradient, the trainable mask and the build hash.  Lockstep
training is in tests/test_torch_lockstep.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fl_tpu.training import losses as jlosses
from nerf_fl_tpu.training import optimizers as jopt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch.data import RayBatcher
from nerf_fl_torch.render import RenderConfig
from nerf_fl_torch.training import losses, optimizers, system


def _t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------------
# losses, schedules, optimizers, batch order
# ----------------------------------------------------------------------

def _results(rng, n=64, fine=True, beta=True):
    r = {"rgb_coarse": rng.uniform(0, 1, (n, 3))}
    if fine:
        r["rgb_fine"] = rng.uniform(0, 1, (n, 3))
    if beta:
        r["beta"] = rng.uniform(0.1, 2.0, n)
        r["transient_sigmas"] = rng.uniform(0, 3, (n, 16))
    return {k: v.astype(np.float32) for k, v in r.items()}


@pytest.mark.parametrize("case", [(True, True), (True, False),
                                  (False, False)])
@pytest.mark.parametrize("name", ["nerfw", "color"])
def test_losses_match_jax(name, case):
    rng = np.random.default_rng(0)
    res = _results(rng, fine=case[0], beta=case[1])
    target = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    ref = jlosses.loss_dict[name]({k: jnp.asarray(v) for k, v in res.items()},
                                  jnp.asarray(target), coef=0.7)
    got = losses.loss_dict[name]({k: _t(v) for k, v in res.items()},
                                 _t(target), coef=0.7)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("sched", ["steplr", "cosine", "poly"])
def test_lr_for_epoch_matches_jax(sched, warmup):
    h = types.SimpleNamespace(lr=5e-4, optimizer="adam", lr_scheduler=sched,
                              warmup_epochs=warmup, warmup_multiplier=2.0,
                              decay_step=[3, 6], decay_gamma=0.5,
                              num_epochs=10, poly_exp=0.9)
    for e in range(12):
        assert optimizers.lr_for_epoch(h, e) == jopt.lr_for_epoch(h, e)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_updates_match_jax(name):
    h = types.SimpleNamespace(optimizer=name, lr=1e-2, momentum=0.9,
                              weight_decay=1e-3)
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
            "b": rng.normal(0, 1, 4).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jopt.build_optimizer(h)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in tree.items()}
    opt = optimizers.build_optimizer(h, tp.values())
    for step in range(4):
        lr = 1e-2 / (step + 1)
        g = {k: rng.normal(0, 1, v.shape).astype(np.float32)
             for k, v in tree.items()}
        deltas, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  state, jp, lr)
        jp = jax.tree_util.tree_map(lambda p, d: p + d, jp, deltas)
        optimizers.set_lr(opt, lr)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
    for k in tree:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_unported_optimizers_raise():
    """sgd, radam and ranger are ported (tests/test_torch_optimizers.py
    holds them to optax, tests/test_torch_checkpoints.py their resume from
    a JAX opt_state); an optimizer that the port does not build (torch's
    own SGD, AdamW) cannot take a JAX opt_state."""
    from nerf_fl_torch.training import checkpoints
    p = torch.nn.Parameter(torch.zeros(2))
    for name, cls in (("sgd", optimizers.SGD), ("radam", optimizers.RAdam),
                      ("ranger", optimizers.Ranger)):
        opt = optimizers.build_optimizer(
            types.SimpleNamespace(optimizer=name, lr=1.0), [p])
        assert isinstance(opt, cls)
    for opt in (torch.optim.SGD([p], lr=1.0), torch.optim.AdamW([p])):
        with pytest.raises(NotImplementedError, match="not ported"):
            checkpoints.opt_state_from_jax({}, opt, {"p": p})


def test_batch_order_matches_jax():
    from nerf_fl_tpu.data import RayBatcher as JBatcher
    n = 103
    rays = np.arange(n * 8, dtype=np.float32).reshape(n, 8)
    ts = np.arange(n, dtype=np.int32)
    rgbs = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    for kw in (dict(batch_size=16, seed=3),
               dict(batch_size=16, seed=3, drop_last=False),
               dict(batch_size=16, seed=5, host_index=1, host_count=2)):
        ours, ref = RayBatcher(rays, ts, rgbs, **kw), JBatcher(rays, ts, rgbs,
                                                               **kw)
        assert ours.steps_per_epoch() == ref.steps_per_epoch()
        for e in (0, 1):
            got, want = list(ours.epoch(e)), list(ref.epoch(e))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])
    for args in [(0, 0, 100, 64), (7, 3, 100, 250), (1, 0, 50, 50)]:
        np.testing.assert_array_equal(system.epoch_perm(*args),
                                      jsys.epoch_perm(*args))
        assert system.epoch_perm(*args).dtype == np.int32


def test_softplus_gradient_matches_jax():
    """sigmoid(x) everywhere, 0.5 at +-0 as jax.grad(jax.nn.softplus);
    autograd of the forward formula alone gives 1 at 0."""
    from nerf_fl_torch.models.mlp import softplus
    xs = np.array([0.0, -0.0, 1e-3, -1e-3, -30.0, 4.0], np.float32)
    ref = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(jnp.asarray(xs)))
    x = torch.tensor(xs, requires_grad=True)
    softplus(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-6, atol=0)
    assert x.grad[0] == 0.5 and x.grad[1] == 0.5
    # the formula's own autograd, which the port used before, is off at 0
    x0 = torch.zeros(1, requires_grad=True)
    (torch.clamp(x0, min=0) + torch.log1p(torch.exp(-torch.abs(x0)))
     ).sum().backward()
    assert float(x0.grad) == 1.0 != float(ref[0])


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    from nerf_fl_torch.ops import _build
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.CSRC.iterdir():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    before = {n: _build._target(n) for n in _build.sources()}
    assert set(before) == {"fused_mlp_fwd", "fused_mlp_bwd", "anatomy_chain",
                           "anatomy_net", "anatomy_pe", "stage_marks"}
    hdr = src / "fused_mlp_common.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)
    (src / "fused_mlp_bwd.cu").write_text(
        (src / "fused_mlp_bwd.cu").read_text() + "\n")
    assert _build._target("fused_mlp_bwd") != after["fused_mlp_bwd"]
    assert _build._target("fused_mlp_fwd") == after["fused_mlp_fwd"]


def test_trainable_mask_and_parameters():
    cfg = RenderConfig(N_samples=4, N_importance=4, mlp_depth=4,
                       mlp_width=32, encode_a=True, encode_t=True)
    params = system.build_params(cfg, 5, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    mask = optimizers.make_trainable_mask(params, refine_pose=False)
    assert all(mask.values())
    leaves = optimizers.trainable_parameters(params, mask)
    assert len(leaves) == len(mask)
    assert all(p.requires_grad and p.is_leaf for p in leaves)
    assert isinstance(params["embedding_a"], torch.nn.Parameter)
    fake = {n: torch.zeros(1) for n in ("learn_poses.init_c2w",
                                        "learn_poses.r", "nerf_coarse.x")}
    assert optimizers.make_trainable_mask(fake, True) == {
        "learn_poses.init_c2w": False, "learn_poses.r": True,
        "nerf_coarse.x": True}
    assert optimizers.make_trainable_mask(fake, False)["learn_poses.r"] \
        is False


def test_microbatch_must_divide_batch():
    cfg = RenderConfig(N_samples=4, N_importance=0, mlp_depth=4,
                       mlp_width=32, use_fused=False)
    params = system.build_params(cfg, 5, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    leaves = optimizers.trainable_parameters(
        params, optimizers.make_trainable_mask(params, False))
    before = [p.detach().clone() for p in leaves]
    opt = optimizers.build_optimizer(
        types.SimpleNamespace(optimizer="adam", lr=1e-3, weight_decay=0.0),
        leaves)
    step = system.make_train_step(cfg, opt, loss_name="color", microbatch=3)
    rays = torch.cat([torch.zeros(4, 3), torch.tensor([[0.0, 0.0, 1.0]] * 4),
                      torch.full((4, 1), 2.0), torch.full((4, 1), 6.0)], 1)
    batch = {"rays": rays, "ts": torch.zeros(4, dtype=torch.int64),
             "rgbs": torch.full((4, 3), 0.5)}
    with pytest.raises(ValueError, match="microbatch"):
        step(params, batch, 1e-3)
    assert all(torch.equal(p, q) for p, q in zip(leaves, before))
