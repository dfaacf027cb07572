"""``steps_per_execution`` on the port against the JAX package, on the CPU.

The narrow NeRF-W of tests/test_torch_lockstep.py (depth 4, width 32, 8 + 8
samples, N_vocab 8, f32, perturb 0, noise 0), Adam at lr 5e-4, from the
same weights in both packages (``bridge.from_jax_params``):
  * ``stack_batches`` equals JAX's, with ``k`` equal to and larger than
    the number of batches;
  * a K = 4 call with 3 valid sub-steps, host-fed (``make_train_step``) and
    from the device pool (``make_device_pool_step``, ``n_steps`` 3), against
    JAX's scanned K-step: the metrics of the valid sub-steps within rtol
    2e-3 / atol 2e-5 and the parameters within max 2e-3 / mean 1e-4 a leaf,
    the limits of the lockstep test;
  * the port's K-step against K of its own K = 1 calls: bit for bit,
    parameters and Adam state, so the masked tail touched nothing;
  * the same with BARF and trained pose deltas on camera-frame rays: the
    epoch reaches the K-step as a tensor filled before each call, so two
    calls at epochs 0.75 and 1.25 equal 7 single steps at those epochs bit
    for bit, the deltas held through the pose warmup;
  * the transmittance's cumprod, whose backward the port writes so that a
    CUDA graph can capture it: bit for bit torch.cumprod's values and
    gradients, and JAX's gradient within rtol 1e-5, with and without
    opaque samples (zeros in the product).
On the CPU the K-step runs its sub-steps eagerly; the CUDA graph of the
same sub-step is held to that on the card (tests/test_torch_cuda.py).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.training import optimizers as jopt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch.bridge import from_jax_params, to_numpy_tree
from nerf_fl_torch.render import RenderConfig
from nerf_fl_torch.training import optimizers, system

LR = 5e-4
B, K, N_VALID = 64, 4, 3
KW = dict(N_samples=8, N_importance=8, encode_a=True, encode_t=True,
          white_back=True, perturb=0.0, noise_std=0.0, beta_min=0.1,
          mlp_depth=4, mlp_width=32)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32)], 1)
    return {"rays": rays, "ts": rng.integers(0, 8, n).astype(np.int32),
            "rgbs": (0.5 + 0.4 * d).astype(np.float32)}


def _batches(n=N_VALID, seed=1):
    data = _data(n * B, seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()}
            for i in range(n)]


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port(jp=None, microbatch=1, steps=1, pool=False):
    """Params, optimizer and step of the port, from JAX's weights ``jp``
    (JAX's build_params at key 0 if None)."""
    cfg = RenderConfig(**KW)
    if jp is None:
        jp = jsys.build_params(jax.random.PRNGKey(0), JRenderConfig(**KW), 8)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg)
    opt = optimizers.build_optimizer(
        types.SimpleNamespace(optimizer="adam", lr=LR, weight_decay=0.0),
        optimizers.trainable_parameters(
            params, optimizers.make_trainable_mask(params, False)))
    if pool:
        step = system.make_device_pool_step(cfg, opt, batch_size=B,
                                            microbatch=microbatch,
                                            steps_per_execution=steps)
    else:
        step = system.make_train_step(cfg, opt, microbatch=microbatch,
                                      steps_per_execution=steps)
    return params, opt, step


@pytest.mark.parametrize("k", [N_VALID, K])
def test_stack_batches_matches_jax(k):
    batches = _batches()
    jst, jvalid = jsys.stack_batches(batches, k)
    st, valid = system.stack_batches([_torch(b) for b in batches], k)
    assert isinstance(valid, np.ndarray) and valid.dtype == bool
    np.testing.assert_array_equal(valid, jvalid)
    assert set(st) == set(jst)
    for name, v in st.items():
        assert v.shape[0] == k
        np.testing.assert_array_equal(v.numpy(), jst[name])


@pytest.mark.parametrize("pool", [False, True], ids=["host_fed", "pool"])
def test_k_step_matches_jax(pool):
    """K = 4 with the last sub-step masked, against JAX's scanned step."""
    jcfg = JRenderConfig(use_pallas=False, **KW)
    jp = jsys.build_params(jax.random.PRNGKey(0), jcfg, 8)
    h = types.SimpleNamespace(optimizer="adam", lr=LR, weight_decay=0.0)
    tx = jopt.build_optimizer(h)
    mask = jopt.make_trainable_mask(jp, False)
    params, _, step = _port(jp, steps=K, pool=pool)
    lr, ep = jnp.float32(LR), jnp.float32(0.0)
    if pool:
        data = _data(N_VALID * B, 2)
        perm = system.epoch_perm(5, 0, N_VALID * B, K * B)
        jstep = jsys.make_device_pool_step(jcfg, tx, mask, batch_size=B,
                                           donate=False,
                                           steps_per_execution=K)
        jp, _, jm = jstep(jp, tx.init(jp),
                          {k: jnp.asarray(v) for k, v in data.items()},
                          jnp.asarray(perm), jnp.int32(0), jnp.uint32(0),
                          jnp.int32(N_VALID), lr, ep, jax.random.PRNGKey(3))
        tm = step(params, _torch(data), torch.from_numpy(perm), 0, N_VALID,
                  LR)
    else:
        stacked, valid = jsys.stack_batches(_batches(), K)
        jstep = jsys.make_train_step(jcfg, tx, mask, donate=False,
                                     steps_per_execution=K)
        jp, _, jm = jstep(jp, tx.init(jp),
                          {k: jnp.asarray(v) for k, v in stacked.items()},
                          lr, ep, jax.random.split(jax.random.PRNGKey(3), K),
                          jnp.asarray(valid))
        tm = step(params, _torch(stacked), LR, valid=valid)
    assert set(tm) == set(jm)
    ours = np.array([tm[k].numpy() for k in sorted(jm)])
    theirs = np.array([np.asarray(jm[k]) for k in sorted(jm)])
    assert ours.shape == theirs.shape == (len(jm), K)
    assert np.isnan(ours[:, N_VALID:]).all()
    np.testing.assert_allclose(ours[:, :N_VALID], theirs[:, :N_VALID],
                               rtol=2e-3, atol=2e-5)
    diffs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - b), jp, to_numpy_tree(params)))
    assert max(float(d.max()) for d in diffs) <= 2e-3
    assert max(float(d.mean()) for d in diffs) <= 1e-4


def _adam_state(opt):
    return [{k: v.clone() if torch.is_tensor(v) else v
             for k, v in opt.state[p].items()}
            for g in opt.param_groups for p in g["params"]]


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("pool", [False, True], ids=["host_fed", "pool"])
def test_k_step_equals_k_single_steps_bit_for_bit(pool, microbatch):
    """Two K = 4 calls, the second with its last sub-step masked (7 steps),
    against 7 calls of the K = 1 step: the same parameters, Adam state and
    metrics bit for bit, so the masked sub-step took no step."""
    runs = []
    for steps in (1, K):
        params, opt, step = _port(microbatch=microbatch, steps=steps,
                                  pool=pool)
        data = _data(2 * K * B, 4)
        metrics = []
        if pool:
            perm = torch.from_numpy(system.epoch_perm(1, 0, 2 * K * B,
                                                      2 * K * B))
            pool_t = _torch(data)
            if steps == 1:
                metrics = [step(params, pool_t, perm, i, LR)
                           for i in range(2 * K - 1)]
            else:
                for i0 in (0, K):
                    m = step(params, pool_t, perm, i0, 2 * K - 1, LR)
                    metrics += [{k: v[j] for k, v in m.items()}
                                for j in range(min(K, 2 * K - 1 - i0))]
        else:
            batches = [_torch({k: v[i * B:(i + 1) * B]
                               for k, v in data.items()})
                       for i in range(2 * K - 1)]
            if steps == 1:
                metrics = [step(params, b, LR) for b in batches]
            else:
                for group in (batches[:K], batches[K:]):
                    st, valid = system.stack_batches(group, K)
                    m = step(params, st, LR, valid=valid)
                    metrics += [{k: v[j] for k, v in m.items()}
                                for j in range(len(group))]
        runs.append((to_numpy_tree(params), _adam_state(opt),
                     [{k: float(v) for k, v in m.items()} for m in metrics]))
    (p1, s1, m1), (pk, sk, mk) = runs
    jax.tree_util.tree_map(np.testing.assert_array_equal, p1, pk)
    assert len(s1) == len(sk)
    for a, b in zip(s1, sk):
        assert set(a) == set(b)
        for name in a:
            assert torch.equal(torch.as_tensor(a[name]),
                               torch.as_tensor(b[name])), name
    assert m1 == mk
    assert int(s1[0]["step"]) == 2 * K - 1


@pytest.mark.parametrize("valid", [[False, True, True, True],
                                   [True, False, True, True],
                                   [False] * K, [True] * (K - 1)])
def test_k_step_refuses_a_valid_that_is_no_prefix(valid):
    params, _, step = _port(steps=K)
    stacked, _ = system.stack_batches([_torch(b) for b in _batches()], K)
    with pytest.raises(ValueError, match="prefix"):
        step(params, stacked, LR, valid=np.array(valid))


def test_set_lr_fills_a_device_lr_in_place():
    """A capturable optimizer's lr is a tensor that a graph reads: set_lr
    writes into it and keeps it; a float lr is replaced."""
    p = torch.nn.Parameter(torch.zeros(3))
    lr = torch.tensor(1e-3)
    opt = torch.optim.Adam([p], lr=lr, foreach=False)
    optimizers.set_lr(opt, 2.5e-4)
    assert opt.param_groups[0]["lr"] is lr and float(lr) == np.float32(2.5e-4)
    opt = torch.optim.Adam([p], lr=1e-3)
    optimizers.set_lr(opt, 2.5e-4)
    assert opt.param_groups[0]["lr"] == 2.5e-4


def _transmittance_case(zeros, dtype, seed=0):
    """alphas (64, 33) in (0, 0.95) with a share ``zeros`` of them exactly
    1 (an opaque sample: 1 - alpha = 0), and an upstream gradient."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 0.95, (64, 33))
    a[rng.uniform(size=a.shape) < zeros] = 1.0
    return a.astype(dtype), rng.normal(0, 1, a.shape).astype(dtype)


@pytest.mark.parametrize("zeros", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_transmittance_backward_equals_torch_cumprod(zeros, dtype):
    """The transmittance's cumprod has its own backward, which reads
    nothing back to the host so that a CUDA graph can capture the train
    step: values and gradients bit for bit torch.cumprod's, zeros in the
    product included."""
    from nerf_fl_torch.core import compositing
    a, g = _transmittance_case(zeros, dtype)
    a1 = torch.from_numpy(a).requires_grad_()
    a2 = torch.from_numpy(a).requires_grad_()
    t1 = compositing.exclusive_transmittance(a1)
    shifted = torch.cat([torch.ones_like(a2[:, :1]), 1.0 - a2[:, :-1]], -1)
    t2 = torch.cumprod(shifted, dim=-1)
    assert torch.equal(t1, t2)
    t1.backward(torch.from_numpy(g))
    t2.backward(torch.from_numpy(g))
    assert torch.equal(a1.grad, a2.grad)


@pytest.mark.parametrize("zeros", [0.0, 0.2])
def test_transmittance_gradient_matches_jax(zeros):
    from nerf_fl_tpu.core import compositing as jcomp
    from nerf_fl_torch.core import compositing
    a, g = _transmittance_case(zeros, np.float32, seed=1)
    jg = jax.grad(lambda x: jnp.sum(jnp.asarray(g)
                                    * jcomp.exclusive_transmittance(x)))(
        jnp.asarray(a))
    t = torch.from_numpy(a).requires_grad_()
    compositing.exclusive_transmittance(t).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


def _barf_port(steps, pool):
    """The narrow NeRF-W with BARF (paper schedule over epochs 0-2) on
    camera-frame rays of 4 cameras, the pose deltas trained in their own
    group at lr x 0.5 after a warmup of 1 epoch."""
    from nerf_fl_torch.models.poses import perturb_poses
    cfg = RenderConfig(refine_pose=True, barf_schedule="paper",
                       barf_epoch_start=0, barf_epoch_end=2, **KW)
    init = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    init[:, :3, 3] = [[4, 0, 1], [0, 4, 1], [-4, 0, 1], [0, -4, 1]]
    params = system.build_params(
        cfg, 8, generator=torch.Generator().manual_seed(0), device="cpu",
        init_poses=perturb_poses(init, 3.0, 0.02, seed=2))
    mask = optimizers.make_trainable_mask(params, True)
    for name, p in optimizers.named_leaves(params):
        p.requires_grad_(mask[name])
    opt = optimizers.build_optimizer(
        types.SimpleNamespace(optimizer="adam", lr=LR),
        optimizers.param_groups(params, mask))
    kw = dict(steps_per_execution=steps, ray_format="camdir",
              pose_lr_mult=0.5, pose_warmup_epochs=1.0)
    if pool:
        step = system.make_device_pool_step(cfg, opt, batch_size=B, **kw)
    else:
        step = system.make_train_step(cfg, opt, **kw)
    return params, opt, step


def _camdir(n, seed):
    rng = np.random.default_rng(seed)
    d = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)), -np.ones((n, 1))],
                       1).astype(np.float32)
    return {"rays": np.concatenate([d, np.full((n, 1), 2, np.float32),
                                    np.full((n, 1), 6, np.float32)], 1),
            "ts": rng.integers(0, 4, n).astype(np.int32),
            "rgbs": rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)}


@pytest.mark.parametrize("pool", [False, True], ids=["host_fed", "pool"])
def test_k_step_barf_equals_k_single_steps_bit_for_bit(pool):
    """BARF and the pose warmup read the epoch, which reaches the K-step as
    a tensor filled before each call (the one a CUDA graph reads; every
    sub-step of a call shares it).  Two K = 4 calls at epochs 0.75 and
    1.25 (the second with its last sub-step masked) against 7 single steps
    at those epochs: parameters, Adam state and metrics bit for bit; the
    pose deltas still through the first call and moved by the second."""
    runs = []
    for steps in (1, K):
        params, opt, step = _barf_port(steps, pool)
        data = _camdir(2 * K * B, 6)
        epochs = [0.75] * K + [1.25] * (K - 1)
        deltas, metrics = [], []
        if pool:
            perm = torch.from_numpy(system.epoch_perm(1, 0, 2 * K * B,
                                                      2 * K * B))
            pool_t = _torch(data)
            if steps == 1:
                for i in range(2 * K - 1):
                    metrics.append(step(params, pool_t, perm, i, LR,
                                        epochs[i]))
                    deltas.append(params["learn_poses"].r.detach().clone())
            else:
                for i0 in (0, K):
                    m = step(params, pool_t, perm, i0, 2 * K - 1, LR,
                             epochs[i0])
                    metrics += [{k: v[j] for k, v in m.items()}
                                for j in range(min(K, 2 * K - 1 - i0))]
                    deltas.append(params["learn_poses"].r.detach().clone())
        else:
            batches = [_torch({k: v[i * B:(i + 1) * B]
                               for k, v in data.items()})
                       for i in range(2 * K - 1)]
            if steps == 1:
                for b, e in zip(batches, epochs):
                    metrics.append(step(params, b, LR, e))
                    deltas.append(params["learn_poses"].r.detach().clone())
            else:
                for i0, group in ((0, batches[:K]), (K, batches[K:])):
                    st, valid = system.stack_batches(group, K)
                    m = step(params, st, LR, epochs[i0], valid=valid)
                    metrics += [{k: v[j] for k, v in m.items()}
                                for j in range(len(group))]
                    deltas.append(params["learn_poses"].r.detach().clone())
        runs.append((to_numpy_tree(params), _adam_state(opt),
                     [{k: float(v) for k, v in m.items()} for m in metrics],
                     deltas))
    (p1, s1, m1, d1), (pk, sk, mk, dk) = runs
    jax.tree_util.tree_map(np.testing.assert_array_equal, p1, pk)
    assert len(s1) == len(sk)
    for a, b in zip(s1, sk):
        assert set(a) == set(b)
        for name in a:
            assert torch.equal(torch.as_tensor(a[name]),
                               torch.as_tensor(b[name])), name
    assert m1 == mk
    assert not d1[K - 1].any() and not dk[0].any()
    assert torch.equal(d1[-1], dk[-1]) and dk[-1].abs().max() > 0
