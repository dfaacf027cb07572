"""The tensor-parallel K-step (``steps_per_execution`` under a model axis)
and the sub-step cut at its collectives (``parallel.mesh.Pieces``), on
the CPU.

On the card ``_StepGraph`` captures a mesh's sub-step as one CUDA graph a
piece between two collectives and replays the collectives between the
pieces; on the CPU the same sub-step runs eagerly and records the same
plan (the collectives in order), which these tests read.  Ranks are
processes of a gloo job (``parallel.launch.spawn``, one thread each): 2
ranks for model 2, 4 for data 2 x model 2.  NeRF-W 8 + 8 samples at depth
8 (the skip at layer 4) and width 32, N_vocab 8, batch 64, Adam at 5e-4;
K = 4 over 7 steps, so the second call's last sub-step is masked.

  * model 2 and data 2 x model 2, perturb 1 and noise 1: the K-step equals
    the same ranks' 7 single steps bit for bit (parameters, Adam state and
    metrics, so the masked sub-step took no step); every rank records the
    same plan, 24 cuts a sub-step (the 6 collectives of each field's
    forward, 5 and 6 in the coarse and the fine backward, the data
    all-reduce); the parameters within 2e-5 of one rank's K-step (the
    limit of tests/test_train_system.py for a change of layout alone) and
    the metrics within rel 1e-5;
  * model 2 against JAX's scanned K-step under a model axis (perturb 0,
    noise 0; data 4 x model 2 over the 8 virtual CPU devices): the metrics
    at tests/test_torch_steps.py's limits for the K-step against JAX (rtol
    2e-3, atol 2e-5) and the parameters at the lockstep limits (max 2e-3,
    mean 1e-4 a leaf): one Adam step of the port's single-rank path is
    already up to 6.4e-4 from JAX's here, so the 2e-5 between two layouts
    holds within the port (above), not across the packages;
  * model 2 at bf16, the flagship's dtype, against one rank's bf16 K-step
    (``BF16_*`` below, the limits chip_smoke.py's phase 13 (d) holds the
    card's run to);
  * ``render_chunked`` under model 2 against one rank's (``RENDER_ATOL``);
  * ``Comm``'s collectives under a CPU ``Pieces`` record: the same results
    as without one, in place, each named in the plan.
"""
import types

import numpy as np
import pytest
import torch

from nerf_fl_torch.bridge import from_jax_params, to_numpy_tree
from nerf_fl_torch.render import RenderConfig

JOB_TIMEOUT = 180
LR = 5e-4
N_VOCAB = 8
B, K, N_STEPS = 64, 4, 7
MODEL = dict(N_samples=8, N_importance=8, encode_a=True, encode_t=True,
             white_back=True, beta_min=0.1, mlp_depth=8, mlp_width=32)
# the cuts of one sub-step of the model above under model 2: per field 4
# row-parallel all-reduces (xyz.1/3/5/7) and 2 all-gathers (xyz_final,
# dir) forward; backward an all-reduce of the input gradient of each
# column-parallel layer whose input needs one: xyz.2, xyz.4 (its hidden
# input, not the encoded xyz), xyz.6, xyz_final, dir's per-sample input
# and, in the fine field only, dir's per-ray appearance input; then the
# data all-reduce of the gradients
CUTS = {"model.all_reduce": 4 + 4 + 5 + 6, "model.all_gather": 4,
        "data.all_reduce": 1}
# bf16 model 2 against one rank: a row-parallel layer rounds each rank's
# partial product to bf16 before the f32 sum where one rank rounds the whole
# sum, so a hidden value lands up to a bf16 ulp (2^-8 relative) apart.  The
# losses, means over the batch, hold that to rel 1e-4 (read: 1.2e-6).
# Adam moves a weight whose gradient sits near its eps by up to lr a step
# either way when the gradients' signs differ there, so each leaf is held
# to N_STEPS lr at most and lr / 2 on average (read: 3.7 lr and 0.2 lr)
BF16_LOSS_RTOL, BF16_MEAN, BF16_MAX = 1e-4, LR / 2, N_STEPS * LR
RENDER_ATOL = 1e-5            # f32: the row-parallel sums in another order


def _data(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32)], 1)
    return {"rays": rays,
            "ts": rng.integers(0, N_VOCAB, n).astype(np.int32),
            "rgbs": rng.uniform(0, 1, (n, 3)).astype(np.float32)}


def _jax_tree(seed=0):
    import jax
    from nerf_fl_tpu.render import RenderConfig as JRenderConfig
    from nerf_fl_tpu.training import system as jsys
    jp = jsys.build_params(jax.random.PRNGKey(seed),
                           JRenderConfig(use_pallas=False, **MODEL), N_VOCAB)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _port(tree, cfg, device="cpu"):
    from nerf_fl_torch.training import optimizers
    params = from_jax_params(tree, cfg, device=device)
    opt = optimizers.build_optimizer(
        types.SimpleNamespace(optimizer="adam", lr=LR, weight_decay=0.0),
        optimizers.trainable_parameters(
            params, optimizers.make_trainable_mask(params, False)))
    return params, opt


def _state(opt):
    return [{k: v.detach().clone() for k, v in opt.state[p].items()}
            for g in opt.param_groups for p in g["params"]]


def _steps(params, opt, cfg, pool, perm, steps, seed, mesh=None):
    """``N_STEPS`` steps from the device pool, one a call (``steps`` 1) or
    K a call: (params as a numpy tree, Adam state, the steps' metrics, the
    K-step's plan), the params and state whole under a model axis."""
    from nerf_fl_torch.parallel.mesh import whole_params
    from nerf_fl_torch.training import make_device_pool_step
    run = make_device_pool_step(cfg, opt, batch_size=B,
                                steps_per_execution=steps, mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    pool = {k: torch.from_numpy(np.array(v)) for k, v in pool.items()}
    perm = torch.from_numpy(perm)
    metrics = []
    if steps == 1:
        for i in range(N_STEPS):
            m = run(params, pool, perm, i, LR, generator=gen)
            metrics.append({k: float(v) for k, v in m.items()})
    else:
        for i0 in range(0, N_STEPS, steps):
            m = run(params, pool, perm, i0, N_STEPS, LR, generator=gen)
            n = min(steps, N_STEPS - i0)
            assert all(bool(v[n:].isnan().all())
                       and not bool(v[:n].isnan().any()) for v in m.values())
            metrics += [{k: float(v[j]) for k, v in m.items()}
                        for j in range(n)]
    tp = mesh is not None and mesh.num_model > 1
    with whole_params(mesh, params, opt, tp):
        tree, state = to_numpy_tree(params), _state(opt)
    plan = None if steps == 1 or mesh is None else run.graph.pieces.plan
    return tree, state, metrics, plan


def _rank_k_step(device, tree, cfg, pool, perm, num_data, num_model, seed):
    """The same ranks' 7 single steps and K-step from the same weights."""
    from nerf_fl_torch.parallel import make_mesh, multihost, place_params
    mesh = make_mesh(num_data, num_model,
                     devices=multihost.job_devices(device))
    out = {}
    for steps in (1, K):
        params, opt = _port(tree, cfg)
        place_params(mesh, params, num_model > 1, opt)
        out[steps] = _steps(params, opt, cfg, pool, perm, steps, seed, mesh)
    return out


def _spawn(fn, *args, ranks=2):
    from nerf_fl_torch.parallel import launch
    return launch.spawn(fn, args, devices=["cpu"] * ranks,
                        timeout=JOB_TIMEOUT)


def _leaves(tree):
    import jax
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _equal(a, b):
    import jax
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


def _pool(seed=4):
    from nerf_fl_torch.training import epoch_perm
    return _data(N_STEPS * B, seed), epoch_perm(1, 0, N_STEPS * B, 2 * K * B)


@pytest.mark.parametrize("num_data,num_model", [(1, 2), (2, 2)])
def test_tp_k_step_equals_single_steps_and_one_rank(num_data, num_model):
    _, tree = _jax_tree()
    pool, perm = _pool()
    cfg = RenderConfig(perturb=1.0, noise_std=1.0, **MODEL)
    res = _spawn(_rank_k_step, tree, cfg, pool, perm, num_data, num_model,
                 3, ranks=num_data * num_model)
    params, opt = _port(tree, cfg)
    one, _, one_m, _ = _steps(params, opt, cfg, pool, perm, K, 3)
    for r in res:
        (p1, s1, m1, _), (pk, sk, mk, plan) = r[1], r[K]
        _equal(p1, pk)
        assert len(s1) == len(sk)
        for a, b in zip(s1, sk):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[n], b[n]) for n in a)
        assert m1 == mk and int(sk[0]["step"]) == N_STEPS
        assert plan == res[0][K][3]
        kinds = {}
        for name in plan:
            kind = name.split("(")[0]
            kinds[kind] = kinds.get(kind, 0) + 1
        assert kinds == CUTS, kinds
        for path, x in _leaves(pk):
            y = dict((p, v) for p, v in _leaves(one))[path]
            np.testing.assert_allclose(x, y, atol=2e-5, rtol=0,
                                       err_msg=str(path))
        for got, want in zip(mk, one_m):
            for name, v in want.items():
                assert got[name] == pytest.approx(v, rel=1e-5), name
    _equal(res[0][K][0], res[-1][K][0])


def _rank_k_only(device, tree, cfg, pool, perm, seed):
    from nerf_fl_torch.parallel import make_mesh, multihost, place_params
    mesh = make_mesh(1, 2, devices=multihost.job_devices(device))
    params, opt = _port(tree, cfg)
    place_params(mesh, params, True, opt)
    return _steps(params, opt, cfg, pool, perm, K, seed, mesh)


def test_tp_k_step_matches_jax_scanned_k_step():
    import jax
    import jax.numpy as jnp
    from nerf_fl_tpu.parallel import batch_sharding
    from nerf_fl_tpu.parallel import make_mesh as jmake_mesh
    from nerf_fl_tpu.parallel import place_params as jplace
    from nerf_fl_tpu.render import RenderConfig as JRenderConfig
    from nerf_fl_tpu.training import optimizers as jopt
    from nerf_fl_tpu.training import system as jsys
    jp, tree = _jax_tree()
    pool, perm = _pool(seed=6)
    jcfg = JRenderConfig(use_pallas=False, perturb=0.0, noise_std=0.0,
                         **MODEL)
    tx = jopt.build_optimizer(types.SimpleNamespace(
        optimizer="adam", lr=LR, weight_decay=0.0))
    mask = jopt.make_trainable_mask(jp, False)
    jmesh = jmake_mesh(num_model=2)
    jp = jplace(jmesh, jp, model_parallel=True)
    jstep = jsys.make_device_pool_step(
        jcfg, tx, mask, batch_size=B, donate=False, steps_per_execution=K,
        data_sharding=batch_sharding(jmesh))
    ostate = tx.init(jp)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    jm = []
    for i0 in range(0, N_STEPS, K):
        jp, ostate, m = jstep(jp, ostate, jpool, jnp.asarray(perm),
                              jnp.int32(i0), jnp.uint32(i0),
                              jnp.int32(N_STEPS), jnp.float32(LR),
                              jnp.float32(0.0), jax.random.PRNGKey(0))
        n = min(K, N_STEPS - i0)
        jm += [{k: float(v[j]) for k, v in m.items()} for j in range(n)]
    want = jax.tree_util.tree_map(np.asarray, jp)
    cfg = RenderConfig(perturb=0.0, noise_std=0.0, **MODEL)
    res = _spawn(_rank_k_only, tree, cfg, pool, perm, 0)
    for got, _, metrics, _ in res:
        assert len(metrics) == len(jm) == N_STEPS
        for a, b in zip(metrics, jm):
            assert a.keys() == b.keys()
            np.testing.assert_allclose([a[k] for k in sorted(a)],
                                       [b[k] for k in sorted(b)],
                                       rtol=2e-3, atol=2e-5)
        for path, d in _leaves(jax.tree_util.tree_map(
                lambda a, b: np.abs(np.asarray(a) - b), want, got)):
            assert d.max() <= 2e-3 and d.mean() <= 1e-4, path
    _equal(res[0][0], res[1][0])


def test_tp_k_step_bf16_matches_one_rank():
    _, tree = _jax_tree()
    pool, perm = _pool(seed=8)
    cfg = RenderConfig(perturb=1.0, noise_std=1.0, compute_dtype="bfloat16",
                       **MODEL)
    res = _spawn(_rank_k_only, tree, cfg, pool, perm, 5)
    params, opt = _port(tree, cfg)
    one, _, one_m, _ = _steps(params, opt, cfg, pool, perm, K, 5)
    got, _, metrics, _ = res[0]
    loss = np.array([m["train/loss"] for m in metrics])
    want = np.array([m["train/loss"] for m in one_m])
    np.testing.assert_allclose(loss, want, rtol=BF16_LOSS_RTOL)
    ones = dict(_leaves(one))
    for path, x in _leaves(got):
        d = np.abs(x - ones[path])
        assert d.mean() <= BF16_MEAN and d.max() <= BF16_MAX, \
            (path, d.mean(), d.max())
    _equal(res[0][0], res[1][0])


def _rank_render(device, tree, cfg, rays, ts):
    from nerf_fl_torch.parallel import make_mesh, multihost, place_params
    from nerf_fl_torch.training import render_chunked
    mesh = make_mesh(1, 2, devices=multihost.job_devices(device))
    params, _ = _port(tree, cfg)
    place_params(mesh, params, True)
    return render_chunked(params, rays, ts, cfg, chunk=128, device="cpu",
                          mesh=mesh, generator=torch.Generator().manual_seed(5))


def test_render_chunked_model2_matches_one_rank():
    """A 300-ray eval render (test time) under model 2 against one rank's,
    every output within ``RENDER_ATOL``; both ranks the same bit for bit."""
    from nerf_fl_torch.training import render_chunked
    _, tree = _jax_tree()
    b = _data(300, seed=2)
    cfg = RenderConfig(**MODEL)
    params, _ = _port(tree, cfg)
    want = render_chunked(params, b["rays"], b["ts"], cfg, chunk=128,
                          device="cpu",
                          generator=torch.Generator().manual_seed(5))
    res = _spawn(_rank_render, tree, cfg, b["rays"], b["ts"])
    for got in res:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=RENDER_ATOL,
                                       rtol=0, err_msg=k)
            np.testing.assert_array_equal(got[k], res[0][k], err_msg=k)


def _rank_pieces(device):
    from nerf_fl_torch.parallel import make_mesh, multihost
    from nerf_fl_torch.parallel.mesh import Pieces, recording
    mesh = make_mesh(1, 2, devices=multihost.job_devices(device))
    r = mesh.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    y = torch.full((2, 2), float(r + 1), dtype=torch.bfloat16)
    plain = (mesh.model.all_reduce(x.clone()),
             mesh.model.all_gather(x, dim=1), mesh.data.all_reduce(y.clone()))
    pieces = Pieces(False)
    with recording(pieces, mesh):
        xs = x.clone()
        got = (mesh.model.all_reduce(xs), mesh.model.all_gather(x, dim=1),
               mesh.data.all_reduce(y.clone()))
        with pytest.raises(RuntimeError, match="already being recorded"):
            with recording(Pieces(False), mesh):
                pass
    assert got[0] is xs
    return plain, got, pieces.plan, pieces.digest()


def test_pieces_records_collectives_and_runs_them_on_the_cpu():
    res = _spawn(_rank_pieces)
    for r, (plain, got, plan, digest) in enumerate(res):
        for a, b in zip(plain, got):
            assert torch.equal(a, b)
        x0 = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        assert torch.equal(got[0], 2 * x0 + 10)
        assert torch.equal(got[1], torch.cat([x0, x0 + 10], 1))
        assert torch.equal(got[2], torch.full((2, 2), float(r + 1),
                                              dtype=torch.bfloat16))
        assert plan == ["model.all_reduce(2, 3)", "model.all_gather(2, 3)@1",
                        "data.all_reduce(2, 2)"]
        assert digest == res[0][3]
