"""The port's data- and tensor-parallel training and sharded render
(``nerf_fl_torch/parallel/``) against the JAX package and against the
port's own single-rank path, on the CPU.

Ranks are processes of a gloo job (``parallel.launch.spawn``, one thread
each, a join timeout on every job): 2 ranks, 4 for data 2 x model 2.  The
JAX side runs as its own tests run it, on the CPU with the 8 virtual
devices of ``tests/conftest.py``, in this process.  NeRF-W 8 + 8 samples
at depth 8 (the skip at layer 4) and width 32, f32, N_vocab 8.

  * ``make_mesh``'s shapes and errors; the tensor-parallel layout leaf for
    leaf against the JAX package's ``param_shardings``;
  * data 2 against JAX's single-device step (perturb 0, noise 0): the loss
    within rel 1e-4 (``tests/test_train_system.py::test_multidevice_dp_
    matches_single_device``), the weights at the limits of
    ``tests/test_torch_lockstep.py`` (one Adam step of the port's own
    single-rank path is up to 6.4e-4 from JAX's here, so JAX's 1e-5
    between two JAX layouts cannot hold across the packages);
  * data 2 against the port's single-rank step with perturb 1 and noise 1
    (each rank draws at the global batch's shape), and the device-pool
    step with K = 2 (and microbatch 2): metrics and reduced gradients at
    f32 1e-6, the weights after Adam within 2e-5;
  * model 2 and data 2 x model 2: the loss against JAX's single-device
    step, layers 0, 1 and 4 and ``dir`` within 2e-5 of the port's
    single-rank step (``test_model_parallel_matches_single_device``), the
    gathered params whole;
  * ``render_chunked`` over 2 ranks against one rank, exactly.

The rank functions below are module-level and this module imports no JAX
at its top, so a rank process imports torch and the port only.
"""
import numpy as np
import pytest
import torch

from nerf_fl_torch.bridge import (from_jax_params, grads_to_numpy_tree,
                                  to_numpy_tree)
from nerf_fl_torch.render import RenderConfig

JOB_TIMEOUT = 120
LR = 5e-4
N_VOCAB = 8
MODEL = dict(N_samples=8, N_importance=8, encode_a=True, encode_t=True,
             white_back=True, beta_min=0.1, mlp_depth=8, mlp_width=32)


def _batch(n=256, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32)], 1)
    return {"rays": rays,
            "ts": rng.integers(0, N_VOCAB, n).astype(np.int32),
            "rgbs": rng.uniform(0, 1, (n, 3)).astype(np.float32)}


def _jax_params(seed=0):
    import jax
    from nerf_fl_tpu.render import RenderConfig as JRenderConfig
    from nerf_fl_tpu.training import system as jsys
    jcfg = JRenderConfig(perturb=0.0, noise_std=0.0, **MODEL)
    jp = jsys.build_params(jax.random.PRNGKey(seed), jcfg, N_VOCAB)
    return jcfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _jax_step(jcfg, jp, batch):
    """One single-device step of the JAX package: (loss, params)."""
    import types
    import jax
    import jax.numpy as jnp
    from nerf_fl_tpu.training import optimizers as jopt
    from nerf_fl_tpu.training import system as jsys
    tx = jopt.build_optimizer(types.SimpleNamespace(
        optimizer="adam", lr=LR, weight_decay=0.0))
    step = jsys.make_train_step(jcfg, tx, jopt.make_trainable_mask(jp, False),
                                donate=False)
    p, _, m = step(jp, tx.init(jp), {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                   jnp.float32(LR), jnp.float32(0.0), jax.random.PRNGKey(0))
    return float(m["train/loss"]), jax.tree_util.tree_map(np.asarray, p)


def _port(tree, cfg, device="cpu"):
    """The port's params from a numpy JAX tree, and an Adam over them."""
    import types
    from nerf_fl_torch.training import optimizers
    params = from_jax_params(tree, cfg, device=device)
    opt = optimizers.build_optimizer(
        types.SimpleNamespace(optimizer="adam", lr=LR, weight_decay=0.0),
        optimizers.trainable_parameters(
            params, optimizers.make_trainable_mask(params, False)))
    return params, opt


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ----------------------------------------------------------------------
# rank functions (run in the job's processes)
# ----------------------------------------------------------------------

def _rank_step(device, tree, cfg, batch, num_data, num_model, microbatch,
               seed):
    """One train step on the job's mesh; (mesh coordinates, metrics, the
    whole params as a numpy tree, the held coarse shapes, the reduced
    gradients without a model axis)."""
    from nerf_fl_torch.parallel import (make_mesh, multihost, place_params,
                                        shard_batch, whole_params)
    from nerf_fl_torch.data.sampler import host_rows
    from nerf_fl_torch.training import make_train_step
    mesh = make_mesh(num_data, num_model,
                     devices=multihost.job_devices(device))
    params, opt = _port(tree, cfg)
    place_params(mesh, params, num_model > 1, opt)
    step = make_train_step(cfg, opt, microbatch=microbatch, mesh=mesh)
    rows = host_rows(len(batch["rays"]), mesh.data_index, mesh.num_data,
                     microbatch)
    local = {k: torch.from_numpy(np.array(v)[rows]) for k, v in batch.items()}
    if microbatch == 1:
        whole = shard_batch(mesh, _t(batch))
        assert all(torch.equal(whole[k], local[k]) for k in local)
    m = step(params, local, LR, generator=torch.Generator().manual_seed(seed))
    shapes = {n: tuple(p.shape) for n, p in params["nerf_coarse"]
              .named_parameters()}
    grads = grads_to_numpy_tree(params) if num_model == 1 else None
    with whole_params(mesh, params, opt, num_model > 1):
        tree = to_numpy_tree(params)
    coords = (mesh.shape, mesh.data_index, mesh.model_index, mesh.backend)
    return coords, {k: float(v) for k, v in m.items()}, tree, shapes, grads


def _rank_pool(device, tree, cfg, pool, perm, microbatch, seed):
    """Two calls of the K = 2 device-pool step (three sub-steps, the last
    masked) over a data mesh of the job: (losses, params)."""
    from nerf_fl_torch.parallel import make_mesh, multihost, place_params
    from nerf_fl_torch.training import make_device_pool_step
    mesh = make_mesh(devices=multihost.job_devices(device))
    params, opt = _port(tree, cfg)
    place_params(mesh, params, False, opt)
    return _pool_run(params, opt, cfg, pool, perm, microbatch, seed, mesh)


def _pool_run(params, opt, cfg, pool, perm, microbatch, seed, mesh=None):
    from nerf_fl_torch.training import make_device_pool_step
    run = make_device_pool_step(cfg, opt, batch_size=64, microbatch=microbatch,
                                steps_per_execution=2, mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for i0 in (0, 2):
        m = run(params, _t(pool), torch.from_numpy(perm), i0, 3, LR,
                generator=gen)
        losses += [float(x) for x in m["train/loss"]]
    return losses, to_numpy_tree(params)


def _rank_render(device, tree, cfg, rays, ts, chunk):
    from nerf_fl_torch.parallel import make_mesh, multihost, place_params
    from nerf_fl_torch.training import render_chunked
    mesh = make_mesh(devices=multihost.job_devices(device))
    params, _ = _port(tree, cfg)
    place_params(mesh, params)
    return render_chunked(params, rays, ts, cfg, chunk=chunk,
                          test_time=False, device="cpu", mesh=mesh,
                          generator=torch.Generator().manual_seed(5))


def _spawn(fn, *args, ranks=2):
    from nerf_fl_torch.parallel import launch
    return launch.spawn(fn, args, devices=["cpu"] * ranks,
                        timeout=JOB_TIMEOUT)


def _close(a, b, atol, what):
    import jax
    for (path, x), y in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                            jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(x, y, atol=atol, rtol=0,
                                   err_msg=f"{what} {path}")


# ----------------------------------------------------------------------
# tests
# ----------------------------------------------------------------------

def test_make_mesh_shapes_and_errors():
    from nerf_fl_torch.parallel import make_mesh
    m = make_mesh(devices=["cpu"])
    assert m.shape == {"data": 1, "model": 1} and m.backend == "gloo"
    assert (m.rank, m.data_index, m.model_index) == (0, 0, 0)
    with pytest.raises(ValueError, match=r"requested mesh data=2 x model=1 "
                       r"= 2 devices but only 1 cpu device\(s\).*Fixes"):
        make_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="not divisible by model=3"):
        make_mesh(num_model=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="one process a rank"):
        make_mesh(2, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"only 0 cuda device\(s\)"):
            make_mesh(2)
    from nerf_fl_torch.parallel.mesh import backend_for
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert backend_for(["cpu", "cpu"]) == "gloo"


@pytest.mark.parametrize("width", [256, 30])
def test_tp_layout_matches_jax_param_shardings(width):
    """Every leaf's sharded dim, transposed to ``nn.Linear``'s (out, in),
    is the JAX package's (a width of 30 leaves what does not divide by 4
    replicated, leaf by leaf)."""
    import jax
    from nerf_fl_tpu.parallel import make_mesh as jmake_mesh
    from nerf_fl_tpu.parallel import param_shardings as jshardings
    from nerf_fl_tpu.render import RenderConfig as JRenderConfig
    from nerf_fl_tpu.training import system as jsys
    from nerf_fl_torch.parallel.mesh import Comm, Mesh, param_shardings
    model = dict(MODEL, mlp_width=width)
    jp = jsys.build_params(jax.random.PRNGKey(0), JRenderConfig(**model),
                           N_VOCAB)
    jmesh = jmake_mesh(num_model=4)
    jspec = jshardings(jmesh, jp, model_parallel=True)
    solo = Comm(None, 1, 0, False, solo=True)
    mesh = Mesh(2, 4, 0, torch.device("cpu"), "gloo", solo, solo, solo)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                             RenderConfig(**model), device="cpu")
    ours = param_shardings(mesh, params, model_parallel=True)
    names = {"w": "weight", "b": "bias"}
    n_sharded = 0
    for path, sh in jax.tree_util.tree_flatten_with_path(jspec)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        name = ".".join(keys[:-1] + [names.get(keys[-1], keys[-1])])
        want = tuple(sh.spec) + (None,) * (len(ours[name]) - len(sh.spec))
        if keys[-1] == "w":
            want = want[::-1]
        assert ours[name] == want, (name, ours[name], want)
        n_sharded += "model" in want
    assert len(ours) == len(jax.tree_util.tree_leaves(jspec))
    assert n_sharded == (32 if width == 256 else 0)
    assert param_shardings(mesh, params) == {k: (None,) * len(v)
                                             for k, v in ours.items()}


def _lockstep_close(got, want):
    """Parameters after one Adam step against the JAX package's, at the
    limits of tests/test_torch_lockstep.py (max 2e-3, mean 1e-4 per leaf):
    Adam moves a weight whose gradient is near zero by up to 2 lr when the
    two packages' gradients differ in sign there, which the port's
    single-rank step already shows against JAX's (up to 6.4e-4 in this
    configuration)."""
    import jax
    for path, d in jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(
            lambda a, b: np.abs(np.asarray(a) - b), want, got))[0]:
        assert d.max() <= 2e-3 and d.mean() <= 1e-4, path


def _grads_close(got, want, rel):
    """Per leaf, max |d| <= rel x the leaf's largest gradient: the f32
    gradient of the global batch, summed in another order."""
    import jax
    for path, d in jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(
            lambda a, b: float(np.abs(a - b).max() / (np.abs(b).max()
                                                      + 1e-30)),
            got, want))[0]:
        assert d <= rel, (path, d)


def test_dp2_step_matches_jax_single_device():
    """Data 2 against JAX's single-device step: the loss within rel 1e-4,
    the weights at the lockstep limits."""
    jcfg, jp, tree = _jax_params()
    batch = _batch()
    want_loss, want = _jax_step(jcfg, jp, batch)
    cfg = RenderConfig(perturb=0.0, noise_std=0.0, **MODEL)
    res = _spawn(_rank_step, tree, cfg, batch, 2, 1, 1, 0)
    for r, (coords, m, got, _, _) in enumerate(res):
        assert coords == ({"data": 2, "model": 1}, r, 0, "gloo")
        assert m["train/loss"] == pytest.approx(want_loss, rel=1e-4)
        _lockstep_close(got, want)
    _close(res[0][2], res[1][2], 0, "rank 1 against rank 0")


@pytest.mark.parametrize("microbatch", [1, 2])
def test_dp2_step_matches_one_rank_with_noise(microbatch):
    """perturb 1 and noise 1: every rank draws at the global shape, so
    data 2 is the single-rank step up to the order of its f32 sums
    (microbatch 2 slices the global batch first and then shards each
    slice): the metrics within rel 1e-6, the reduced gradients within 1e-6
    of each leaf's largest, the weights after Adam within 2e-5 (the limit
    of tests/test_train_system.py for a layout-only change; Adam's first
    step divides by |g|, so a gradient near its eps moves by more than the
    sum order's 1e-6)."""
    _, _, tree = _jax_params()
    batch = _batch()
    cfg = RenderConfig(perturb=1.0, noise_std=1.0, **MODEL)
    params, opt = _port(tree, cfg)
    from nerf_fl_torch.training import make_train_step
    want = make_train_step(cfg, opt, microbatch=microbatch)(
        params, _t(batch), LR, generator=torch.Generator().manual_seed(3))
    res = _spawn(_rank_step, tree, cfg, batch, 2, 1, microbatch, 3)
    for _, m, got, _, grads in res:
        for k, v in want.items():
            assert m[k] == pytest.approx(float(v), rel=1e-6, abs=1e-6), k
        _grads_close(grads, grads_to_numpy_tree(params), 1e-6)
        _close(got, to_numpy_tree(params), 2e-5, "data 2 against one rank")


@pytest.mark.parametrize("microbatch", [1, 2])
def test_dp2_pool_step_k2_matches_one_rank(microbatch):
    """The device-pool step with steps_per_execution 2 over data 2 (each
    rank gathers its rows of perm[i*B:(i+1)*B], both halves of the sub-step
    around the all-reduce, a masked tail) against one rank's, as
    tests/test_train_system.py::test_device_pool_dp_sharded holds JAX's:
    the losses within rel 1e-6, the weights within 2e-5."""
    _, _, tree = _jax_params()
    pool = _batch(n=256, seed=4)
    perm = np.random.default_rng(0).permutation(256).astype(np.int32)
    cfg = RenderConfig(perturb=1.0, noise_std=1.0, **MODEL)
    params, opt = _port(tree, cfg)
    want_losses, want = _pool_run(params, opt, cfg, pool, perm, microbatch, 9)
    res = _spawn(_rank_pool, tree, cfg, pool, perm, microbatch, 9)
    for losses, got in res:
        assert np.isnan(losses[3]) and not np.isnan(losses[:3]).any()
        np.testing.assert_allclose(losses[:3], want_losses[:3], rtol=1e-6)
        _close(got, want, 2e-5, "pool step, data 2 against one rank")


@pytest.mark.parametrize("num_data,num_model", [(1, 2), (2, 2)])
def test_tp_step_matches_jax_single_device(num_data, num_model):
    """Model 2 and data 2 x model 2: the loss within rel 1e-4 of JAX's
    single-device step and its weights at the lockstep limits; layers 0
    (column-parallel), 1 (row-parallel) and 4 (the skip) and ``dir``
    within 2e-5 of the port's single-rank step, the limit of
    tests/test_train_system.py::test_model_parallel_matches_single_device;
    the gathered (checkpoint) params are whole."""
    jcfg, jp, tree = _jax_params()
    batch = _batch()
    want_loss, want = _jax_step(jcfg, jp, batch)
    cfg = RenderConfig(perturb=0.0, noise_std=0.0, **MODEL)
    params, opt = _port(tree, cfg)
    from nerf_fl_torch.training import make_train_step
    make_train_step(cfg, opt)(params, _t(batch), LR)
    one = to_numpy_tree(params)
    res = _spawn(_rank_step, tree, cfg, batch, num_data, num_model, 1, 0,
                 ranks=num_data * num_model)
    for r, (coords, m, got, shapes, _) in enumerate(res):
        assert coords == ({"data": num_data, "model": num_model},
                          r // num_model, r % num_model, "gloo")
        # held shards: column-parallel layer 0, row-parallel layer 1
        assert shapes["xyz.0.weight"] == (32 // num_model, 63)
        assert shapes["xyz.1.weight"] == (32, 32 // num_model)
        assert shapes["static_sigma.weight"] == (1, 32)
        assert m["train/loss"] == pytest.approx(want_loss, rel=1e-4)
        assert m["train/psnr"] == pytest.approx(
            float(res[0][1]["train/psnr"]), rel=1e-6)
        _lockstep_close(got, want)
        for sub in ("nerf_coarse", "nerf_fine"):
            for i in (0, 1, 4):
                np.testing.assert_allclose(
                    got[sub]["xyz"][i]["w"], one[sub]["xyz"][i]["w"],
                    atol=2e-5, err_msg=f"{sub}.xyz.{i}.w")
            np.testing.assert_allclose(got[sub]["dir"]["w"],
                                       one[sub]["dir"]["w"], atol=2e-5)


def test_render_chunked_two_ranks_matches_one_exactly(capsys):
    """700 rays at chunk 255 (rounded up to 256 for data 2), perturb 1 and
    noise 1 at train time: the frame bit for bit one rank's."""
    _, _, tree = _jax_params()
    b = _batch(n=700, seed=2)
    cfg = RenderConfig(perturb=1.0, noise_std=1.0, **MODEL)
    params, _ = _port(tree, cfg)
    from nerf_fl_torch.training import render_chunked
    want = render_chunked(params, b["rays"], b["ts"], cfg, chunk=256,
                          test_time=False, device="cpu",
                          generator=torch.Generator().manual_seed(5))
    res = _spawn(_rank_render, tree, cfg, b["rays"], b["ts"], 255)
    for got in res:
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_cli_model_parallel_2_matches_one_process(tmp_path,
                                                        monkeypatch):
    """``python -m nerf_fl_torch.train --model_parallel 2
    --steps_per_execution 2`` on the CPU (two tensor-parallel ranks, the
    device pool in K-steps of 2): the checkpoint rank 0 writes is the whole
    model (gathered from the shards, with its Adam state), and it holds the
    weights of one process's run within 5e-4 (tests/test_multihost.py's
    limit) and resumes in one process."""
    import os
    import subprocess
    import sys
    from nerf_fl_torch import opt as topt
    from nerf_fl_torch import train as ttrain
    from nerf_fl_torch.data.synthetic import make_blender_scene
    from nerf_fl_torch.training import checkpoints
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = str(tmp_path / "scene")
    make_blender_scene(scene, n_train=2, n_val=1, n_test=1, size=24)
    argv = ["--root_dir", scene, "--img_wh", "24", "24", "--N_samples", "8",
            "--N_importance", "8", "--mlp_width", "32", "--encode_a",
            "--encode_t", "--N_vocab", "4", "--batch_size", "128",
            "--num_epochs", "1", "--noise_std", "0", "--refresh_every", "0",
            "--steps_per_execution", "2", "--save_path", "ckpts"]
    out = subprocess.run(
        [sys.executable, "-m", "nerf_fl_torch.train"] + argv
        + ["--model_parallel", "2", "--exp_name", "tp"], cwd=tmp_path,
        capture_output=True, text=True, timeout=JOB_TIMEOUT,
        env={**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1",
             "NERF_FL_TORCH_DEVICE": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(1)
    one = ttrain.main(topt.get_opts(argv + ["--exp_name", "one"]),
                      device="cpu")
    path = str(tmp_path / "ckpts" / "tp" / "epoch=0.ckpt")
    tp = checkpoints.load_checkpoint(path)
    assert tp["global_step"] == one.global_step == 9
    for key in ("nerf_coarse", "nerf_fine"):
        for name, p in one.params[key].named_parameters():
            got = tp["state_dict"][key][name]
            assert got.shape == p.shape, name
            np.testing.assert_allclose(got.numpy(), p.detach().numpy(),
                                       atol=5e-4, err_msg=f"{key}.{name}")
    from nerf_fl_torch.training.system import NeRFSystem
    again = NeRFSystem(topt.get_opts(argv + ["--exp_name", "again",
                                             "--ckpt_path", path]),
                       device="cpu")
    again.setup()
    again.configure()
    assert (again.start_epoch, again.global_step) == (1, 9)
