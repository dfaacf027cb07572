"""NeRFSystem of the port against the JAX package's, on the CPU.

One tiny scene (the JAX package's ``make_blender_scene``, 40 x 40, 4 train
views), NeRF-W at depth 2 width 32, 8 + 8 samples, f32, perturb 0, noise 0,
Adam with a cosine schedule, batch 256 (25 steps an epoch), 2 epochs, the
port's initial parameters carried from JAX's through the bridge.  Each
feed of ``fit`` is checked: host-fed single steps, host-fed groups of
steps_per_execution 4, and the device pool with 4.  Every logged metric
(each call's last sub-step) within the tolerances of
tests/test_torch_lockstep.py (rtol 2e-3, atol 2e-5) and the val PSNR of
each epoch within 0.05 dB.  Then a JAX checkpoint of epoch 0 resumes in
the port (weights, Adam state, epoch, step), and the next epoch's losses
match JAX's own resume; and ``gauge_val_psnr`` with a given gauge matches
JAX's within 0.05 dB.  Pose refinement: ``setup`` with --pose_noise (with
and without --refine_pose) gives JAX's noisy and clean poses bit for bit;
BARF through ``fit`` (paper schedule, pose warmup and lr multiplier, host
fed and from the device pool) logs JAX's metrics within the same limits
and learns its pose deltas within 1e-2 of their largest value; and
``gauge_val_psnr`` estimates JAX's gauge from learned poses.
"""
import os

import jax
import numpy as np
import pytest
import torch

import opt as jopt_cli
from nerf_fl_tpu.data.synthetic import make_blender_scene
from nerf_fl_tpu.training import system as jsys
from nerf_fl_tpu.training.logging import NullLogger as JNull
from nerf_fl_torch.bridge import from_jax_params
from nerf_fl_torch.opt import get_opts
from nerf_fl_torch.training import optimizers, system
from nerf_fl_torch.training.logging import NullLogger

RTOL, ATOL = 2e-3, 2e-5


class _Rec:
    def __init__(self, base):
        self.base, self.rows = base, []

    def __call__(self):
        rec = self

        class Logger(self.base):
            def scalars(self, values, step):
                rec.rows.append((step, {k: float(v)
                                        for k, v in values.items()}))
        return Logger()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sys_scene"))
    make_blender_scene(root, n_train=4, n_val=1, n_test=1, size=40)
    return root


def _argv(scene, save, spe, pool, epochs=2, ckpt=None):
    argv = ["--root_dir", scene, "--img_wh", "40", "40", "--N_samples", "8",
            "--N_importance", "8", "--mlp_depth", "2", "--mlp_width", "32",
            "--encode_a", "--encode_t", "--N_vocab", "8", "--batch_size",
            "256", "--num_epochs", str(epochs), "--perturb", "0",
            "--noise_std", "0", "--lr", "5e-4", "--lr_scheduler", "cosine",
            "--exp_name", "e", "--save_path", save, "--refresh_every", "0",
            "--log_every", "1", "--steps_per_execution", str(spe),
            "--device_pool", pool, "--chunk", "4096"]
    return argv + (["--ckpt_path", ckpt] if ckpt else [])


def _jax_system(argv):
    rec = _Rec(JNull)
    s = jsys.NeRFSystem(jopt_cli.get_opts(argv), logger=rec())
    s.setup()
    s.configure()
    return s, rec


def _port_system(argv, jparams=None):
    """The port's system, its initial parameters JAX's when given."""
    rec = _Rec(NullLogger)
    s = system.NeRFSystem(get_opts(argv), logger=rec(), device="cpu")
    s.setup()
    s.configure()
    if jparams is not None:
        carried = from_jax_params(
            jax.tree_util.tree_map(np.asarray, jparams), s.cfg)
        with torch.no_grad():
            for (n, p), (m, q) in zip(optimizers.named_leaves(s.params),
                                      optimizers.named_leaves(carried)):
                assert n == m
                p.copy_(q)
    return s, rec


def _compare(jrows, trows):
    assert [s for s, _ in jrows] == [s for s, _ in trows]
    n = 0
    for (step, j), (_, t) in zip(jrows, trows):
        assert sorted(j) == sorted(t), step
        for k in j:
            if k == "train/rays_per_sec":
                continue
            np.testing.assert_allclose(
                t[k], j[k], rtol=RTOL if not k.startswith("val/psnr") else 0,
                atol=ATOL if not k.startswith("val/psnr") else 0.05,
                err_msg=f"{k} at step {step}")
            n += 1
    return n


@pytest.mark.parametrize("spe,pool", [(1, "off"), (4, "off"), (4, "on")])
def test_fit_matches_jax(scene, tmp_path, spe, pool):
    argv = _argv(scene, str(tmp_path / "j"), spe, pool)
    js, jrec = _jax_system(argv)
    ts, trec = _port_system(_argv(scene, str(tmp_path / "t"), spe, pool),
                            js.params)
    js.fit()
    assert (ts.device_pool is not None) == (pool == "on")
    ts.fit()
    assert ts.global_step == js.global_step == 50
    n = _compare(jrec.rows, trec.rows)
    assert n > 50
    vals = [r["val/psnr"] for _, r in trec.rows if "val/psnr" in r]
    assert len(vals) == 2 and vals[1] > vals[0]
    assert sorted(os.listdir(tmp_path / "t" / "e")) == ["epoch=0.ckpt",
                                                        "epoch=1.ckpt"]
    assert [e["steps"] for e in ts.epoch_stats] == [25, 25]


def test_resume_from_a_jax_checkpoint_matches_jax(scene, tmp_path):
    save = str(tmp_path / "j")
    js, _ = _jax_system(_argv(scene, save, 1, "off", epochs=1))
    js.fit()
    ckpt = os.path.join(save, "e", "epoch=0.ckpt")
    jr, jrec = _jax_system(_argv(scene, save, 1, "off", ckpt=ckpt))
    tr, trec = _port_system(_argv(scene, str(tmp_path / "t"), 1, "off",
                                  ckpt=ckpt))
    assert tr.start_epoch == jr.start_epoch == 1
    assert tr.global_step == jr.global_step == 25
    st = next(iter(tr.optimizer.state.values()))
    assert float(st["step"]) == 25
    jr.fit()
    tr.fit()
    assert _compare(jrec.rows, trec.rows) > 25


def test_unported_flags_raise(scene, tmp_path):
    """More than one device or host (A.8, ported) needs a job of one
    process a rank: a ``NeRFSystem`` made outside one raises and names the
    way to start it (the train CLI starts the ranks itself,
    tests/test_torch_entry.py and test_torch_multihost.py).  The LLFF
    dataset (A.6) is ported: its system sets up as JAX's does."""
    for extra in (["--num_gpus", "2"], ["--model_parallel", "2"],
                  ["--num_hosts", "2"]):
        s = system.NeRFSystem(get_opts(_argv(scene, str(tmp_path), 1, "off")
                                       + extra), device="cpu")
        with pytest.raises(ValueError, match="one process a rank in a "
                           "torch.distributed job.*nerf_fl_torch.train"):
            s.setup()
    from nerf_fl_tpu.data.synthetic import make_llff_scene
    llff = str(tmp_path / "llff")
    make_llff_scene(llff, n_images=4)
    argv = _argv(scene, str(tmp_path), 1, "off") + [
        "--dataset_name", "llff", "--root_dir", llff, "--img_wh", "40", "30"]
    js, _ = _jax_system(argv)
    ts, _ = _port_system(argv)
    assert ts.ray_format == js.ray_format == "world"
    assert ts.id_to_cam is None and js.id_to_cam is None
    for k in ("rays", "ts", "rgbs"):
        np.testing.assert_array_equal(getattr(ts.batcher, k),
                                      getattr(js.batcher, k))
    assert "learn_poses" not in ts.params


BARF_FLAGS = ["--refine_pose", "--pose_noise", "2", "0.02",
              "--barf_schedule", "paper", "--barf_epochs", "0", "2",
              "--pose_warmup_epochs", "0.5", "--pose_lr_mult", "2"]


@pytest.mark.parametrize("refine", [True, False], ids=["refine", "frozen"])
def test_pose_noise_setup_matches_jax(scene, tmp_path, capsys, refine):
    """--pose_noise with and without --refine_pose (the frozen control
    arm): camera-frame rays, the clean and the noisy initial poses bit for
    bit JAX's, the [pose_noise] line, the deltas trainable only under
    refinement; a world-space dataset (LLFF) refuses the noise in both."""
    extra = BARF_FLAGS if refine else ["--pose_noise", "2", "0.02"]
    argv = _argv(scene, str(tmp_path), 1, "off") + extra
    js, _ = _jax_system(argv)
    jout = capsys.readouterr().out
    ts, _ = _port_system(argv)
    tout = capsys.readouterr().out
    line = [x for x in jout.splitlines() if x.startswith("[pose_noise]")]
    assert len(line) == 1 and line[0] in tout.splitlines()
    assert ts.ray_format == js.ray_format == "camdir"
    for k in ("true_poses", "init_poses"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k))
    assert not np.array_equal(ts.init_poses, ts.true_poses)
    for k in ("rays", "ts", "rgbs"):
        np.testing.assert_array_equal(getattr(ts.batcher, k),
                                      getattr(js.batcher, k))
    table = ts.params["learn_poses"]
    np.testing.assert_array_equal(table.init_c2w.numpy(), js.init_poses)
    assert table.r.requires_grad == table.t.requires_grad == refine
    assert ts.mask["learn_poses.r"] == js.mask["learn_poses"]["r"] == refine
    n_groups = len(ts.optimizer.param_groups)
    assert n_groups == (2 if refine else 1)
    from nerf_fl_tpu.data.synthetic import make_llff_scene
    llff = str(tmp_path / "llff")
    make_llff_scene(llff, n_images=4)
    argv = _argv(scene, str(tmp_path), 1, "off") + extra + [
        "--dataset_name", "llff", "--root_dir", llff, "--img_wh", "40", "30"]
    for make in (_jax_system, _port_system):
        with pytest.raises(ValueError, match="camdir"):
            make(argv)


@pytest.mark.parametrize("spe,pool", [(1, "off"), (4, "on")])
def test_barf_fit_matches_jax(scene, tmp_path, spe, pool):
    """Pose refinement through fit: BARF's paper schedule (continuous
    epoch, annealing over epochs 0-2), the deltas at lr x 2 after a warmup
    of half an epoch; every logged metric as test_fit_matches_jax, and the
    learned deltas within 1e-2 of their largest value plus 1e-7."""
    argv = _argv(scene, str(tmp_path / "j"), spe, pool) + BARF_FLAGS
    js, jrec = _jax_system(argv)
    ts, trec = _port_system(_argv(scene, str(tmp_path / "t"), spe, pool)
                            + BARF_FLAGS, js.params)
    js.fit()
    ts.fit()
    assert ts.global_step == js.global_step == 50
    assert _compare(jrec.rows, trec.rows) > 50
    for k in ("r", "t"):
        want = np.asarray(js.params["learn_poses"][k])
        got = getattr(ts.params["learn_poses"], k).detach().numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max() + 1e-7)


def test_gauge_val_psnr_matches_jax(scene, tmp_path):
    """With a given gauge (a 10 degree turn about z and a shift), the val
    PSNR of the cameras moved into that frame matches JAX's within 0.05
    dB; with refinement on noisy poses and learned deltas, the gauge that
    ``gauge_val_psnr`` estimates from them (gauge=None) is JAX's within
    1e-6 and so is its val PSNR within 0.05 dB."""
    argv = _argv(scene, str(tmp_path), 1, "off")
    js, _ = _jax_system(argv)
    ts, _ = _port_system(argv, js.params)
    a = np.deg2rad(10.0)
    T = np.eye(4)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = [0.1, -0.05, 0.02]
    want, Tj = jsys.gauge_val_psnr(js, 0, gauge=T)
    got, Tt = system.gauge_val_psnr(ts, 0, gauge=T)
    assert np.array_equal(Tj, Tt)
    assert abs(got - want) <= 0.05, (got, want)
    js, _ = _jax_system(argv + BARF_FLAGS)
    rng = np.random.default_rng(5)
    js.params["learn_poses"] = {**js.params["learn_poses"], **{
        k: jax.numpy.asarray(rng.normal(0, 0.02, (4, 3)), np.float32)
        for k in ("r", "t")}}
    ts, _ = _port_system(argv + BARF_FLAGS, js.params)
    want, Tj = jsys.gauge_val_psnr(js, 1)
    got, Tt = system.gauge_val_psnr(ts, 1)
    np.testing.assert_allclose(Tt, Tj, atol=1e-6)
    assert not np.allclose(Tj, np.eye(4), atol=1e-3)
    assert abs(got - want) <= 0.05, (got, want)
