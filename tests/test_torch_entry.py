"""The port's train and eval entry points against the JAX CLIs, on the CPU.

  * the port's train and eval parsers agree with the root ``opt.get_opts``
    and ``eval.get_opts`` on every flag: its option strings, type, default,
    choices, nargs, requiredness and action; the port adds only its own
    flags (``utils.cli.PORT_ONLY``: mip-NeRF's ``--model``) and the
    ``--lr_scheduler`` choice ``mip``, which train and
    eval accept with ``--model mipnerf`` and refuse beside what mip-NeRF
    lacks;
  * ``python -m nerf_fl_torch.train`` and ``python -m nerf_fl_torch.eval``
    run with NERF_FL_TORCH_DEVICE=cpu on a tiny scene, train starting from
    an untrained JAX checkpoint (weights only, loaded non-strictly);
  * eval of that JAX checkpoint: the port's Mean PSNR and Mean SSIM equal
    the JAX eval.py's within 1e-3, and its PNGs differ by at most 1 level;
  * without the device request and without a card both entry points raise;
    eval's options that ROADMAP A.6 ported (mp4, --save_depth,
    Phototourism) run, and those A.7 and A.8 ported (--optimize_appearance,
    --refine_pose, --num_gpus 2: two ranks over gloo) give the JAX
    eval.py's PSNR within 1e-3 (the JAX one over a mesh of 2 devices);
  * the train CLI with --num_gpus 2 --steps_per_execution 3 (two ranks,
    each a K-step of 3 sub-steps around its all-reduce) against one
    process: the same steps, the weights within 5e-4, as
    tests/test_end_to_end.py::test_multichip_cli_train runs the JAX one;
  * train and eval on tiny Phototourism (its ray cache from
    ``prepare_phototourism``, host-fed groups of 2 sub-steps) and LLFF
    (the device pool) scenes, with --save_depth and --video_format mp4:
    the pose table stays as it began, the PFM depth
    reads back to what eval rendered, the mp4 fallback line and the GIF
    appear only where the JAX CLI writes a video, and eval of a JAX
    checkpoint on the LLFF scene gives the JAX eval.py's PSNR within 1e-3
    and its depth within 1e-3.
"""
import argparse
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import eval as jeval
import opt as jopt_cli
from nerf_fl_tpu.data.synthetic import (make_blender_scene, make_llff_scene,
                                        make_phototourism_scene)
from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.training import checkpoints as jckpt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch import eval as teval
from nerf_fl_torch import opt as topt
from nerf_fl_torch import prepare_phototourism as tprep
from nerf_fl_torch import train as ttrain
from nerf_fl_torch.data import pfm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ["--N_samples", "8", "--N_importance", "8", "--mlp_depth", "2",
         "--mlp_width", "32", "--encode_a", "--encode_t", "--N_vocab", "8",
         "--img_wh", "40", "40"]


def _flags(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[a.dest] = (tuple(a.option_strings), a.type, a.default,
                       tuple(a.choices) if a.choices else None, a.nargs,
                       a.required, type(a).__name__, a.const)
    return out


def _eval_parser(module, monkeypatch):
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        return orig(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    module.get_opts(["--root_dir", "r", "--ckpt_path", "c"])
    monkeypatch.undo()
    return seen["parser"]


# the port's own additions to the JAX CLIs' flags
PORT_ONLY = {"model"}
PORT_CHOICES = {"lr_scheduler": ("mip",)}


def _jax_part(got, want):
    """The port's flags less its own, each JAX flag's choices less the
    port's additions; asserts the port's own are exactly PORT_ONLY."""
    assert set(got) - set(want) == PORT_ONLY
    out = {}
    for k, v in got.items():
        if k in PORT_ONLY:
            continue
        extra = PORT_CHOICES.get(k)
        if extra:
            assert v[3][-len(extra):] == extra, k
            v = v[:3] + (v[3][:-len(extra)],) + v[4:]
        out[k] = v
    return out


def test_train_parser_matches_jax():
    want, got = _flags(jopt_cli.get_parser()), _flags(topt.get_parser())
    got = _jax_part(got, want)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k


def test_eval_parser_matches_jax(monkeypatch):
    want = _flags(_eval_parser(jeval, monkeypatch))
    got = _flags(_eval_parser(teval, monkeypatch))
    got = _jax_part(got, {**want, "lr_scheduler": None})
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("extra", [[], ["--encode_a"], ["--encode_t"],
                                   ["--refine_pose"],
                                   ["--dataset_name", "llff"]])
def test_mipnerf_flag_is_accepted_and_refuses_what_it_lacks(extra, capsys):
    """``--model mipnerf`` parses in train and eval, and either refuses
    it beside --encode_a, --encode_t, --refine_pose or another dataset
    than blender, as a parse error."""
    base = ["--root_dir", "r", "--model", "mipnerf"]
    for parse in (lambda a: topt.get_opts(a + ["--lr_scheduler", "mip"]),
                  lambda a: teval.get_opts(a + ["--ckpt_path", "c"])):
        if not extra:
            args = parse(base)
            assert args.model == "mipnerf"
            continue
        with pytest.raises(SystemExit):
            parse(base + extra)
        assert "--model mipnerf" in capsys.readouterr().err


def test_mipnerf_train_and_eval_run_on_the_cpu(scene_and_jax_ckpt, tmp_path):
    """``python -m nerf_fl_torch.train --model mipnerf`` (the device
    pool, --lr_scheduler mip) and ``python -m nerf_fl_torch.eval --model
    mipnerf`` of its checkpoint, on the CPU on the tiny scene."""
    scene, _ = scene_and_jax_ckpt
    env = {"NERF_FL_TORCH_DEVICE": "cpu"}
    mip = ["--model", "mipnerf", "--N_samples", "8", "--mlp_width", "64",
           "--img_wh", "40", "40"]
    out = _run("nerf_fl_torch.train", [
        "--root_dir", scene, *mip, "--noise_std", "0", "--batch_size", "256",
        "--num_epochs",
        "1", "--exp_name", "mip", "--save_path", "ckpts", "--lr_scheduler",
        "mip", "--device_pool", "on"], tmp_path, env)
    assert out.returncode == 0, out.stderr[-3000:]
    m = re.search(r"epoch 0: lr=([\d.e+-]+) val/loss=([\d.]+) "
                  r"val/psnr=([\d.]+)", out.stdout)
    assert m, out.stdout[-2000:]
    assert 0 < float(m.group(1)) < 5e-4
    ckpt = os.path.join(tmp_path, "ckpts", "mip", "epoch=0.ckpt")
    out = _run("nerf_fl_torch.eval", [
        "--root_dir", scene, *mip, "--split", "test", "--ckpt_path", ckpt,
        "--scene_name", "mip"], tmp_path, env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert re.search(r"Mean PSNR : [\d.]+", out.stdout), out.stdout[-2000:]


@pytest.fixture(scope="module")
def scene_and_jax_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry")
    scene = str(root / "scene")
    make_blender_scene(scene, n_train=3, n_val=1, n_test=2, size=40)
    cfg = JRenderConfig(N_samples=8, N_importance=8, encode_a=True,
                        encode_t=True, mlp_depth=2, mlp_width=32)
    ckpt = str(root / "jax.ckpt")
    jckpt.save_checkpoint(ckpt, jsys.build_params(jax.random.PRNGKey(3),
                                                  cfg, 8))
    return scene, ckpt


def _run(module, argv, cwd, env=None):
    env = {**os.environ, "PYTHONPATH": ROOT, **(env or {})}
    return subprocess.run([sys.executable, "-m", module] + argv, cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_cli_train_and_eval_run_on_the_cpu(scene_and_jax_ckpt, tmp_path):
    scene, jax_ckpt = scene_and_jax_ckpt
    env = {"NERF_FL_TORCH_DEVICE": "cpu"}
    out = _run("nerf_fl_torch.train", [
        "--root_dir", scene, *MODEL, "--batch_size", "256", "--num_epochs",
        "1", "--exp_name", "cli", "--save_path", "ckpts", "--ckpt_path",
        jax_ckpt, "--refresh_every", "0", "--steps_per_execution", "2"],
        tmp_path, env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "loaded weights (non-strict)" in out.stdout
    assert "val/psnr=" in out.stdout
    ckpt = tmp_path / "ckpts" / "cli" / "epoch=0.ckpt"
    assert ckpt.exists()
    assert (tmp_path / "logs" / "cli" / "metrics.jsonl").exists()
    out = _run("nerf_fl_torch.eval", [
        "--root_dir", scene, *MODEL, "--split", "test", "--ckpt_path",
        str(ckpt), "--scene_name", "cli", "--compute_ssim"], tmp_path, env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert re.search(r"Mean PSNR : \d+\.\d\d", out.stdout)
    assert re.search(r"Mean SSIM : \d\.\d{4}", out.stdout)
    res = tmp_path / "results" / "blender" / "cli"
    assert sorted(os.listdir(res)) == ["000.png", "001.png", "cli.gif"]


def test_train_cli_num_gpus_2_steps_per_execution_3(scene_and_jax_ckpt,
                                                     tmp_path, monkeypatch):
    """``python -m nerf_fl_torch.train --num_gpus 2 --steps_per_execution
    3`` on the CPU: two ranks over gloo train the device pool in K-steps
    of 3 (each sub-step's all-reduce between its two halves), as the JAX
    CLI's mesh of 2 does (tests/test_end_to_end.py::test_multichip_cli_
    train); its checkpoint, written by rank 0 alone, holds a whole epoch of
    steps and the weights of one process's run within 5e-4, the limit of
    tests/test_multihost.py."""
    from nerf_fl_torch.training import checkpoints
    scene, _ = scene_and_jax_ckpt
    argv = ["--root_dir", scene, *MODEL, "--batch_size", "256",
            "--num_epochs", "1", "--noise_std", "0", "--refresh_every", "0",
            "--steps_per_execution", "3", "--save_path", "ckpts"]
    out = _run("nerf_fl_torch.train", argv + [
        "--num_gpus", "2", "--exp_name", "dp2"], tmp_path,
        {"NERF_FL_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("val/psnr=") == 2          # one line a rank
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(1)
    one = ttrain.main(topt.get_opts(argv + ["--exp_name", "one"]),
                      device="cpu")
    dp = checkpoints.load_checkpoint(str(tmp_path / "ckpts" / "dp2"
                                         / "epoch=0.ckpt"))
    assert dp["global_step"] == one.global_step \
        == one.batcher.steps_per_epoch() == 18
    for key in ("nerf_coarse", "nerf_fine"):
        for name, p in one.params[key].named_parameters():
            np.testing.assert_allclose(dp["state_dict"][key][name].numpy(),
                                       p.detach().numpy(), atol=5e-4,
                                       err_msg=f"{key}.{name}")


def test_eval_of_a_jax_checkpoint_matches_jax_eval(scene_and_jax_ckpt,
                                                   tmp_path, monkeypatch,
                                                   capsys):
    scene, jax_ckpt = scene_and_jax_ckpt
    argv = ["--root_dir", scene, *MODEL, "--split", "test", "--ckpt_path",
            jax_ckpt, "--scene_name", "s", "--compute_ssim"]
    os.makedirs(tmp_path / "j", exist_ok=True)
    os.makedirs(tmp_path / "t", exist_ok=True)
    monkeypatch.chdir(tmp_path / "j")
    want_psnr = jeval.main(jeval.get_opts(argv))
    want_ssim = float(re.search(r"Mean SSIM : (\S+)",
                                capsys.readouterr().out).group(1))
    monkeypatch.chdir(tmp_path / "t")
    stats = {}
    got_psnr = teval.main(teval.get_opts(argv), device="cpu", stats=stats)
    assert abs(got_psnr - want_psnr) <= 1e-3, (got_psnr, want_psnr)
    assert abs(np.mean(stats["ssim"]) - want_ssim) <= 1e-3
    for name in ("000.png", "001.png"):
        a = np.asarray(Image.open(tmp_path / "j/results/blender/s" / name))
        b = np.asarray(Image.open(tmp_path / "t/results/blender/s" / name))
        assert a.shape == b.shape == (40, 40, 3)
        assert np.abs(a.astype(int) - b).max() <= 1


def test_entry_points_raise_without_a_card_or_a_request(scene_and_jax_ckpt,
                                                        tmp_path,
                                                        monkeypatch):
    scene, jax_ckpt = scene_and_jax_ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("NERF_FL_TORCH_DEVICE", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(topt.get_opts(["--root_dir", scene, *MODEL]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(teval.get_opts(["--root_dir", scene, *MODEL,
                                   "--ckpt_path", jax_ckpt]))


@pytest.fixture(scope="module")
def tour_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tour") / "tour")
    make_phototourism_scene(root, n_images=3, size=16, n_points=100)
    return root


@pytest.fixture(scope="module")
def refined_jax_ckpt(scene_and_jax_ckpt, tmp_path_factory):
    """A JAX checkpoint of a BARF model at epoch 5: learned deltas on the
    scene's 3 training poses."""
    from nerf_fl_tpu.data.blender import BlenderDataset as JBlender
    scene, _ = scene_and_jax_ckpt
    poses = JBlender(scene, "train", img_wh=(40, 40)).poses
    init = np.concatenate([poses, np.tile([[[0, 0, 0, 1]]], (3, 1, 1))],
                          1).astype(np.float32)
    cfg = JRenderConfig(N_samples=8, N_importance=8, encode_a=True,
                        encode_t=True, mlp_depth=2, mlp_width=32,
                        refine_pose=True)
    params = jsys.build_params(jax.random.PRNGKey(3), cfg, 8,
                               init_poses=init)
    rng = np.random.default_rng(0)
    params["learn_poses"] = {**params["learn_poses"], **{
        k: jax.numpy.asarray(rng.normal(0, 0.02, (3, 3)), np.float32)
        for k in ("r", "t")}}
    ckpt = str(tmp_path_factory.mktemp("refined") / "barf.ckpt")
    jckpt.save_checkpoint(ckpt, params, epoch=5, global_step=100)
    return ckpt


@pytest.mark.parametrize("flag,item", [
    (["--optimize_appearance", "--opt_a_steps", "5"], "A.7"),
    (["--refine_pose", "--split", "test_train"], "A.7"),
    (["--video_format", "mp4"], "A.6"), (["--save_depth"], "A.6"),
    (["--num_gpus", "2"], "A.8"), (["--dataset_name", "phototourism"],
                                   "A.6")])
def test_eval_refuses_unported_options(scene_and_jax_ckpt, tour_scene,
                                       refined_jax_ckpt, tmp_path,
                                       monkeypatch, capsys, flag, item):
    """The options of A.6 are ported and run: mp4 falls back to the GIF
    with the JAX CLI's line, --save_depth writes a PFM a frame,
    Phototourism evaluates.  Those of A.7 and A.8 are ported and give the
    JAX eval.py's PSNR within 1e-3: --optimize_appearance (each frame's
    [opt_a] line as JAX prints it, the PSNR of the right halves),
    --refine_pose on test_train from a checkpoint with learned poses at
    epoch 5, and --num_gpus 2 (two ranks, each rendering its half of every
    chunk; JAX's mesh of 2 devices), whose rank 0 alone writes."""
    scene, jax_ckpt = scene_and_jax_ckpt
    root = tour_scene if "phototourism" in flag else scene
    ckpt = refined_jax_ckpt if "--refine_pose" in flag else jax_ckpt
    args = teval.get_opts(["--root_dir", root, *MODEL, "--ckpt_path",
                           ckpt, "--scene_name", "s", "--chunk", "4096"]
                          + flag)
    if item in ("A.7", "A.8"):
        os.makedirs(tmp_path / "j")
        os.makedirs(tmp_path / "t")
        monkeypatch.chdir(tmp_path / "j")
        want = jeval.main(jeval.get_opts(
            ["--root_dir", root, *MODEL, "--ckpt_path", ckpt,
             "--scene_name", "s", "--chunk", "4096"] + flag))
        jout = capsys.readouterr().out
        monkeypatch.chdir(tmp_path / "t")
        stats = {}
        got = teval.main(args, device="cpu", stats=stats)
        tout = capsys.readouterr().out
        assert np.isfinite(got) and abs(got - want) <= 1e-3, (got, want)
        fits = [x for x in jout.splitlines() if x.startswith("[opt_a]")]
        assert fits == [x for x in tout.splitlines()
                        if x.startswith("[opt_a]")]
        if item == "A.8":
            # the ranks' own prints go to the job's file descriptors
            assert sorted(os.listdir(tmp_path / "t" / "results" / "blender"
                                     / "s")) == ["000.png", "s.gif"]
        if "--optimize_appearance" in flag:
            assert len(fits) == len(stats["psnr"]) \
                == len(stats["opt_a_losses"]) >= 1
            assert all(len(c) == 5 and c[-1] < c[0]
                       for c in stats["opt_a_losses"])
        return
    monkeypatch.chdir(tmp_path)
    assert np.isfinite(teval.main(args, device="cpu"))
    out = capsys.readouterr().out
    res = tmp_path / "results" / args.dataset_name / "s"
    files = sorted(os.listdir(res))
    if "mp4" in flag:
        assert f"[eval] mp4 writer unavailable ({teval.MP4_UNAVAILABLE}); " \
            f"writing results/blender/s/s.gif" in out
        assert files == ["000.png", "s.gif"]
    elif "--save_depth" in flag:
        assert files == ["000.png", "depth_000.pfm", "s.gif"]
    else:
        assert files == ["000.png"]        # no video for a val split
        assert "writer unavailable" not in out


def _tiny_model(vocab):
    return ["--N_samples", "8", "--N_importance", "8", "--mlp_depth", "2",
            "--mlp_width", "32", "--encode_a", "--encode_t", "--N_vocab",
            str(vocab), "--chunk", "4096"]


def test_phototourism_and_llff_train_and_eval_on_the_cpu(tmp_path,
                                                         monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    from nerf_fl_torch.data.synthetic import \
        make_llff_scene as t_make_llff
    from nerf_fl_torch.data.synthetic import \
        make_phototourism_scene as t_make_tour
    t_make_tour("tour", n_images=4, sizes=[24, 16], n_points=100)
    tprep.main(tprep.get_opts(["--root_dir", "tour", "--img_downscale",
                               "2"]))
    t_make_llff("llff", n_images=4)
    common = ["--batch_size", "128", "--num_epochs", "1", "--save_path",
              "ckpts", "--refresh_every", "0", "--steps_per_execution", "2"]
    runs = {
        "phototourism": ["--dataset_name", "phototourism", "--root_dir",
                         "tour", "--img_downscale", "2", "--use_cache"],
        "llff": ["--dataset_name", "llff", "--root_dir", "llff",
                 "--img_wh", "40", "30"]}
    # Phototourism's 5-column rays through the host-fed groups of 2
    # (stack_batches, DevicePrefetcher), LLFF's through the device pool
    pools = {"phototourism": "off", "llff": "on"}
    for name, data in runs.items():
        system = ttrain.main(topt.get_opts(data + _tiny_model(8) + common
                                           + ["--exp_name", name,
                                              "--device_pool", pools[name]]),
                             device="cpu")
        assert system.global_step > 0
        assert (system.device_pool is None) == (pools[name] == "off")
        assert (system.ray_format == "camdir") == (name == "phototourism")
        if name == "phototourism":
            poses = system.params["learn_poses"]
            assert not poses.r.requires_grad
            np.testing.assert_array_equal(
                poses.init_c2w.numpy(), system.init_poses)
            assert float(poses.r.abs().max()) == 0.0
        splits = ["val", "test_train"]
        for split in splits:
            scene = f"{name}_{split}"
            stats = {}
            teval.main(teval.get_opts(
                data + _tiny_model(8) + ["--split", split, "--ckpt_path",
                                             f"ckpts/{name}/epoch=0.ckpt",
                                             "--scene_name", scene,
                                             "--save_depth", "--video_format",
                                             "mp4"]), device="cpu",
                stats=stats)
            out = capsys.readouterr().out
            res = f"results/{name}/{scene}"
            video = name == "llff"
            assert ("mp4 writer unavailable" in out) == video
            assert os.path.exists(f"{res}/{scene}.gif") == video
            assert len(stats["depth"]) == len(stats["frame_s"]) > 0
            for i, depth in enumerate(stats["depth"]):
                back, scale = pfm.read_pfm(f"{res}/depth_{i:03d}.pfm")
                assert scale == 1.0
                np.testing.assert_array_equal(back, depth)


def test_llff_eval_of_a_jax_checkpoint_matches_jax_eval(tmp_path,
                                                        monkeypatch):
    make_llff_scene(str(tmp_path / "llff"), n_images=4)
    cfg = JRenderConfig(N_samples=8, N_importance=8, encode_a=True,
                        encode_t=True, mlp_depth=2, mlp_width=32)
    ckpt = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(ckpt, jsys.build_params(jax.random.PRNGKey(4),
                                                  cfg, 8))
    argv = ["--dataset_name", "llff", "--root_dir", str(tmp_path / "llff"),
            "--img_wh", "40", "30", *_tiny_model(8), "--split", "val",
            "--ckpt_path", ckpt, "--scene_name", "s", "--save_depth"]
    for d in ("j", "t"):
        os.makedirs(tmp_path / d)
    monkeypatch.chdir(tmp_path / "j")
    want = jeval.main(jeval.get_opts(argv))
    monkeypatch.chdir(tmp_path / "t")
    got = teval.main(teval.get_opts(argv), device="cpu")
    assert abs(got - want) <= 1e-3, (got, want)
    a, _ = pfm.read_pfm(str(tmp_path / "j/results/llff/s/depth_000.pfm"))
    b, _ = pfm.read_pfm(str(tmp_path / "t/results/llff/s/depth_000.pfm"))
    assert a.shape == b.shape == (30, 40)
    np.testing.assert_allclose(b, a, atol=1e-3)
