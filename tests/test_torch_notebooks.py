"""The port's notebook scripts (``nerf_fl_torch/notebooks/``) against the
JAX package's root ``notebooks/``, on the CPU.

  * every script answers ``--help`` as ``python -m
    nerf_fl_torch.notebooks.<name>``;
  * ``psnr_regression`` through its NeRF-W and Phototourism family
    wrappers, from a JAX checkpoint that the port reads in its own layout
    (the bridge's ``state_dict_from_jax``): every per-image PSNR the root
    notebook reports (and the masked static PSNR against the unperturbed
    ground truth) within 1e-3 dB of it, and the same grids written;
  * ``render_decomposition`` and ``appearance_interpolation`` write their
    images: the decomposition's PSNR that of psnr_regression's val view,
    the sweep's first and last frames apart.
"""
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.training import checkpoints as jckpt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch.data.image_io import read_png
from nerf_fl_torch.data.synthetic import make_phototourism_scene
from nerf_fl_torch.notebooks import (appearance_interpolation,
                                     render_decomposition, test_nerfw_all,
                                     test_phototourism)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ["psnr_regression", "test_nerfa_color", "test_nerfu_occ",
           "test_nerfw_all", "test_phototourism", "render_decomposition",
           "appearance_interpolation"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_notebook_script_help(name):
    r = subprocess.run(
        [sys.executable, "-m", f"nerf_fl_torch.notebooks.{name}", "--help"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "usage" in r.stdout.lower() and "--ckpt_path" in r.stdout


def _root_regression():
    """notebooks/psnr_regression.py of the JAX package, loaded by path."""
    sys.path.insert(0, os.path.join(ROOT, "notebooks"))
    spec = importlib.util.spec_from_file_location(
        "root_psnr_regression", os.path.join(ROOT, "notebooks",
                                             "psnr_regression.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_ckpt(path, n_vocab):
    cfg = JRenderConfig(N_samples=8, N_importance=8, encode_a=True,
                        encode_t=True)
    jckpt.save_checkpoint(path, jsys.build_params(jax.random.PRNGKey(0),
                                                  cfg, n_vocab))


@pytest.mark.parametrize("family", ["nerfw_all", "phototourism"])
def test_psnr_regression_matches_the_root_notebook(family, blender_scene,
                                                   tmp_path):
    if family == "nerfw_all":
        wrapper, n_vocab, root = test_nerfw_all, 8, blender_scene
        data = ["--root_dir", root, "--img_wh", "40", "40"]
    else:
        wrapper, n_vocab = test_phototourism, 40
        root = str(tmp_path / "tour")
        make_phototourism_scene(root, n_images=5, size=24)
        data = ["--root_dir", root, "--img_downscale", "1"]
    ckpt = str(tmp_path / "tiny.ckpt")
    _jax_ckpt(ckpt, n_vocab)
    argv = data + ["--N_samples", "8", "--N_importance", "8", "--N_vocab",
                   str(n_vocab), "--chunk", "4096", "--train_views", "1",
                   "--val_views", "0", "--ckpt_path", ckpt]
    want = _root_regression().main(
        wrapper.PRESET + argv + ["--out", str(tmp_path / "ref")])
    got = wrapper.main(argv + ["--out", str(tmp_path / "got")],
                       device="cpu")
    assert list(got) == list(want) and len(got) >= 2
    if family == "nerfw_all":
        assert "test_train[1] static PSNR (masked)" in got
    for k in want:
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-3, \
            (k, got[k], want[k])
    assert sorted(os.listdir(tmp_path / "got")) == \
        sorted(os.listdir(tmp_path / "ref"))
    for name in os.listdir(tmp_path / "got"):
        a = read_png(str(tmp_path / "got" / name)).pixels
        b = read_png(str(tmp_path / "ref" / name)).pixels
        assert a.shape == b.shape, name


def test_decomposition_and_interpolation_write_their_images(blender_scene,
                                                            tmp_path):
    ckpt = str(tmp_path / "tiny.ckpt")
    _jax_ckpt(ckpt, 8)
    model = ["--root_dir", blender_scene, "--dataset_name", "blender",
             "--img_wh", "40", "40", "--N_samples", "8", "--N_importance",
             "8", "--N_vocab", "8", "--encode_a", "--encode_t", "--chunk",
             "4096", "--ckpt_path", ckpt]
    out = tmp_path / "decomp"
    psnr = render_decomposition.main(model + ["--split", "val", "--out",
                                              str(out)], device="cpu")
    reg = test_nerfw_all.main(
        model[:-4] + ["--chunk", "4096", "--ckpt_path", ckpt,
                      "--train_views", "1", "--val_views", "0",
                      "--out", str(tmp_path / "reg")], device="cpu")
    assert psnr == reg["val[0] PSNR"]
    for name in ("pred", "depth", "gt", "static", "transient"):
        assert read_png(str(out / f"{name}.png")).pixels.shape[:2] == (40, 40)
    frames = appearance_interpolation.main(
        model + ["--split", "test_train", "--idx", "1", "--id_a", "1",
                 "--id_b", "3", "--frames", "3", "--out",
                 str(tmp_path / "interp")], device="cpu")
    assert len(frames) == 3 and frames[0].shape == (40, 40, 3)
    assert not np.array_equal(frames[0], frames[2])
    assert (tmp_path / "interp" / "interp.gif").exists()
    for f in range(3):
        assert (tmp_path / "interp" / f"interp_{f:02d}.png").exists()
