"""Package rules of nerf_fl_torch: no JAX, no silent CPU fallback."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import pkgutil, sys
import nerf_fl_torch
for m in pkgutil.walk_packages(nerf_fl_torch.__path__, "nerf_fl_torch."):
    __import__(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "optax",
                                            "nerf_fl_tpu")))
print("MODULES", " ".join(sorted(m for m in sys.modules
                                  if m.startswith("nerf_fl_torch"))))
print("BAD", bad)
"""

# every module of the port, so a new one cannot slip past the rule
PORT_MODULES = {
    "nerf_fl_torch", "nerf_fl_torch.bridge", "nerf_fl_torch.device",
    "nerf_fl_torch.core", "nerf_fl_torch.core.compositing",
    "nerf_fl_torch.core.encoding", "nerf_fl_torch.core.rays",
    "nerf_fl_torch.core.sampling", "nerf_fl_torch.data",
    "nerf_fl_torch.data.sampler", "nerf_fl_torch.data.blender",
    "nerf_fl_torch.data.image_io", "nerf_fl_torch.data.perturbations",
    "nerf_fl_torch.data.rays_np", "nerf_fl_torch.data.synthetic",
    "nerf_fl_torch.data.jpeg", "nerf_fl_torch.data.pfm",
    "nerf_fl_torch.data.llff", "nerf_fl_torch.data.colmap",
    "nerf_fl_torch.data.phototourism", "nerf_fl_torch.prepare_phototourism",
    "nerf_fl_torch.data.colmap_native", "nerf_fl_torch.tools.build_native",
    "nerf_fl_torch.experiments.appearance_codes",
    "nerf_fl_torch.core.lie", "nerf_fl_torch.models.poses",
    "nerf_fl_torch.eval", "nerf_fl_torch.opt", "nerf_fl_torch.train",
    "nerf_fl_torch.utils", "nerf_fl_torch.utils.cli",
    "nerf_fl_torch.utils.visualization", "nerf_fl_torch.models",
    "nerf_fl_torch.models.embeddings", "nerf_fl_torch.models.mlp",
    "nerf_fl_torch.experiments", "nerf_fl_torch.experiments.kernel_anatomy",
    "nerf_fl_torch.experiments.kernel_anatomy2",
    "nerf_fl_torch.experiments.chain_ablation",
    "nerf_fl_torch.experiments.fused_ablation",
    "nerf_fl_torch.experiments.pe_ablation",
    "nerf_fl_torch.experiments.probe_timing",
    "nerf_fl_torch.experiments.sass_diff",
    "nerf_fl_torch.experiments.sin_ablation",
    "nerf_fl_torch.experiments.trace_records",
    "nerf_fl_torch.experiments.barf_step",
    "nerf_fl_torch.experiments.quality_seeds",
    "nerf_fl_torch.experiments.arm_step",
    "nerf_fl_torch.experiments.tp_layout",
    "nerf_fl_torch.experiments.relu_ties",
    "nerf_fl_torch.experiments.f32_kernels",
    "nerf_fl_torch.ops", "nerf_fl_torch.ops._build",
    "nerf_fl_torch.ops.anatomy", "nerf_fl_torch.ops.fused_mlp", "nerf_fl_torch.ops.sorting",
    "nerf_fl_torch.ops.f32_ties",
    "nerf_fl_torch.render", "nerf_fl_torch.render.renderer",
    "nerf_fl_torch.render.appearance",
    "nerf_fl_torch.training", "nerf_fl_torch.training.losses",
    "nerf_fl_torch.training.metrics", "nerf_fl_torch.training.optimizers",
    "nerf_fl_torch.training.system", "nerf_fl_torch.training.checkpoints",
    "nerf_fl_torch.training.logging",
    "nerf_fl_torch.tools", "nerf_fl_torch.tools.quality_gate",
    "nerf_fl_torch.tools.make_fixture", "nerf_fl_torch.tools.save_weights_only",
    "nerf_fl_torch.tools.gen_nerf_tsv", "nerf_fl_torch.tools.profile_trace",
    "nerf_fl_torch.tools.scale_stress", "nerf_fl_torch.notebooks",
    "nerf_fl_torch.notebooks.psnr_regression",
    "nerf_fl_torch.notebooks.test_nerfa_color",
    "nerf_fl_torch.notebooks.test_nerfu_occ",
    "nerf_fl_torch.notebooks.test_nerfw_all",
    "nerf_fl_torch.notebooks.test_phototourism",
    "nerf_fl_torch.notebooks.render_decomposition",
    "nerf_fl_torch.notebooks.appearance_interpolation",
    "nerf_fl_torch.parallel", "nerf_fl_torch.parallel.mesh",
    "nerf_fl_torch.parallel.multihost", "nerf_fl_torch.parallel.launch",
}


def test_imports_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    loaded = set(out.stdout.split("MODULES")[1].split("BAD")[0].split())
    assert PORT_MODULES <= loaded, sorted(PORT_MODULES - loaded)


def test_entry_points_raise_without_cuda(monkeypatch):
    from nerf_fl_torch import resolve_device
    from nerf_fl_torch.render import RenderConfig
    from nerf_fl_torch.training import build_params
    from nerf_fl_torch.training.system import render_chunked

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(N_samples=4, N_importance=4, mlp_depth=4,
                       mlp_width=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_params(cfg, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    params = build_params(cfg, 3, device="cpu")
    rays = np.zeros((4, 8), np.float32)
    rays[:, 5], rays[:, 6], rays[:, 7] = -1, 2, 6
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_chunked(params, rays, np.zeros(4, np.int32), cfg)
    out = render_chunked(params, rays, np.zeros(4, np.int32), cfg,
                         device="cpu")
    assert out["rgb_fine"].shape == (4, 3)


def test_fused_wrapper_on_cpu_does_not_launch():
    from nerf_fl_torch.models import NeRFConfig, init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm

    model = init_nerf(NeRFConfig(typ="fine", encode_appearance=True,
                                 encode_transient=True),
                      generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = [torch.randn(37, c, generator=g) for c in (3, 3, 48, 16)]
    before = fm.fused_mlp_fwd_cuda.launches
    out = fm.fused_apply_nerf(model, fm.Layout(torch.bfloat16, 10, 4, 48, 16),
                              *x)
    assert fm.fused_mlp_fwd_cuda.launches == before == 0
    assert out["static_rgb"].shape == (37, 3)
    assert torch.isfinite(out["transient_beta"]).all()


def test_chip_smoke_refuses_without_the_package(tmp_path):
    """Alone in a directory, the script exits non-zero and prints no
    result line."""
    src = os.path.join(ROOT, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    out = subprocess.run([sys.executable, str(dst)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# the libraries the port does without, and the JAX side
_BLOCKED = ("PIL", "pandas", "imageio", "cv2", "flax", "msgpack",
            "tensorboard", "jax", "jaxlib", "optax", "nerf_fl_tpu")

_TRAIN_EVAL_BLOCKED = r"""
import os, sys
for name in BLOCKED:
    sys.modules[name] = None
from nerf_fl_torch.data.synthetic import make_blender_scene
from nerf_fl_torch import eval as ev, opt, train
make_blender_scene("scene", n_train=2, n_val=1, n_test=1, size=24)
model = ["--root_dir", "scene", "--img_wh", "24", "24", "--N_samples", "4",
         "--N_importance", "4", "--mlp_depth", "2", "--mlp_width", "16",
         "--encode_a", "--encode_t", "--N_vocab", "4"]
train.main(opt.get_opts(model + ["--batch_size", "128", "--num_epochs", "1",
                                 "--save_path", "ckpts", "--exp_name", "b",
                                 "--refresh_every", "0"]), device="cpu")
psnr = ev.main(ev.get_opts(model + ["--ckpt_path", "ckpts/b/epoch=0.ckpt",
                                    "--split", "test", "--compute_ssim"]),
               device="cpu")
barf = ["--refine_pose", "--barf_schedule", "paper"]
train.main(opt.get_opts(model + barf + [
    "--batch_size", "128", "--num_epochs", "1", "--save_path", "ckpts",
    "--exp_name", "barf", "--refresh_every", "0", "--pose_noise", "1", "0.01",
    "--pose_lr_mult", "2", "--pose_warmup_epochs", "0.5",
    "--steps_per_execution", "2"]), device="cpu")
for extra in (barf + ["--split", "test_train"],
              ["--optimize_appearance", "--opt_a_steps", "2",
               "--opt_a_rays", "64", "--split", "test"]):
    ev.main(ev.get_opts(model + extra + [
        "--ckpt_path", "ckpts/barf/epoch=0.ckpt", "--scene_name", "barf"]),
        device="cpu")
from nerf_fl_torch import prepare_phototourism as prep
from nerf_fl_torch.data import colmap_native
from nerf_fl_torch.data.synthetic import (make_llff_scene,
                                          make_phototourism_scene)
from nerf_fl_torch.tools import build_native
build_native.main([])
assert colmap_native.native_available()
make_phototourism_scene("tour", n_images=3, sizes=[20, 16], n_points=60)
prep.main(prep.get_opts(["--root_dir", "tour", "--img_downscale", "2"]))
make_llff_scene("llff", n_images=3)
small = model[5:] + ["--chunk", "2048"]
for name, data in (("phototourism", ["--root_dir", "tour",
                                     "--img_downscale", "2", "--use_cache"]),
                   ("llff", ["--root_dir", "llff", "--img_wh", "40", "30"])):
    data = ["--dataset_name", name] + data
    train.main(opt.get_opts(data + small + [
        "--batch_size", "128", "--num_epochs", "1", "--save_path", "ckpts",
        "--exp_name", name, "--refresh_every", "0"]), device="cpu")
    ev.main(ev.get_opts(data + small + [
        "--ckpt_path", f"ckpts/{name}/epoch=0.ckpt", "--split", "val",
        "--save_depth", "--video_format", "mp4", "--scene_name", name]),
        device="cpu")
from nerf_fl_torch.notebooks import test_phototourism as nb_tour
from nerf_fl_torch.tools import gen_nerf_tsv, quality_gate as qg
from nerf_fl_torch.tools import save_weights_only
gen_nerf_tsv.main(["--root_dir", "tour", "--out", "tour.tsv",
                   "--n_test", "1", "--dataset_name", "minitour"])
slim = save_weights_only.main(["--ckpt_path",
                               "ckpts/phototourism/epoch=0.ckpt"])
# the notebooks build the flagship width: a weights-only checkpoint of it
from nerf_fl_torch.render import RenderConfig
from nerf_fl_torch.training import build_params, checkpoints
checkpoints.save_checkpoint("wide.ckpt", build_params(RenderConfig(
    N_samples=4, N_importance=4, encode_a=True, encode_t=True), 100,
    device="cpu"))
nb_tour.main(["--root_dir", "tour", "--img_downscale", "2", "--N_samples",
              "4", "--N_importance", "4", "--chunk", "512", "--ckpt_path",
              "wide.ckpt", "--out", "nb"], device="cpu")
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in BLOCKED)
print("PSNR", psnr, "BAD", bad)
"""

# the quality gate's smoke preset: each arm's train and eval commands, as
# the gate's children run them
_GATE_ARMS_BLOCKED = r"""
import sys
for name in BLOCKED:
    sys.modules[name] = None
from nerf_fl_torch import eval as ev, opt, train
from nerf_fl_torch.tools import quality_gate as qg
p = qg.PRESETS["smoke"]
scene = qg.ensure_fixture("qg", p)
for name, perturb, flags in qg.ARMS:
    train.main(opt.get_opts(qg.train_argv("qg", scene, p, name, perturb,
                                          flags)), device="cpu")
    extras = [((), name)] + ([(qg.OPTA[2], qg.OPTA[1])]
                             if name == qg.OPTA[0] else [])
    for extra, ev_name in extras:
        ev.main(ev.get_opts(qg.eval_argv("qg", scene, p, name, flags, extra,
                                         ev_name)), device="cpu")
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in BLOCKED)
print("BAD", bad)
"""


def test_train_and_eval_need_none_of_the_missing_libraries(tmp_path):
    """Train and eval (Blender, Blender with BARF pose refinement on noisy
    poses and its eval with --refine_pose and with --optimize_appearance,
    then Phototourism from the ray cache that prepare_phototourism writes,
    then LLFF, with --save_depth and mp4), the tools build_native (the
    COLMAP decoder that the Phototourism dataset then reads through),
    gen_nerf_tsv and save_weights_only, and a notebook (the Phototourism
    PSNR regression) on the CPU in a process where PIL, pandas, imageio, cv2, flax,
    msgpack, tensorboard, jax and the JAX package cannot be imported: they
    need only torch, numpy and the standard library."""
    code = f"BLOCKED = {_BLOCKED!r}\n" + _TRAIN_EVAL_BLOCKED
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout[-2000:]
    assert "JSONL only" in out.stdout
    assert "[pose_noise] injected rot" in out.stdout
    assert "[opt_a] frame 0: fit mse" in out.stdout
    assert "built " in out.stdout and "[colmap]" not in out.stdout
    assert (tmp_path / "results" / "blender" / "test" / "test.gif").exists()
    assert (tmp_path / "tour" / "cache" / "rays2.npy").exists()
    for name in ("phototourism", "llff"):
        assert (tmp_path / "results" / name / name / "depth_000.pfm") \
            .exists()
    assert (tmp_path / "results" / "llff" / "llff" / "llff.gif").exists()
    assert (tmp_path / "tour.tsv").read_bytes() == \
        (tmp_path / "tour" / "minitour.tsv").read_bytes()
    assert (tmp_path / "ckpts" / "phototourism" /
            "epoch=0_weights.ckpt").exists()
    assert "val[0] PSNR between GT and pred" in out.stdout


QG_ARMS = ("clean", "color_nerf", "color_nerfa", "occ_nerf", "occ_nerfu",
           "co_nerf", "co_nerfw")


def test_quality_gate_arms_need_none_of_the_missing_libraries(tmp_path):
    """Every arm's train and eval commands of the quality gate's smoke
    preset (the port's CLIs, as the gate's children run them) in a process
    where those libraries cannot be imported; one thread (the test runs
    beside the suite's other workers)."""
    code = f"BLOCKED = {_BLOCKED!r}\n" + _GATE_ARMS_BLOCKED
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT,
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout[-2000:]
    for name in QG_ARMS:
        assert (tmp_path / "qg" / "ckpts" / name / "epoch=0.ckpt").exists()
    assert (tmp_path / "results" / "blender" / "co_nerfw_opta").is_dir()


def test_parallel_ranks_need_none_of_the_missing_libraries(tmp_path):
    """``--num_gpus 2`` train and eval on the CPU, whose two ranks are
    spawned processes of their own: the blocked libraries are stand-in
    packages on PYTHONPATH that raise on import, so the ranks inherit the
    block (a parent's ``sys.modules`` does not reach a spawned child)."""
    stubs = tmp_path / "stubs"
    for name in _BLOCKED:
        (stubs / name).mkdir(parents=True)
        (stubs / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    code = r"""
from nerf_fl_torch.data.synthetic import make_blender_scene
from nerf_fl_torch import eval as ev, opt, train
make_blender_scene("scene", n_train=2, n_val=1, n_test=1, size=24)
model = ["--root_dir", "scene", "--img_wh", "24", "24", "--N_samples", "4",
         "--N_importance", "4", "--mlp_depth", "2", "--mlp_width", "16",
         "--encode_a", "--encode_t", "--N_vocab", "4", "--num_gpus", "2"]
train.main(opt.get_opts(model + ["--batch_size", "128", "--num_epochs", "1",
                                 "--save_path", "ckpts", "--exp_name", "b",
                                 "--refresh_every", "0",
                                 "--steps_per_execution", "2"]),
           device="cpu")
psnr = ev.main(ev.get_opts(model + ["--ckpt_path", "ckpts/b/epoch=0.ckpt",
                                    "--split", "test"]), device="cpu")
print("PSNR", psnr)
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": f"{stubs}:{ROOT}",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PSNR" in out.stdout and "JSONL only" in out.stdout
    assert (tmp_path / "ckpts" / "b" / "epoch=0.ckpt").exists()
