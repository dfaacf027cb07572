"""The port's scale stress (``nerf_fl_torch/tools/scale_stress.py``) at its
``smoke`` preset on the CPU: a synthetic COLMAP scene of three camera
sizes, its ray cache from ``python -m nerf_fl_torch.prepare_phototourism``,
training from the cache and the per-image-K val render, the stages'
seconds, RSS and rays/s, and the artifact in the workdir (never the root
SCALE_STRESS.json, the JAX package's record)."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_scale_stress_smoke_runs_the_pipeline(tmp_path):
    root_artifact = open(os.path.join(ROOT, "SCALE_STRESS.json"), "rb").read()
    ws = tmp_path / "ws"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run(
        [sys.executable, "-m", "nerf_fl_torch.tools.scale_stress",
         "--preset", "smoke", "--workdir", str(ws)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    res = json.loads((ws / "SCALE_STRESS.json").read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == res
    assert res["n_images"] == 12 and res["sizes"] == [40, 32, 24]
    assert res["scene_gen_s"] >= 0 and res["cache_build_s"] > 0
    assert res["colmap_read_s"] > 0 and res["jpeg_decode_s_per_image"] > 0
    assert res["train_wall_s"] > 0 and res["train_peak_rss_mb"] > 0
    assert res["train_rays_per_sec"] and res["train_rays_per_sec"] > 0
    assert "train_kernels" not in res            # no card
    assert res["eval_psnr"] is not None and res["eval_psnr"] > 5
    assert (ws / "scene" / "cache" / "rays1.npy").exists()
    assert open(os.path.join(ROOT, "SCALE_STRESS.json"),
                "rb").read() == root_artifact
