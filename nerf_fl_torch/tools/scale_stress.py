"""Brandenburg-shaped scale stress of the port.

The reference's headline phototourism run is brandenburg_gate: 1,363
train images at several resolutions, N_vocab 1500, trained from a prepared
ray cache.  This tool builds a synthetic COLMAP reconstruction of that
shape with the port's generator (``data/synthetic.make_phototourism_scene``:
JPEGs from the port's encoder, cameras cycling through several sizes) and
pushes it through the user's pipeline:

  1. make_phototourism_scene                         (scene generation)
  2. python -m nerf_fl_torch.prepare_phototourism    (ray cache)
  3. python -m nerf_fl_torch.train --use_cache       (training)
  4. python -m nerf_fl_torch.eval --split val        (per-image K)

and records each stage's seconds, the peak host RSS of the train process,
the steady train rays/s of its last progress line, the val PSNR, the
seconds the port's COLMAP readers take for the scene's three binaries
(points3D.bin through the native decoder, ``data/colmap_native.py``) and the seconds its JPEG decoder takes an image (a sample of
``DECODE_SAMPLE`` images) into SCALE_STRESS.json in the workdir.

Presets:
  smoke  12 images, 3 sizes, the CPU: the machinery (seconds).
  card   24 images at 504 / 376 / 300 / 600 px, downscale 2, N_vocab 1500,
         the flagship at bf16, 1 epoch, steps_per_execution 20: the card,
         in chip_smoke.py.
  full   1,363 images at those 4 sizes (brandenburg's train count): the
         card.

Usage: python -m nerf_fl_torch.tools.scale_stress --preset full
"""
import argparse
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time

from .quality_gate import child_env, parse_kernels

PRESETS = {
    "smoke": dict(n_images=12, sizes=[40, 32, 24], downscale=1,
                  batch=256, epochs=1, samples=(8, 8), vocab=100,
                  dtype="float32", platform="cpu", spe=1),
    "card": dict(n_images=24, sizes=[504, 376, 300, 600], downscale=2,
                 batch=1024, epochs=1, samples=(64, 64), vocab=1500,
                 dtype="bfloat16", platform=None, spe=20),
    # brandenburg shape: 1363 images, 4 camera resolutions, N_vocab 1500
    "full": dict(n_images=1363, sizes=[504, 376, 300, 600], downscale=2,
                 batch=1024, epochs=1, samples=(64, 64), vocab=1500,
                 dtype="bfloat16", platform=None, spe=8),
}

DECODE_SAMPLE = 16

T0 = time.perf_counter()


def log(msg):
    print(f"[scale_stress +{time.perf_counter() - T0:7.1f}s] {msg}",
          flush=True)


def run_timed(cmd, logfile, platform=None, cwd=None, timeout=7200):
    """Run a pipeline stage; return (wall_s, peak_child_rss_mb).

    RSS from resource.getrusage(RUSAGE_CHILDREN): ru_maxrss is a high-water
    mark over every reaped child, so it belongs to this stage only when it
    rises (the train stage dominates)."""
    t0 = time.perf_counter()
    with open(logfile, "w") as f:
        p = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                           cwd=cwd, env=child_env(platform), timeout=timeout)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        tail = open(logfile).read()[-3000:]
        raise RuntimeError(f"rc={p.returncode}: {' '.join(cmd)}\n{tail}")
    rss_mb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024.0
    return wall, rss_mb


def parse_last_rays_per_sec(logfile):
    txt = open(logfile).read()
    m = re.findall(r"step \d+ ([\d,]+) rays/s", txt)
    return float(m[-1].replace(",", "")) if m else None


def parse_mean_psnr(logfile):
    m = re.findall(r"Mean PSNR : ([0-9.]+)", open(logfile).read())
    return float(m[-1]) if m else None


def host_reads(root):
    """(seconds of the COLMAP reader over the scene's three binaries,
    seconds of the JPEG decoder an image, images decoded): the first
    DECODE_SAMPLE images by name."""
    from ..data.colmap import read_cameras_binary, read_images_binary
    from ..data.colmap_native import native_available, read_points3d_arrays
    from ..data.jpeg import read_jpeg
    sparse = os.path.join(root, "dense", "sparse")
    native_available()      # a first use builds the decoder: not timed
    t0 = time.perf_counter()
    read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse, "images.bin"))
    read_points3d_arrays(os.path.join(sparse, "points3D.bin"))
    colmap_s = time.perf_counter() - t0
    names = sorted(im.name for im in images.values())[:DECODE_SAMPLE]
    t0 = time.perf_counter()
    for name in names:
        read_jpeg(os.path.join(root, "dense", "images", name))
    return colmap_s, (time.perf_counter() - t0) / len(names), len(names)


def model_flags(p):
    return ["--N_vocab", str(p["vocab"]), "--encode_a", "--encode_t",
            "--beta_min", "0.1",
            "--N_samples", str(p["samples"][0]),
            "--N_importance", str(p["samples"][1]),
            "--compute_dtype", p["dtype"]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="smoke")
    ap.add_argument("--workdir", default=None,
                    help="default <tmp>/scale_stress_torch_<preset>; the "
                         "scene and its cache are kept for a re-run")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="default <workdir>/SCALE_STRESS.json")
    args = ap.parse_args(argv)
    p = PRESETS[args.preset]
    if args.epochs:
        p = dict(p, epochs=args.epochs)
    ws = os.path.abspath(args.workdir or os.path.join(
        tempfile.gettempdir(), f"scale_stress_torch_{args.preset}"))
    os.makedirs(ws, exist_ok=True)
    out_json = os.path.abspath(args.out or os.path.join(
        ws, "SCALE_STRESS.json"))
    root = os.path.join(ws, "scene")
    result = {"preset": args.preset, "n_images": p["n_images"],
              "sizes": p["sizes"], "N_vocab": p["vocab"]}
    py = [sys.executable, "-m"]

    # 1. scene generation (kept across re-runs)
    if not os.path.exists(os.path.join(root, "minitour.tsv")):
        log(f"generating {p['n_images']}-image COLMAP scene, "
            f"sizes {p['sizes']}")
        from ..data.synthetic import make_phototourism_scene
        t0 = time.perf_counter()
        make_phototourism_scene(root, n_images=p["n_images"],
                                sizes=p["sizes"])
        result["scene_gen_s"] = round(time.perf_counter() - t0, 1)
        log(f"scene generated in {result['scene_gen_s']}s")
    else:
        log("scene exists, skipping generation")

    # 2. the ray cache
    cache_marker = os.path.join(root, f"cache/rays{p['downscale']}.npy")
    if not os.path.exists(cache_marker):
        log("building ray cache (nerf_fl_torch.prepare_phototourism)")
        wall, _ = run_timed(
            py + ["nerf_fl_torch.prepare_phototourism", "--root_dir", root,
                  "--img_downscale", str(p["downscale"])],
            os.path.join(ws, "prepare.log"), platform=p["platform"], cwd=ws)
        result["cache_build_s"] = round(wall, 1)
        log(f"cache built in {wall:.1f}s")
    else:
        log("ray cache exists, skipping build")
    colmap_s, decode_s, n_decoded = host_reads(root)
    result["colmap_read_s"] = round(colmap_s, 4)
    result["jpeg_decode_s_per_image"] = round(decode_s, 4)
    log(f"COLMAP reader {colmap_s:.4f}s for the three binaries; JPEG "
        f"decoder {decode_s:.4f}s an image ({n_decoded} images)")

    # 3. training from the cache
    ck = os.path.join(ws, "ckpts")
    log(f"training {p['epochs']} epoch(s), batch {p['batch']}, "
        f"N_vocab {p['vocab']}")
    train_log = os.path.join(ws, "train.log")
    wall, rss = run_timed(
        py + ["nerf_fl_torch.train", "--dataset_name", "phototourism",
              "--root_dir", root, "--use_cache",
              "--img_downscale", str(p["downscale"])] + model_flags(p) + [
              "--noise_std", "0",
              "--num_epochs", str(p["epochs"]),
              "--batch_size", str(p["batch"]),
              "--steps_per_execution", str(p["spe"]),
              "--optimizer", "adam", "--lr", "5e-4",
              "--lr_scheduler", "cosine",
              "--save_path", ck, "--exp_name", "stress",
              "--refresh_every", "50"],
        train_log, platform=p["platform"], cwd=ws)
    result["train_wall_s"] = round(wall, 1)
    result["train_peak_rss_mb"] = round(rss, 1)
    result["train_rays_per_sec"] = parse_last_rays_per_sec(train_log)
    kernels = parse_kernels(train_log)
    if kernels:
        result["train_kernels"] = kernels
    log(f"train: {wall:.1f}s wall, peak RSS {rss:.0f} MB, "
        f"{result['train_rays_per_sec']} rays/s")

    # 4. val eval: the per-image-K path (every image has its own
    # intrinsics and size).  The test split is brandenburg's GT-less dolly
    # path, so val is the split that gives a PSNR here
    ckpt = os.path.join(ck, "stress", f"epoch={p['epochs'] - 1}.ckpt")
    eval_log = os.path.join(ws, "eval.log")
    log("eval (val split, per-image K)")
    wall, _ = run_timed(
        py + ["nerf_fl_torch.eval", "--dataset_name", "phototourism",
              "--root_dir", root, "--use_cache",
              "--img_downscale", str(p["downscale"])] + model_flags(p) + [
              "--split", "val", "--ckpt_path", ckpt,
              "--scene_name", "stress"],
        eval_log, platform=p["platform"], cwd=ws)
    result["eval_wall_s"] = round(wall, 1)
    result["eval_psnr"] = parse_mean_psnr(eval_log)
    result["total_wall_s"] = round(time.perf_counter() - T0, 1)
    with open(out_json, "w") as f:
        json.dump(result, f, indent=1)
    log(f"done — wrote {out_json}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
