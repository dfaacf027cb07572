#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. print the card's name and power limit, turn TF32 off, build every CUDA
     kernel under nerf_fl_torch/csrc/ (one nvcc each, in parallel);
  2. hold the fused PE + MLP forward kernel against its plain PyTorch
     version on the card: transient on/off x appearance 48/0 x bf16/f32, a
     ragged 70,001 points, plain and BARF-annealed scale rows;
  3. render a 400 x 400 Blender-style frame of the flagship NeRF-W 64+64
     model (random weights from seed 0) through render_chunked in bf16,
     count the kernel's launches, and hold the first chunk against the
     plain MLP path, with and without the transient field;
  4. time the whole frame and split one frame's device time by kernel
     (torch.profiler); time the kernel at the render chunk's 4,194,304
     points against its bound and its plain version.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Needs the nerf_fl_torch
package beside this file, a CUDA card and nvcc.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP = dict(N_samples=64, N_importance=64, encode_a=True, N_a=48,
                encode_t=True, N_tau=16, beta_min=0.1, white_back=True,
                perturb=0.0, noise_std=0.0, compute_dtype="bfloat16")
IMG = 400                      # the reference README's lego size
N_KERNEL_CHECK = 70_001        # ragged: not a multiple of the 64-point tile
F32_ATOL = 2e-4                # as tests/test_fused_mlp.py
# bf16: kernel and plain version sum the same exact products in another
# order, so a hidden value near a bf16 rounding boundary can land one ulp
# (2^-8 relative) apart and ~10 rounded layers carry that to the heads.
BF16_ATOL, BF16_RTOL = 3e-2, 2e-2
BF16_MEAN = 1e-3               # a layout fault moves the mean, not just a few
# the plain MLP path rounds at other places (xyz_final, per-ray
# conditioning), so the rendered colours agree less closely
RENDER_MAX, RENDER_MEAN = 5e-2, 5e-3

# published dense peaks (NVIDIA data sheets): bf16 tensor FLOP/s, HBM B/s
PEAKS = {"H100 SXM": (989e12, 3.35e12), "H100 PCIe": (756e12, 2.0e12),
         "H100 NVL": (835e12, 3.9e12), "H200": (989e12, 4.8e12)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def peak_for(name: str):
    if "H200" in name:
        return "H200", PEAKS["H200"]
    if "PCIe" in name:
        return "H100 PCIe", PEAKS["H100 PCIe"]
    if "NVL" in name:
        return "H100 NVL", PEAKS["H100 NVL"]
    if "H100" in name:
        return "H100 SXM", PEAKS["H100 SXM"]
    fail(f"no published peak for {name!r}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def fine_macs(cfg) -> int:
    """Multiply-adds per point of the fine MLP, unpadded."""
    W, H = cfg.mlp_width, cfg.mlp_width // 2
    x, d = cfg.in_channels_xyz, cfg.in_channels_dir + cfg.N_a * cfg.encode_a
    m = x * W + 6 * W * W + (x + W) * W          # trunk
    m += W * W + W                               # xyz_final, sigma
    m += (W + d) * H + H * 3                     # dir, rgb
    if cfg.encode_t:
        m += (W + cfg.N_tau) * H + 3 * H * H + H * 5
    return m


def cuda_ms(fn, reps: int):
    """Median and all times (ms) of ``reps`` single calls, CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], times


def make_points(n, a_dim, t_dim, gen, dev):
    import torch
    xyz = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
    d = torch.randn(n, 3, generator=gen)
    dirs = (d / d.norm(dim=-1, keepdim=True)).to(dev)
    a = torch.randn(n, a_dim, generator=gen).to(dev) if a_dim else None
    t = torch.randn(n, t_dim, generator=gen).to(dev) if t_dim else None
    return xyz, dirs, a, t


def phase_kernels(dev):
    """Kernel vs plain version in every variant; returns the errors of the
    main-path variant (bf16, transient, a_dim 48)."""
    import torch
    from nerf_fl_torch.core.encoding import barf_weights
    from nerf_fl_torch.models import NeRFConfig, init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(1)
    main_err, failures = None, []
    for a_dim in (48, 0):
        mcfg = NeRFConfig(typ="fine", encode_appearance=a_dim > 0,
                          in_channels_a=a_dim or 48, encode_transient=True)
        model = init_nerf(mcfg, generator=gen).to(dev)
        xyz, dirs, a, t = make_points(N_KERNEL_CHECK, a_dim, 16, gen, dev)
        for barf in (False, True):
            bw = (barf_weights(6.0, 10, 4, 8, device=dev),
                  barf_weights(6.0, 4, 4, 8, device=dev)) if barf \
                else (None, None)
            sx, sd = fm.default_scale_rows(10, 4, a_dim, *bw, device=dev)
            for transient in (True, False):
                inp = fm.pack_inputs(xyz, dirs, a, t if transient else None)
                for dtype in (torch.bfloat16, torch.float32):
                    net = fm.pack_weights(model, a_dim, transient, dtype,
                                          10, 4, 16)
                    kw = dict(n_freq_xyz=10, n_freq_dir=4, a_dim=a_dim,
                              t_dim=16 if transient else 0,
                              has_transient=transient, dtype=dtype)
                    got = fm.heads(fm.fused_mlp_fwd_cuda(
                        inp, net, sx, sd, **kw), transient)
                    ref = fm.heads(fm.fused_mlp_reference(
                        inp, net, sx, sd, **kw), transient)
                    torch.cuda.synchronize()
                    errs = {}
                    for k in ref:
                        diff = (got[k] - ref[k]).abs()
                        errs[k] = float(diff.max())
                        if not torch.isfinite(got[k]).all():
                            fail(f"non-finite kernel output {k}")
                        if dtype == torch.float32:
                            bad = errs[k] > F32_ATOL
                        else:
                            bad = bool((diff > BF16_ATOL + BF16_RTOL
                                        * ref[k].abs()).any()) \
                                or float(diff.mean()) > BF16_MEAN
                        if bad:
                            failures.append(f"kernel != plain: {k} a_dim={a_dim} "
                                 f"barf={barf} transient={transient} "
                                 f"{dtype}: max {errs[k]:.3e} mean "
                                 f"{float(diff.mean()):.3e}")
                    name = str(dtype).split(".")[-1]
                    print(f"[kernel] a_dim={a_dim:2d} barf={barf!s:5} "
                          f"transient={transient!s:5} {name:8s} max_abs_err "
                          + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
                    if (a_dim, transient, dtype, barf) == (
                            48, True, torch.bfloat16, False):
                        main_err = max(errs.values())
    if failures:
        fail("\n".join(failures))
    return main_err


def frame_rays(dev):
    """400 x 400 rays of a camera on a radius-4 sphere looking at the
    origin, Blender focal, near 2, far 6."""
    import numpy as np
    import torch
    from nerf_fl_torch.core.rays import get_ray_directions, get_rays

    focal = 0.5 * IMG / math.tan(0.5 * 0.6911112)
    K = np.array([[focal, 0, IMG / 2], [0, focal, IMG / 2], [0, 0, 1]],
                 np.float32)
    eye = 4.0 * np.array([1.0, -1.0, 0.8]) / np.linalg.norm([1.0, -1.0, 0.8])
    z = eye / np.linalg.norm(eye)                 # camera looks down -z
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = torch.tensor(np.stack([x, y, z, eye], 1), dtype=torch.float32,
                       device=dev)
    o, d = get_rays(get_ray_directions(IMG, IMG, K, device=dev), c2w)
    n = o.shape[0]
    near = torch.full((n, 1), 2.0, device=dev)
    far = torch.full((n, 1), 6.0, device=dev)
    return torch.cat([o, d, near, far], 1), torch.zeros(n, dtype=torch.int64,
                                                         device=dev)


def phase_render(dev):
    import numpy as np
    import torch
    from dataclasses import replace
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.render import RenderConfig, render_rays
    from nerf_fl_torch.training import build_params, metrics
    from nerf_fl_torch.training.system import render_chunked, val_chunk_cap

    cfg = RenderConfig(**FLAGSHIP)
    params = build_params(cfg, 100, generator=torch.Generator().manual_seed(0),
                          device=dev)
    rays, ts = frame_rays(dev)
    n = rays.shape[0]
    chunk = val_chunk_cap(32 * 1024, cfg.N_samples, cfg.N_importance)
    keys = ["rgb_fine", "depth_fine"]

    def frame():
        return render_chunked(params, rays, ts, cfg, chunk=chunk,
                              test_time=True, keys=keys)

    # the main path: counts at 0 just before, read just after
    fm.fused_mlp_fwd_cuda.launches = 0
    out = frame()
    launches = fm.fused_mlp_fwd_cuda.launches
    expect = -(-n // chunk)
    print(f"[render] {IMG}x{IMG} frame, chunk {chunk}: fused kernel "
          f"launches {launches} (expected {expect})")
    rgb = out["rgb_fine"]
    if rgb.shape != (n, 3) or out["depth_fine"].shape != (n,):
        fail(f"bad output shapes {rgb.shape} {out['depth_fine'].shape}")
    if not (np.isfinite(rgb).all() and np.isfinite(out["depth_fine"]).all()):
        fail("non-finite frame")
    if launches != expect:
        fail(f"fused kernel launched {launches} times, expected {expect}")

    # first chunk again through the plain MLP path, with and without the
    # transient field (phototourism test renders disable it)
    r0, t0 = rays[:chunk], ts[:chunk]
    with torch.no_grad():
        for transient in (True, False):
            fused = render_rays(params, r0, t0, cfg, test_time=True,
                                output_transient=transient)["rgb_fine"]
            plain = render_rays(params, r0, t0,
                                replace(cfg, use_fused=False),
                                test_time=True,
                                output_transient=transient)["rgb_fine"]
            diff = (fused - plain).abs()
            p = float(metrics.psnr(fused, plain))
            print(f"[render] first chunk, transient={transient}: fused vs "
                  f"plain rgb_fine max {float(diff.max()):.3e} mean "
                  f"{float(diff.mean()):.3e} psnr {p:.2f} dB")
            if transient:
                if float(diff.max()) > RENDER_MAX \
                        or float(diff.mean()) > RENDER_MEAN:
                    fail("fused render disagrees with the plain path")
                if np.abs(fused.cpu().numpy() - rgb[:chunk]).max() > 1e-5:
                    fail("chunk re-render differs from the frame")
            elif float(diff.max()) > RENDER_MAX \
                    or float(diff.mean()) > RENDER_MEAN:
                fail("fused render (no transient) disagrees with the plain "
                     "path")

    # frame time, host clock around a render that ends in a readback
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        s = time.perf_counter()
        frame()
        times.append((time.perf_counter() - s) * 1e3)
    frame_ms = sorted(times)[1]
    print(f"[render] frame ms {frame_ms:.1f} (runs {[round(t, 1) for t in times]}), "
          f"rays/s {n / frame_ms * 1e3:.0f}")
    profile_frame(frame)
    return launches, cfg


def profile_frame(frame):
    """Device time of one frame by kernel (torch.profiler), and the share
    of the frame's wall time in which the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        frame()
        wall_ms = (time.perf_counter() - s) * 1e3
    # device-side events only: an aten op also carries its kernels' time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        print("[profile] the profiler saw no device time: not measured")
        return
    print(f"[profile] one frame: device busy {busy_ms:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({100 * busy_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"[profile] {ms:9.2f} ms {100 * ms / busy_ms:5.1f}% "
              f"x{count:<4d} {key[:90]}")


def phase_timing(dev, cfg, smi_name):
    import torch
    from nerf_fl_torch.models import init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm

    n = 32 * 1024 * (cfg.N_samples + cfg.N_importance)     # 4,194,304
    gen = torch.Generator().manual_seed(2)
    model = init_nerf(cfg.nerf_config("fine"), generator=gen).to(dev)
    xyz, dirs, a, t = make_points(n, cfg.N_a, cfg.N_tau, gen, dev)
    inp = fm.pack_inputs(xyz, dirs, a, t)
    del xyz, dirs, a, t
    dtype = cfg.dtype
    net = fm.pack_weights(model, cfg.N_a, True, dtype, cfg.N_emb_xyz,
                          cfg.N_emb_dir, cfg.N_tau)
    sx, sd = fm.default_scale_rows(cfg.N_emb_xyz, cfg.N_emb_dir, cfg.N_a,
                                   device=dev)
    kw = dict(n_freq_xyz=cfg.N_emb_xyz, n_freq_dir=cfg.N_emb_dir,
              a_dim=cfg.N_a, t_dim=cfg.N_tau, has_transient=True, dtype=dtype)
    with torch.no_grad():
        for _ in range(2):                                   # warm up
            fm.fused_mlp_fwd_cuda(inp, net, sx, sd, **kw)
        k_ms, k_all = cuda_ms(lambda: fm.fused_mlp_fwd_cuda(
            inp, net, sx, sd, **kw), 7)
        fm.fused_mlp_reference(inp, net, sx, sd, **kw)
        p_ms, p_all = cuda_ms(lambda: fm.fused_mlp_reference(
            inp, net, sx, sd, **kw), 5)
    flops = 2.0 * fine_macs(cfg) * n
    w_bytes = sum(w.numel() * w.element_size() for w in net.ws) \
        + sum(b.numel() * 4 for b in net.bs)
    n_bytes = inp.numel() * 4 + n * fm.OUT_W * 4 + w_bytes + 2 * 128 * 4
    part, (peak_flops, peak_bw) = peak_for(smi_name)
    t_ops, t_bytes = flops / peak_flops * 1e3, n_bytes / peak_bw * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[timing] fused_mlp_fwd bf16 at {n} points: {k_ms:.3f} ms/launch "
          f"(runs {[round(x, 3) for x in k_all]}); plain {p_ms:.3f} ms "
          f"(runs {[round(x, 3) for x in p_all]})")
    print(f"[timing] work {flops / 1e12:.3f} TFLOP, {n_bytes / 1e9:.3f} GB; "
          f"bound {bound_ms:.3f} ms by {bound_by} at {part} peaks "
          f"({peak_flops / 1e12:.0f} TFLOP/s bf16, {peak_bw / 1e12:.2f} TB/s);"
          f" {flops / k_ms / 1e9:.1f} TFLOP/s achieved = "
          f"{100 * bound_ms / k_ms:.1f}% of bound")
    return k_ms, p_ms, bound_ms, bound_by


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "nerf_fl_torch")):
        print("chip_smoke: the nerf_fl_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from nerf_fl_torch.ops import _build
    from nerf_fl_torch.ops import fused_mlp as fm

    smi = nvidia_smi()
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.build(_build.sources())
    print(f"[build] {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log("fused_mlp_fwd").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("[ptxas]", line.strip())

    max_err = phase_kernels(dev)
    launches, cfg = phase_render(dev)
    k_ms, p_ms, bound_ms, bound_by = phase_timing(dev, cfg, smi.split(",")[0])

    kernels = [{
        "name": "fused_mlp_fwd", "route": "cuda",
        "source": "nerf_fl_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerf_fl_tpu/ops/fused_mlp.py:319",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
