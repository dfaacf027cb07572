"""Time the fused forward and backward kernels per launch, f32 and bf16,
at the main path's shapes, for this checkout or another one.

    python3 nerf_fl_torch/experiments/f32_kernels.py [--root DIR] [--reps 7]

Shapes: the train step's fine pass (131,072 points, appearance 48,
transient) and coarse pass (65,536 points, no appearance or transient),
forward and backward, and a render chunk (4,194,304 points, fine) forward;
the flagship's random weights and points from one seed, as chip_smoke.py's
phase 7 draws them; mip-NeRF's IPE pair (f32) at one level of the mip
cell's sub-step (524,288 points; chip_smoke.py's ``ipe_case``, its
cotangent in the four live columns), forward and backward; the sigma-only
kernel of the render's test-time coarse pass (f32) at a frame chunk's
2,097,152 coarse points and at 4,194,304; then chip_smoke.py's 400 x 400
frame (phase 3, host clock around ``render_chunked``, the median of 3) at
each dtype.  Times are CUDA events around one launch, the median of
--reps after two warm-up launches; beside each time, the sha256 of the
launch's outputs (the backward's grads and d_inp), so that two checkouts'
kernels can be held bit for bit on the same inputs.  It runs as a file so
that it can time another checkout of the port: --root DIR imports
``nerf_fl_torch`` from DIR (default: the checkout this file is in; e.g. a
``git archive`` of the parent under ``_archive/``), whose kernels it builds
there.  Prints the card's name and power limit, one line a case, and last
one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = (("fine", 131_072, 48, True, True),
          ("coarse", 65_536, 0, False, True),
          ("render_chunk", 4_194_304, 48, True, False))
SIGMA_POINTS = (2_097_152, 4_194_304)


def median_ms(fn, reps: int) -> float:
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def digest(*ts) -> str:
    """sha256 of the tensors' bytes, in order (first 16 hex digits)."""
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def frame_ms(dev, dtype: str, reps: int = 3) -> float:
    """chip_smoke.py's 400 x 400 frame of the flagship (the checkout's own
    ``frame_rays`` and weights from seed 0) at ``dtype``: ms, host clock
    around ``render_chunked`` ending in a synchronize, the median."""
    import time
    import torch
    import chip_smoke as cs
    from nerf_fl_torch.render import RenderConfig
    from nerf_fl_torch.training import build_params
    from nerf_fl_torch.training.system import render_chunked, val_chunk_cap
    cfg = RenderConfig(**{**cs.FLAGSHIP, "compute_dtype": dtype})
    params = build_params(cfg, 100, generator=torch.Generator().manual_seed(0),
                          device=dev)
    rays, ts = cs.frame_rays(dev)
    chunk = val_chunk_cap(32 * 1024, cfg.N_samples, cfg.N_importance)

    def frame():
        render_chunked(params, rays, ts, cfg, chunk=chunk, test_time=True,
                       keys=["rgb_fine", "depth_fine"])

    frame()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[len(times) // 2]


def ipe_pair(dev, gen, reps: int, out: dict, n: int = 524_288) -> None:
    """The IPE forward and backward at ``n`` points into ``out``."""
    import torch
    import chip_smoke as cs
    from nerf_fl_torch.ops import fused_mlp as fm
    inp, net, sx, sd = cs.ipe_case(dev, n, 6)
    g = torch.zeros(n, fm.OUT_W)
    g[:, :4] = torch.randn(n, 4, generator=gen)
    g = g.to(dev)
    tag = "ipe float32"
    with torch.no_grad():
        f_ms = median_ms(lambda: fm.fused_mlp_fwd_cuda(inp, net, sx, sd),
                         reps)
        f_sha = digest(fm.fused_mlp_fwd_cuda(inp, net, sx, sd))
    b_ms = median_ms(lambda: fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g),
                     reps)
    dws, dbs, _ = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    b_sha = digest(*dws, *dbs)
    out["ms"].update({f"{tag} fwd": f_ms, f"{tag} bwd": b_ms})
    out["sha256"].update({f"{tag} fwd": f_sha, f"{tag} bwd": b_sha})
    print(f"[f32_kernels] {tag} ({n} points): forward {f_ms:.3f} ms "
          f"({f_sha}), backward {b_ms:.3f} ms ({b_sha})", flush=True)


def sigma_kernel(dev, gen, reps: int, out: dict) -> None:
    """The sigma-only kernel at each of SIGMA_POINTS into ``out``: the
    coarse net (no appearance or transient) on positions in [-3, 3)."""
    import torch
    from nerf_fl_torch.models import NeRFConfig, init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm
    model = init_nerf(NeRFConfig(typ="coarse"), generator=gen).to(dev)
    net = fm.pack_weights(model, fm.Layout(torch.float32, 10, 4))
    sx, _ = fm.default_scale_rows(10, 4, 0, device=dev)
    for n in SIGMA_POINTS:
        xyz = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
        tag = f"sigma float32 {n}"
        with torch.no_grad():
            ms = median_ms(lambda: fm.fused_sigma_cuda(xyz, net, sx), reps)
            sha = digest(fm.fused_sigma_cuda(xyz, net, sx))
        out["ms"][tag] = ms
        out["sha256"][tag] = sha
        print(f"[f32_kernels] {tag} points: sigma-only {ms:.3f} ms "
              f"({sha})", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch
    from nerf_fl_torch.models import NeRFConfig, init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm
    if not fm.__file__.startswith(root):
        raise RuntimeError(f"imported {fm.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("f32_kernels needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"card": card, "root": root, "ms": {}, "sha256": {}}
    gen = torch.Generator().manual_seed(4)
    for name, n, a_dim, transient, bwd in SHAPES:
        model = init_nerf(NeRFConfig(typ="fine", encode_appearance=a_dim > 0,
                                     encode_transient=True),
                          generator=gen).to(dev)
        xyz = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
        d = torch.randn(n, 3, generator=gen)
        dirs = (d / d.norm(dim=-1, keepdim=True)).to(dev)
        a = torch.randn(n, a_dim, generator=gen).to(dev) if a_dim else None
        t = torch.randn(n, 16, generator=gen).to(dev)
        inp = fm.pack_inputs(xyz, dirs, a, t if transient else None)
        g = torch.zeros(n, fm.OUT_W)
        g[:, :9] = torch.randn(n, 9, generator=gen)
        g = g.to(dev)
        sx, sd = fm.default_scale_rows(10, 4, a_dim, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            net = fm.pack_weights(model, fm.Layout(
                dtype, 10, 4, a_dim, 16 if transient else 0))
            tag = f"{name} {str(dtype).split('.')[-1]}"
            with torch.no_grad():
                f_ms = median_ms(lambda: fm.fused_mlp_fwd_cuda(
                    inp, net, sx, sd), args.reps)
                f_sha = digest(fm.fused_mlp_fwd_cuda(inp, net, sx, sd))
            out["ms"][f"{tag} fwd"] = f_ms
            out["sha256"][f"{tag} fwd"] = f_sha
            line = (f"[f32_kernels] {tag} ({n} points): forward {f_ms:.3f} "
                    f"ms ({f_sha})")
            if bwd:
                b_ms = median_ms(lambda: fm.fused_mlp_bwd_cuda(
                    inp, net, sx, sd, g), args.reps)
                dws, dbs, d_inp = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
                b_sha = digest(*dws, *dbs, d_inp)
                out["ms"][f"{tag} bwd"] = b_ms
                out["sha256"][f"{tag} bwd"] = b_sha
                line += f", backward {b_ms:.3f} ms ({b_sha})"
            print(line, flush=True)
    ipe_pair(dev, gen, args.reps, out)
    sigma_kernel(dev, gen, args.reps, out)
    out["frame_ms"] = {d: frame_ms(dev, d) for d in ("float32", "bfloat16")}
    print(f"[f32_kernels] 400 x 400 frame: float32 "
          f"{out['frame_ms']['float32']:.1f} ms, bfloat16 "
          f"{out['frame_ms']['bfloat16']:.1f} ms", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
