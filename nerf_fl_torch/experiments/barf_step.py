"""What pose refinement adds to the graph train step, arm by arm.

    python -m nerf_fl_torch.experiments.barf_step [--windows 3]

Builds the flagship NeRF-W train step (64 + 64 samples, appearance 48,
transient 16, bf16, batch 1024, Adam 5e-4) on a synthetic device pool of
2^20 rays as a CUDA graph of K = 20 sub-steps (``make_device_pool_step``)
in four arms, each from the same weights and rays:
  * ``world``: world-space rays, no pose table (chip_smoke.py phase 6);
  * ``camdir``: camera-frame rays of 8 cameras posed in the step from the
    frozen pose table (Phototourism without refinement);
  * ``refine``: the same with the pose deltas trained in their own
    optimizer group and BARF's paper schedule at epoch 1 of 0-2;
  * ``refine_scaled``: ``refine`` with the deltas' update scaled on the
    card (``pose_lr_mult`` 0.25 after a warmup of 0.5 epoch).
For each arm it prints the sub-step's ms (host clock over ``windows``
windows of 20 sub-steps, each ending in a synchronize; the median), and
one profiled graph call (torch.profiler, quiet margins inside the
profiler on each side): its device ms and kernel count a sub-step, and
the kernels whose count a call differs from the arm before it, by name.
The last line is one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import Counter
from types import SimpleNamespace

K = 20
BATCH = 1024
POOL = 1 << 20
N_VOCAB = 1500
N_CAMS = 8
ARMS = ("world", "camdir", "refine", "refine_scaled")


def _arm(name, dev):
    """(params, run, pool, perm, epoch) of one arm."""
    import numpy as np
    import torch
    from nerf_fl_torch.render import RenderConfig
    from nerf_fl_torch.training import optimizers, system

    barf = name.startswith("refine")
    cfg = RenderConfig(N_samples=64, N_importance=64, encode_a=True,
                       encode_t=True, white_back=True, perturb=1.0,
                       noise_std=0.0, compute_dtype="bfloat16",
                       refine_pose=barf, barf_schedule="paper",
                       barf_epoch_start=0, barf_epoch_end=2)
    rng = np.random.default_rng(0)
    init = None
    if name != "world":
        init = np.tile(np.eye(4, dtype=np.float32), (N_CAMS, 1, 1))
        init[:, :3, :3] = np.linalg.qr(rng.normal(0, 1, (N_CAMS, 3, 3)))[0]
        init[:, :3, 3] = rng.normal(0, 2, (N_CAMS, 3))
    params = system.build_params(cfg, N_VOCAB, device=dev,
                                 generator=torch.Generator().manual_seed(0),
                                 init_poses=init)
    mask = optimizers.make_trainable_mask(params, barf)
    for leaf, p in optimizers.named_leaves(params):
        p.requires_grad_(mask[leaf])
    opt = optimizers.build_optimizer(
        SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
        optimizers.param_groups(params, mask))
    kw = {}
    if name != "world":
        kw = dict(ray_format="camdir")
    if name == "refine_scaled":
        kw.update(pose_lr_mult=0.25, pose_warmup_epochs=0.5)
    run = system.make_device_pool_step(cfg, opt, batch_size=BATCH,
                                       steps_per_execution=K, **kw)
    d = rng.normal(0, 1, (POOL, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 0.3, (POOL, 3)).astype(np.float32),
                           d, np.full((POOL, 2), [2.0, 6.0], np.float32)], 1)
    if name != "world":
        rays = rays[:, 3:]
    pool = {"rays": torch.from_numpy(rays).to(dev),
            "ts": torch.from_numpy(rng.integers(0, N_CAMS, POOL)).to(dev),
            "rgbs": torch.from_numpy(0.5 + 0.4 * d).to(dev)}
    perm = torch.from_numpy(system.epoch_perm(0, 0, POOL, POOL)).to(dev)
    return params, run, pool, perm, 1.0


def _profile(call):
    """(device ms, Counter of kernel names) of one call, between quiet
    margins inside the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nerf_fl_torch.training.system import PROFILE_MARGIN_S
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        call()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    ms, names = 0.0, Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False) \
                and e.self_device_time_total > 0:
            ms += e.self_device_time_total / 1e3
            names[e.key] += e.count
    return ms, names


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("barf_step: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out, prev = {}, None
    for name in ARMS:
        params, run, pool, perm, epoch = _arm(name, dev)
        i = [0]

        def call():
            i0 = i[0] % (POOL // BATCH // K) * K
            i[0] += 1
            return run(params, pool, perm, i0, POOL // BATCH, 5e-4, epoch)

        call()                                  # the capture
        torch.cuda.synchronize()
        windows = []
        for _ in range(args.windows):
            s = time.perf_counter()
            call()
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - s) * 1e3 / K)
        ms = statistics.median(windows)
        dev_ms, names = _profile(call)
        n = sum(names.values())
        out[name] = {"ms": ms, "windows": windows, "device_ms": dev_ms / K,
                     "kernels": n / K}
        print(f"[barf_step] {name}: {ms:.3f} ms a sub-step (windows "
              f"{[round(w, 3) for w in windows]}); profiled call: device "
              f"{dev_ms / K:.3f} ms and {n / K:g} kernels a sub-step")
        if prev is not None:
            diff = {k: (names[k] - prev[k]) / K for k in names | prev
                    if names[k] != prev[k]}
            for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:15]:
                print(f"[barf_step]   {v:+g} a sub-step against the arm "
                      f"before: {k[:100]}")
        prev = names
        del params, run, pool, perm
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
