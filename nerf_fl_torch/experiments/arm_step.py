"""What a quality-gate arm's train sub-step costs at each dtype and path.

    python -m nerf_fl_torch.experiments.arm_step [--windows 5]

Builds the `full` gate's NeRF and NeRF-A arms (``tools/quality_gate.py``:
64 + 64 samples, width 256, white background, perturb 1, noise 0, batch
1024, Adam 5e-4, 8 sub-steps a call; NeRF-A adds appearance 48) on a
synthetic device pool of 2^20 rays as the gate trains them, a CUDA graph
of the device-pool step (``make_device_pool_step``), in four cases: bf16
and f32 on the fused kernels (the gate's default path) and on the plain MLP
path (``--use_pallas off``).  For each case it prints the ms a sub-step
(host clock over ``windows`` calls of 8 sub-steps after one call that
captures, each ending in a synchronize; the median) and the card time an
arm of the `full` preset's 39,060 sub-steps would take at that rate.  The
last line is one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from types import SimpleNamespace

K = 8
BATCH = 1024
POOL = 1 << 20
N_VOCAB = 100                 # the gate's training views
FULL_SUB_STEPS = 39_060       # 10 epochs of 100 views at 200 x 200 / 1024
CASES = (("bfloat16", True), ("float32", True), ("bfloat16", False),
         ("float32", False))


def sub_step_ms(dev, dtype: str, fused: bool, encode_a: bool,
                windows: int) -> float:
    import torch
    from ..render import RenderConfig
    from ..training import (build_params, epoch_perm, make_device_pool_step,
                            optimizers)
    cfg = RenderConfig(N_samples=64, N_importance=64, encode_a=encode_a,
                       N_a=48, white_back=True, perturb=1.0, noise_std=0.0,
                       compute_dtype=dtype, use_fused=None if fused else False)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_params(cfg, N_VOCAB, generator=gen, device=dev)
    d = torch.randn(POOL, 3, generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    ones = torch.ones(POOL, 1, device=dev)
    pool = {"rays": torch.cat([torch.randn(POOL, 3, generator=gen,
                                           device=dev), d, 2 * ones,
                               6 * ones], 1),
            "ts": torch.randint(0, N_VOCAB, (POOL,), generator=gen,
                                device=dev),
            "rgbs": 0.5 + 0.4 * d}
    perm = torch.from_numpy(epoch_perm(0, 0, POOL, POOL)).to(dev)
    opt = optimizers.build_optimizer(
        SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
        optimizers.trainable_parameters(
            params, optimizers.make_trainable_mask(params, False)))
    run = make_device_pool_step(cfg, opt, batch_size=BATCH,
                                steps_per_execution=K)
    g = torch.Generator(device=dev).manual_seed(7)
    run(params, pool, perm, 0, K, 5e-4, generator=g)
    times = []
    for i in range(1, windows + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(params, pool, perm, K * i, K * (i + 1), 5e-4, generator=g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3 / K)
    return statistics.median(times)


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("arm_step needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"card": card, "ms": {}}
    for encode_a, arm in ((False, "color_nerf"), (True, "color_nerfa")):
        for dtype, fused in CASES:
            name = f"{arm} {dtype} {'fused' if fused else 'plain'}"
            ms = sub_step_ms(dev, dtype, fused, encode_a, args.windows)
            out["ms"][name] = round(ms, 3)
            print(f"[arm_step] {name}: {ms:.3f} ms a sub-step, "
                  f"{ms * FULL_SUB_STEPS / 60e3:.1f} min an arm of the full "
                  f"preset", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
