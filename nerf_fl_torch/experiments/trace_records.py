"""How many of the fused kernels' runs a torch.profiler trace of the graph
train step keeps, held against the kernels' own count on the card.

    python -m nerf_fl_torch.experiments.trace_records [--calls 1 2 4]
        [--margin_ms 0 100] [--repeats 8] [--out FILE]

Builds the flagship NeRF-W train step (64 + 64 samples, appearance 48,
transient 16, bf16, batch 1024, Adam 5e-4) on a synthetic device pool of
2^20 rays as a CUDA graph of K = 20 sub-steps (``make_device_pool_step``),
captures it, then profiles windows of ``calls`` graph calls the way
``NeRFSystem.fit``'s ``--profile_dir`` window does: CPU and CUDA
activities, a synchronize before the start and before the stop, a quiet
margin of ``margin_ms`` inside the profiler on each side of the work (fit
keeps ``system.PROFILE_MARGIN_S``), one metric read back to the host
between calls, the trace exported as Chrome JSON and read back.  For each
window it prints the kernel records in the trace (all of them, and the
fused forward / backward kernels by name), the fused
kernels' runs as the kernels count them (``fused_mlp.kernel_runs``), the
fused kernels ``key_averages()`` counts, and for a trace that lacks fused
records, the sub-steps where the pattern of two forward then two backward
kernels breaks and the kernel names whose counts are not a multiple of the
window's sub-steps.  It also prints where the device records lie on the
trace's clock: the least gap from a launch call (``cuda_runtime``) to a
kernel it launched (negative: the device clock, moved onto the host's,
reads early), and the gaps from the profiler's start to the first kernel
and from the last kernel's end to its stop, with the process's age.
Kineto reports the device records it dropped as outside the window on
stderr with ``KINETO_LOG_LEVEL=1`` ("Out-of-range").  The last line is one
JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from typing import Dict, List

K = 20
BATCH = 1024
BORN = time.perf_counter()
POOL = 1 << 20
N_VOCAB = 1500


def read_trace(path: str):
    """(kernel events sorted by start, the trace's events) of a Chrome
    trace that torch.profiler exported."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e.get("ts", 0))
    return kernels, events


def fused_kind(name: str) -> str:
    if "fused_mlp_fwd_" in name:
        return "F"
    if "fused_mlp_bwd_" in name:
        return "B"
    return ""


def clock_gaps(kernels, events) -> Dict:
    """Milliseconds on the trace's clock: the least launch-to-kernel gap,
    the profiler's start to the first kernel, and the last kernel's end to
    the profiler's stop (its span is the "PyTorch Profiler" event)."""
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    lags = [(k["ts"] - launch[k["args"]["correlation"]]) / 1e3
            for k in kernels
            if k.get("args", {}).get("correlation") in launch]
    span = [e for e in events if str(e.get("name", "")).startswith(
        "PyTorch Profiler") and "dur" in e]
    out = {"least_launch_to_kernel_ms": min(lags) if lags else None}
    if span and kernels:
        t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
        out["start_to_first_kernel_ms"] = (kernels[0]["ts"] - t0) / 1e3
        out["last_kernel_to_stop_ms"] = (t1 - max(
            k["ts"] + k.get("dur", 0) for k in kernels)) / 1e3
    return out


def pattern_breaks(kernels, steps: int) -> List[int]:
    """Sub-steps (0-based, in time order) at which the fused records stop
    following F F B B a sub-step; empty when the trace holds them all."""
    seq = "".join(fused_kind(e.get("name", "")) for e in kernels)
    seq = "".join(c for c in seq if c)
    want = "FFBB" * steps
    for i, (a, b) in enumerate(zip(seq, want)):
        if a != b:
            return [i // 4]
    return [len(seq) // 4] if len(seq) != len(want) else []


def window(run, calls: int, margin_ms: float, path: str, dev) -> Dict:
    import torch
    from ..ops import fused_mlp as fm
    from torch.profiler import ProfilerActivity, profile

    runs0 = fm.kernel_runs(dev)                # synchronizes
    age = time.perf_counter() - BORN
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    time.sleep(margin_ms / 1e3)
    t0 = time.perf_counter()
    for _ in range(calls):
        m = run()
        float(m["train/loss"][-1])             # fit's log read between calls
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    time.sleep(margin_ms / 1e3)
    prof.__exit__(None, None, None)
    runs = tuple(b - a for a, b in zip(runs0, fm.kernel_runs(dev)))
    avg = Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kind = fused_kind(e.key)
            if kind:
                avg[kind] += e.count
    prof.export_chrome_trace(path)
    kernels, events = read_trace(path)
    steps = calls * K
    by_name = Counter(e.get("name", "") for e in kernels)
    ragged = {name[:80]: c for name, c in by_name.items() if c % steps}
    out = {"calls": calls, "margin_ms": margin_ms, "steps": steps,
           "seconds": seconds, "process_age_s": age,
           **clock_gaps(kernels, events),
           "kernel_records": len(kernels), "events": len(events),
           "trace_fwd": sum(fused_kind(e.get("name", "")) == "F"
                            for e in kernels),
           "trace_bwd": sum(fused_kind(e.get("name", "")) == "B"
                            for e in kernels),
           "avg_fwd": avg["F"], "avg_bwd": avg["B"],
           "runs_fwd": runs[0], "runs_bwd": runs[1],
           "breaks_at_substep": pattern_breaks(kernels, steps),
           "names_not_a_multiple": ragged}
    os.remove(path)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--margin_ms", type=float, nargs="+", default=[0, 100])
    p.add_argument("--repeats", type=int, default=8)
    p.add_argument("--out", default=None,
                   help="write the JSON result here as well")
    args = p.parse_args(argv)

    import torch
    from types import SimpleNamespace
    from ..render import RenderConfig
    from ..training import (build_params, epoch_perm, make_device_pool_step,
                            optimizers)
    if not torch.cuda.is_available():
        print("trace_records: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cfg = RenderConfig(N_samples=64, N_importance=64, encode_a=True, N_a=48,
                       encode_t=True, N_tau=16, beta_min=0.1,
                       white_back=True, perturb=1.0, noise_std=0.0,
                       compute_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_params(cfg, N_VOCAB, generator=gen, device=dev)
    o = torch.randn(POOL, 3, generator=gen, device=dev)
    d = torch.randn(POOL, 3, generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    ones = torch.ones(POOL, 1, device=dev)
    pool = {"rays": torch.cat([o, d, 2 * ones, 6 * ones], 1),
            "ts": torch.randint(0, N_VOCAB, (POOL,), generator=gen,
                                device=dev),
            "rgbs": 0.5 + 0.4 * d}
    perm = torch.from_numpy(epoch_perm(0, 0, POOL, POOL)).to(dev)
    opt = optimizers.build_optimizer(
        SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
        optimizers.trainable_parameters(
            params, optimizers.make_trainable_mask(params, False)))
    step = make_device_pool_step(cfg, opt, batch_size=BATCH,
                                 steps_per_execution=K)
    n_steps = POOL // BATCH
    at = {"i": 0}

    def run():
        i = at["i"] % (n_steps - K)
        at["i"] += K
        return step(params, pool, perm, i, n_steps, 5e-4, generator=gen)

    for _ in range(3):                          # capture and warm replays
        run()
    tmp = tempfile.mkdtemp(prefix="trace_records_")
    rows = []
    for calls in args.calls:
        for r in range(args.repeats):
            for margin in args.margin_ms:
                row = window(run, calls, margin,
                             os.path.join(tmp, "trace.json"), dev)
                rows.append(row)
                print(json.dumps(row))
    os.rmdir(tmp)
    summary = {}
    for calls, margin in ((c, m) for c in args.calls for m in args.margin_ms):
        sel = [r for r in rows if r["calls"] == calls
               and r["margin_ms"] == margin]
        summary[f"{calls} calls, margin {margin:g} ms"] = {
            "windows": len(sel),
            "trace_short": sum((r["trace_fwd"], r["trace_bwd"])
                               != (r["runs_fwd"], r["runs_bwd"])
                               for r in sel),
            "avg_short": sum((r["avg_fwd"], r["avg_bwd"])
                             != (r["runs_fwd"], r["runs_bwd"]) for r in sel),
            "runs_exact": all((r["runs_fwd"], r["runs_bwd"])
                              == (2 * r["steps"], 2 * r["steps"])
                              for r in sel),
            "kernel_records": sorted({r["kernel_records"] for r in sel})}
    result = {"graph": {"captures": step.graph.captures,
                        "replays": step.graph.replays,
                        "captured_launches": step.graph.fused_launches},
              "by_window": summary}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **result}, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
