"""Run one cell of the benchmark once and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (`python3 -m benchmark.run ...` works as
well).  The cell's parts are found by name (`benchmark/spec.py`).
Set-up loads the program's kernels (built into the checkout's
`nerf_fl_torch/_build/` by the first run there), makes the weights and the
inputs on the card from the seed, drives the timed path through its first
steps and warms every shape the window uses; `setup_s` runs from the
process's start to the window's.  With `--trace 0` the window runs for
`--seconds` and gives the cell's end-to-end metrics; with `--trace 1` a
profiled window of the traffic's fixed length gives its per-layer metrics.
Then the program's state is freed and the reference checks what the timed
path produced (`correct`); each number compared is printed beside its
limit on stderr and under the line's last key, `checks`.

Exits 2 without a result when no card (or too few) is present, and 1
when a module of JAX or of the JAX package is loaded once the window has
closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    # run as a file: the checkout's root holds the benchmark and the program
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nerf_fl_tpu"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def jax_modules():
    """The top-level names of JAX or the JAX package that are loaded."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(args, device=None, compute_dtype=None, fault=None,
             cell_spec=None, t0=None):
    """One run of a cell; returns (result dict, [(name, value, limit)]).
    `device` None needs the card(s) the cell asks for; the tests pass the
    CPU, `compute_dtype` and `fault` to plant the control and faults."""
    import torch
    from benchmark import spec
    imported = time.perf_counter() - (T0 if t0 is None else t0)
    sp = cell_spec or spec.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < sp.chips:
            print(f"[bench] {args.workload} needs {sp.chips} CUDA card(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            sys.exit(2)
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cell = spec.runner(sp.traffic["kind"]).Runner(
        sp, args.seed, device, compute_dtype=compute_dtype, fault=fault)
    begun = time.perf_counter() - (T0 if t0 is None else t0)
    cell.setup()
    setup_s = time.perf_counter() - (T0 if t0 is None else t0)
    stages = {"import_torch": imported, "to_setup": begun, **cell.stages}
    metrics, breakdown, dev_extra = {}, None, {}
    if args.trace:
        for _ in range(3):
            w = cell.traced()
            if w.fused_ok:
                break
            print(f"[bench] the trace kept {w.fwd_records} / "
                  f"{w.bwd_records} fused records of {w.runs} runs; "
                  "tracing again", file=sys.stderr)
        for m in sp.per_layer:
            v = spec.reader(m["name"]).read(w, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = w.breakdown()
        dev_extra = {"busy_s": w.busy_s, "window_s": w.seconds}
    else:
        got = cell.window(args.seconds)
        got["setup_s"] = setup_s
        for m in sp.end_to_end:
            metrics[m["name"]] = {"value": got[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": sp.chips,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(
                       device) if device.type == "cuda" else 0}
    device_info.update(dev_extra)
    if device.type == "cuda":
        device_info["power_limit"] = power_limit()
    cell.free()
    checks = cell.check()
    correct = all(v <= lim for _, v, lim in checks) and cell.failed == 0
    result = {"correct": correct, "attempted": cell.attempted,
              "failed": cell.failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["detail"] = {**getattr(cell, "detail", {}),
                        "setup_stages_s": stages}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def main(argv=None):
    args = parse(argv)
    result, checks = run_cell(args)
    found = jax_modules()
    if found:
        print(f"[bench] JAX modules loaded in the run: {found}",
              file=sys.stderr)
        sys.exit(1)
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
