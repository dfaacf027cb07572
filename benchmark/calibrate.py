"""Read a cell's correctness numbers over many seeds in one process: the
readings its limits are set from (`limits/<cell>.json`), for the program as
the configuration states it, for the control (`--compute_dtype bfloat16`,
the precision below the configuration's float32) and for planted faults.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--compute_dtype bfloat16] [--fault half_batch] [--seconds 0]

Each seed is a whole run (set-up, a window of `--seconds`, at least one
call or frame, then the check), without the trace; one JSON line a seed.
The benchmark's own runs never run it.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--compute_dtype", default=None)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    import torch
    from benchmark import run, spec
    sp = spec.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ns = argparse.Namespace(workload=args.workload, seed=seed,
                                seconds=args.seconds, trace=0)
        result, checks = run.run_cell(ns, compute_dtype=args.compute_dtype,
                                      fault=args.fault, cell_spec=sp, t0=t0)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "dtype": args.compute_dtype or sp.config["dtype"],
            "fault": args.fault, "correct": result["correct"],
            "numbers": {n: v for n, v, _ in checks},
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "detail": result["detail"],
            "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
