"""Summarize the Chrome trace that ``python -m nerf_fl_torch.train
--profile_dir DIR`` writes (``DIR/trace.json``, a torch.profiler window of
fit's steps) into a table of device kernel time by name.

    python -m nerf_fl_torch.tools.profile_trace --trace_dir DIR \\
        [--steps 20] [--top 40]

``--trace_dir`` is the profile directory (searched recursively for
``trace.json``, the newest wins) or the trace file itself.  It prints the
kernels' summed time a step (``--steps``: the steps the window holds,
which the train log's ``[profiler] trace of N steps`` line gives), the
busy union of the window (the union of the kernels' intervals over the
span from the first kernel's start to the last one's end) and, for the
``--top`` kernels by time, each one's time and count a step; the fused
NeRF kernels are marked F (forward) and B (backward).  The JAX tool's
``--hlo`` join of fusions to source files has no counterpart here: a CUDA
kernel carries its own name, and the port has no compiled module to join.
"""
from __future__ import annotations

import argparse
import glob
import os
from collections import defaultdict
from typing import Dict, List

from ..experiments.trace_records import fused_kind, read_trace


def find_trace(path: str) -> str:
    """The trace file: ``path`` itself, or the newest ``trace.json`` under
    the directory ``path``."""
    if os.path.isfile(path):
        return path
    files = glob.glob(os.path.join(path, "**", "trace.json"), recursive=True)
    if not files:
        raise SystemExit(f"no trace.json under {path}")
    return max(files, key=os.path.getmtime)


def busy_union(kernels: List[dict]):
    """(busy microseconds, span microseconds): the union of the kernels'
    [ts, ts + dur) intervals and the span from the first start to the last
    end."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in kernels)
    if not spans:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in spans) - spans[0][0]


def summarize(path: str) -> Dict:
    """The window's kernels: total, busy union and span (microseconds),
    time and count by name, and the fused forward / backward counts."""
    kernels, _ = read_trace(path)
    agg, cnt = defaultdict(float), defaultdict(int)
    for e in kernels:
        agg[e.get("name", "?")] += e.get("dur", 0)
        cnt[e.get("name", "?")] += 1
    busy, span = busy_union(kernels)
    return {"trace": path, "kernels": len(kernels),
            "total_us": sum(agg.values()), "busy_us": busy, "span_us": span,
            "busy_share": busy / span if span else 0.0,
            "fused_fwd": sum(c for n, c in cnt.items()
                             if fused_kind(n) == "F"),
            "fused_bwd": sum(c for n, c in cnt.items()
                             if fused_kind(n) == "B"),
            "by_name": {n: (agg[n], cnt[n]) for n in agg}}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trace_dir", required=True,
                   help="the --profile_dir of a train run, or its trace")
    p.add_argument("--steps", type=int, default=1,
                   help="number of steps captured (divides totals)")
    p.add_argument("--top", type=int, default=40)
    args = p.parse_args(argv)

    res = summarize(find_trace(args.trace_dir))
    s = max(args.steps, 1)
    print(f"trace {res['trace']}: {res['kernels']} kernels")
    print(f"device kernel total: {res['total_us'] / 1e3 / s:.3f} ms/step "
          f"({s} steps); busy union {res['busy_us'] / 1e3:.3f} ms of the "
          f"{res['span_us'] / 1e3:.3f} ms span: "
          f"{100 * res['busy_share']:.1f}% busy")
    print(f"fused kernels: forward {res['fused_fwd']}, backward "
          f"{res['fused_bwd']} ({res['fused_fwd'] / s:g} + "
          f"{res['fused_bwd'] / s:g} a step)")
    print(f"\ntop {args.top} device kernels (ms/step, count/step):")
    rows = sorted(res["by_name"].items(), key=lambda kv: -kv[1][0])
    for n, (us, c) in rows[:args.top]:
        print(f"  {us / 1e3 / s:9.3f} x{c / s:<6g} {fused_kind(n) or ' '} "
              f"{n[:100]}")
    return res


if __name__ == "__main__":
    main()
