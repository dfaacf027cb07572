"""The traced run: a torch.profiler window over whole calls, read back into
kernel records, the busy union, and the breakdown the result line carries.

The window synchronizes the card, sleeps a quiet margin inside the profiler
on each side of the work, and holds the trace's fused-kernel records
against the kernels' own count of their runs (`fused_mlp.kernel_runs`): a
profiler whose device clock, moved onto the host's, reads early or late
drops records at the window's edges, and the margin is what kept them.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

MARGIN_S = 0.1          # the program's PROFILE_MARGIN_S
WINDOW_SPAN = "benchmark.window"

FWD = re.compile(r"fused_mlp_fwd_")
BWD_MAIN = re.compile(r"fused_mlp_bwd_")
BWD = re.compile(r"fused_mlp_bwd_|wgrad_|reduce_dw|reduce_db")
GEMM = re.compile(r"gemm|gemv|cutlass|xmma", re.IGNORECASE)


def merged(kernels: List[dict]) -> List[Tuple[float, float]]:
    """The kernels' [ts, ts + dur) intervals merged where they overlap, in
    order."""
    out: List[List[float]] = []
    for s, e in sorted((k["ts"], k["ts"] + k.get("dur", 0))
                       for k in kernels):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_union(kernels: List[dict]) -> Tuple[float, float]:
    """(busy microseconds, span microseconds): the union of the kernels'
    intervals, and the span from the first start to the last end
    (`nerf_fl_torch/tools/profile_trace.py:busy_union`'s arithmetic)."""
    m = merged(kernels)
    if not m:
        return 0.0, 0.0
    return sum(e - s for s, e in m), m[-1][1] - m[0][0]


class Window:
    """What a traced window saw: its host seconds, the kernel records in
    it, the host events, the fused records against the kernels' count of
    their runs, and the cell's own counts (sub-steps, frames, host spans)
    for the metric readers."""

    def __init__(self, seconds: float, kernels: List[dict],
                 host: List[dict], span: Tuple[float, float],
                 runs: Tuple[int, int]):
        self.seconds, self.kernels, self.host = seconds, kernels, host
        self.span = span
        self.fwd_records = sum(bool(FWD.search(k["name"])) for k in kernels)
        self.bwd_records = sum(bool(BWD_MAIN.search(k["name"]))
                               for k in kernels)
        self.runs = runs
        self.fused_ok = (self.fwd_records, self.bwd_records) == tuple(runs)
        self.busy_s = busy_union(kernels)[0] / 1e6
        self.counts: Dict[str, object] = {}

    def kernel_seconds(self, pattern: re.Pattern) -> float:
        return sum(k.get("dur", 0) for k in self.kernels
                   if pattern.search(k["name"])) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest
        idle gaps inside the window by the host event under each."""
        by = defaultdict(float)
        for k in self.kernels:
            by[short(k["name"])] += k.get("dur", 0) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        t0, t1 = self.span
        gaps, at = [], t0
        for s, e in merged(self.kernels) + [(t1, t1)]:
            if s > at:
                gaps.append((at, min(s, t1)))
            at = max(at, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            under = [h for h in self.host
                     if h["ts"] <= mid <= h["ts"] + h.get("dur", 0)
                     and h["name"] != WINDOW_SPAN]
            name = min(under, key=lambda h: h.get("dur", 0))["name"] \
                if under else "no host event"
            out.append([short(name), (e - s) / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": out}


def short(name: str, n: int = 96) -> str:
    """A kernel's name without its argument list, at most `n` letters."""
    return re.sub(r"(?<=[\w>])\(.*$", "", name)[:n]


def read(path: str):
    """(kernel records, host events) of an exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e.get("ts", 0))
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation",
                                 "python_function", "cuda_runtime")]
    return kernels, host


def traced(work: Callable[[], Dict[str, object]], device) -> Window:
    """Run `work` once inside a profiler window with quiet margins; returns
    the Window, with `work`'s own counts in `counts`.  The trace is written
    under the temporary directory and removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from nerf_fl_torch.ops import fused_mlp as fm

    runs0 = fm.kernel_runs(device)                # synchronizes
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        time.sleep(MARGIN_S)
        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            counts = work()
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        time.sleep(MARGIN_S)
    finally:
        prof.__exit__(None, None, None)
    runs = tuple(b - a for a, b in zip(runs0, fm.kernel_runs(device)))
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        kernels, host = read(path)
    spans = [h for h in host if h["name"] == WINDOW_SPAN]
    span = (spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]) if spans \
        else ((kernels[0]["ts"], kernels[-1]["ts"] + kernels[-1]["dur"])
              if kernels else (0.0, 0.0))
    w = Window(seconds, kernels, host, span, runs)
    w.counts = counts
    return w
