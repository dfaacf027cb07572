"""The program's device stages in a traced window: the kernel records split
by the program's stage marks.

A mark is a kernel record named `nerf_mark_<stage>`.  A mark starts a
stage, and a kernel belongs to the stage of the last mark before it on its
stream.  A segment runs from its first mark (a train sub-step's `load`, a
render chunk's `upload`) to the next `end` mark; kernels outside every
segment (a call's fills before its first sub-step, the metrics' clone
after its last) belong to no stage.  The marks' own records are left out
of every stage.  Where a segment lacks one of the marks it needs, or the
window holds another number of segments than its sub-steps or chunks, the
split is None: a missing record is then a missing metric, not a wrong one.

    python3 -m benchmark.stages --workload <cell> --seed <n>

runs the cell's traced window once and prints its whole split as one JSON
line: each stage's device ms a sub-step or a frame, the marks', the
kernels outside every segment, and the host spans.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

MARK = re.compile(r"\bnerf_mark_([a-z_]+)")

# the marks a segment needs, in order
SUB_STEP = ("load", "sample", "coarse_mlp", "coarse_composite", "pdf",
            "fine_mlp", "fine_composite", "loss", "backward", "optimizer",
            "row", "end")
POSED_SUB_STEP = ("load", "pose", "sample", "coarse_mlp", "coarse_composite",
                  "pdf", "fine_mlp", "fine_composite", "loss", "backward",
                  "pose_backward", "optimizer", "row", "end")
CHUNK = ("upload", "sample", "coarse_mlp", "coarse_composite", "pdf",
         "fine_mlp", "fine_composite", "end")
# a sub-step's forward, the pose path aside
FORWARD = ("load", "sample", "coarse_mlp", "coarse_composite", "pdf",
           "fine_mlp", "fine_composite", "loss")

Segment = Dict[str, List[dict]]


def stage_of(record: dict) -> Optional[str]:
    """The stage a mark's record starts; None for any other kernel."""
    m = MARK.search(record["name"])
    return m.group(1) if m else None


def _stream(record: dict):
    args = record.get("args") or {}
    return args.get("device"), args.get("stream", record.get("tid"))


def _in_order(seen: Sequence[str], need: Sequence[str]) -> bool:
    it = iter(seen)
    return all(s in it for s in need)


def split(kernels: List[dict], need: Sequence[str],
          count: int) -> Optional[List[Segment]]:
    """The window's segments, each {stage: its kernel records}, marks left
    out; None unless every segment holds the marks of `need` in order
    (from `need[0]` to `need[-1]`) and there are `count` segments."""
    first, last = need[0], need[-1]
    by_stream = defaultdict(list)
    for k in kernels:
        by_stream[_stream(k)].append(k)
    segments: List[Segment] = []
    for records in by_stream.values():
        records.sort(key=lambda k: k["ts"])
        seg, seen, stage = None, [], None
        for k in records:
            s = stage_of(k)
            if s is None:
                if seg is not None:
                    seg[stage].append(k)
            elif s == first:
                if seg is not None:
                    return None             # a segment without its end
                seg, seen, stage = defaultdict(list), [s], s
            elif seg is None:
                return None                 # a mark outside a segment
            else:
                seen.append(s)
                stage = s
                if s == last:
                    if not _in_order(seen, need):
                        return None
                    segments.append(dict(seg))
                    seg = None
        if seg is not None:
            return None
    return segments if len(segments) == count else None


def ms(segments: List[Segment], names: Sequence[str], per: int,
       exclude: Optional[re.Pattern] = None) -> float:
    """Device ms of the stages `names` over `per` (sub-steps or frames),
    without the kernels that `exclude` matches."""
    us = sum(k.get("dur", 0) for seg in segments for n in names
             for k in seg.get(n, ())
             if exclude is None or not exclude.search(k["name"]))
    return us / 1e3 / per


def sub_steps(w, cell) -> Optional[List[Segment]]:
    """The traced train window's sub-steps (a posed sub-step under pose
    refinement), or None."""
    n = w.counts.get("sub_steps")
    if not n:
        return None
    need = POSED_SUB_STEP if cell.config.get("refine_pose") else SUB_STEP
    return split(w.kernels, need, n)


def chunks(w, cell) -> Optional[List[Segment]]:
    """The traced render window's chunks, or None."""
    frames = w.counts.get("frames")
    if not frames:
        return None
    return split(w.kernels, CHUNK, frames * cell.chunks_per_frame)


def host_ms(w, name: str, per: int) -> Optional[float]:
    """Host ms of the program's spans `name` inside the window over `per`;
    None where the window holds no such span."""
    t0, t1 = w.span
    found = [h.get("dur", 0) for h in w.host
             if h["name"] == name and t0 <= h["ts"] <= t1]
    return sum(found) / 1e3 / per if found and per else None


def whole(w, cell) -> Dict[str, object]:
    """Every stage's device ms a sub-step (a frame), the marks', the
    kernels outside every segment, the window's kernel total, and the
    program's host spans (count and ms a sub-step or frame)."""
    from benchmark import trace
    train = "sub_steps" in w.counts
    per = w.counts["sub_steps"] if train else w.counts["frames"]
    segs = sub_steps(w, cell) if train else chunks(w, cell)
    total = sum(k.get("dur", 0) for k in w.kernels) / 1e3 / per
    marks = sum(k.get("dur", 0) for k in w.kernels
                if stage_of(k)) / 1e3 / per
    out: Dict[str, object] = {"per": "sub-step" if train else "frame",
                              "kernel_ms": total, "marks_ms": marks,
                              "marks": sum(bool(stage_of(k))
                                           for k in w.kernels) / per}
    if segs is not None:
        names = sorted({n for s in segs for n in s},
                       key=lambda n: (POSED_SUB_STEP + CHUNK).index(n))
        stages = {n: ms(segs, [n], per) for n in names}
        out["stages_ms"] = stages
        out["kernels"] = {n: sum(len(s.get(n, ())) for s in segs) / per
                          for n in names}
        fused = re.compile(f"{trace.FWD.pattern}|{trace.BWD.pattern}")
        out["fused_ms"] = {n: stages[n] - ms(segs, [n], per, fused)
                           for n in names}
        out["outside_ms"] = total - marks - sum(stages.values())
    spans = defaultdict(lambda: [0, 0.0])
    t0, t1 = w.span
    for h in w.host:
        if h["name"].startswith("nerf.") and t0 <= h["ts"] <= t1:
            spans[h["name"]][0] += 1
            spans[h["name"]][1] += h.get("dur", 0) / 1e3 / per
    out["host_spans"] = dict(sorted(spans.items()))
    out["breakdown"] = w.breakdown()
    out["unnamed_gaps"] = unnamed_gaps(w)
    return out


def unnamed_gaps(w, least_us: float = 100.0) -> List[Dict[str, object]]:
    """The window's idle gaps of `least_us` or more under no host event
    (`no host event` in the breakdown), each with the host events that
    end before it and start after it: where the host was."""
    from benchmark import trace
    host = [h for h in w.host if h["name"] != trace.WINDOW_SPAN]
    t0, t1 = w.span
    out, at = [], t0
    for s, e in trace.merged(w.kernels) + [(t1, t1)]:
        mid = 0.5 * (at + s)
        if s - at >= least_us and not any(
                h["ts"] <= mid <= h["ts"] + h.get("dur", 0) for h in host):
            ended = [h for h in host if h["ts"] + h.get("dur", 0) < mid]
            begun = [h for h in host if h["ts"] > mid]
            out.append({
                "ms": (s - at) / 1e3, "at_ms": (at - t0) / 1e3,
                "after": max(ended, key=lambda h: h["ts"] + h.get("dur", 0),
                             default={"name": None})["name"],
                "before": min(begun, key=lambda h: h["ts"],
                              default={"name": None})["name"]})
        at = max(at, e)
    return out


def main(argv=None):
    import argparse
    import json
    import torch
    from benchmark import spec
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    sp = spec.cell(args.workload)
    cell = spec.runner(sp.traffic["kind"]).Runner(
        sp, args.seed, torch.device("cuda", 0))
    cell.setup()
    for _ in range(3):
        w = cell.traced()
        if w.fused_ok:
            break
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(0),
                      "fused_ok": w.fused_ok, "window_s": w.seconds,
                      **whole(w, cell)}), flush=True)


if __name__ == "__main__":
    main()
