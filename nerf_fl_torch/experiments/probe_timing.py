"""Time the kernel-anatomy probes on the card two ways, one beside the other:

  * per call: CUDA events around one call at a time, the median of 7 (how
    the entry points and ``chip_smoke.py`` have timed a probe).  The window
    also holds whatever the wrapper does on the host before its launch,
    since the card is idle when the first event is recorded;
  * queued: CUDA events around CALLS back-to-back calls that wait behind a
    device sleep (``torch.cuda._sleep``) long enough for the host to queue
    all of them, so the card never waits on the host; per call, the median
    of 3 windows.  This is device time, launches and the wrapper's own
    device work (concat's weight image) included.

    python3 nerf_fl_torch/experiments/probe_timing.py [--root DIR] [NAME ...]

It runs as a file so that it can time another checkout of the port: --root
DIR imports ``nerf_fl_torch`` from DIR (default: the checkout this file is
in), whose ``ops/anatomy.py`` must hold ``PROBES``, ``chain_operands``,
``chain_inputs``, ``net_operands``, ``net_inputs``, ``pe_mm_rows`` and
``encoder_rows``.  NAMEs are probes (default: all eleven) or ``torch_sin``,
``torch.sin`` of the sin probe's input.  Operands are the entry points'
(seed 0, 524,288 points).  Prints the card's name and power limit, one
line a name, and last one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CALLS = 20
SLEEP_MS = 25.0          # the device sleep ahead of a window of CALLS calls


def per_call_ms(fn: Callable[[], object], reps: int = 7
                ) -> Tuple[float, List[float]]:
    """Median and all ms of ``reps`` single calls, each between two events
    on an idle card."""
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


def _sleep_cycles(ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that last about ``ms`` on this card
    (calibrated once)."""
    import torch
    if not hasattr(_sleep_cycles, "per_ms"):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        b.synchronize()
        _sleep_cycles.per_ms = 10_000_000 / a.elapsed_time(b)
    return int(ms * _sleep_cycles.per_ms)


def queued_ms(fn: Callable[[], object], windows: int = 3, calls: int = CALLS
              ) -> Tuple[float, List[float]]:
    """Median and all per-call ms of ``windows`` windows of ``calls`` calls
    queued behind a device sleep.  Raises if the host took longer to queue a
    window than the sleep lasted (the card would then have waited on it)."""
    import torch
    out = []
    cycles = _sleep_cycles(SLEEP_MS)
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        a.record()
        s = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - s) * 1e3
        b.record()
        b.synchronize()
        if host_ms >= SLEEP_MS:
            raise RuntimeError(f"queuing {calls} calls took {host_ms:.1f} ms "
                               f"of host time, more than the {SLEEP_MS} ms "
                               f"sleep ahead of them")
        out.append(a.elapsed_time(b) / calls)
    return sorted(out)[len(out) // 2], out


def cases(anatomy, n: int, dev) -> Dict[str, list]:
    """Every probe's operands as the entry points make them (seed 0)."""
    c = anatomy.chain_operands(n, 0, dev)
    o = anatomy.net_operands(n, 0, dev)
    rows = anatomy.pe_mm_rows(dev) + [c["x128"]]
    return {"static": anatomy.net_inputs(o, "static"),
            "full": anatomy.net_inputs(o, "full"),
            "consol": anatomy.net_inputs(o, "consol"),
            "chain8": anatomy.chain_inputs(c, False),
            "concat": anatomy.chain_inputs(c, True),
            "split": anatomy.chain_inputs(c, True),
            "pe_mm": rows, "pe_vpu": rows, "sin": [c["x128"]],
            "pe_mm_bf16": rows,
            "pe_only": anatomy.encoder_rows(dev) + [o["inp"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose nerf_fl_torch is timed")
    ap.add_argument("--n", type=int, default=524_288, help="points")
    ap.add_argument("names", nargs="*", help="probes and/or torch_sin")
    a = ap.parse_args(argv)
    root = str(Path(a.root).resolve())
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("probe_timing: needs a CUDA card", file=sys.stderr)
        return 1
    from nerf_fl_torch.ops import anatomy
    if not anatomy.__file__.startswith(root):
        raise RuntimeError(f"imported {anatomy.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    dev = torch.device("cuda", 0)
    ops = cases(anatomy, a.n, dev)
    names = a.names or list(ops) + ["torch_sin"]
    res: Dict[str, Dict[str, float]] = {}
    with torch.no_grad():
        for name in names:
            if name == "torch_sin":
                x = ops["sin"][0]
                fn = (lambda x=x: torch.sin(x))
            else:
                probe, args = anatomy.PROBES[name], ops[name]
                fn = (lambda p=probe, o=args: p(*o))
            for _ in range(2):                               # warm up
                fn()
            call, call_all = per_call_ms(fn)
            queued, queued_all = queued_ms(fn)
            res[name] = {"per_call_ms": call, "device_ms": queued}
            print(f"[timing] {name:10s} per call {call:.4f} ms (runs "
                  f"{[round(t, 4) for t in call_all]}); queued {queued:.4f} "
                  f"ms a call (windows of {CALLS}: "
                  f"{[round(t, 4) for t in queued_all]})", flush=True)
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(dev),
                      "n": a.n, "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
