"""Entry points that time the kernel-anatomy probes on the card:
``kernel_anatomy`` (matmul-chain ceiling, skip as concat or split, the PE as
a matmul or as multiply-adds) and ``kernel_anatomy2`` (the net without
encoders, with and without the transient branch, the encoders alone,
consolidated operands).  Counterparts of ``experiments/kernel_anatomy.py``
and ``experiments/kernel_anatomy2.py``; this module holds what they share.

Timing differs from the JAX files on purpose.  Their ``bench`` times 30
dispatches of a jitted ``jnp.sum(kernel(...))`` by the host clock; here a
probe is timed alone, as PyTorch code times a kernel: after a warm-up, CUDA
events around single launches, the median of ``reps``.  With
``device="cpu"`` the plain versions run and the host clock times them, which
says nothing about a card and is labelled with the device it ran on.  A
probe that fails raises; no result is recorded as missing.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

N_POINTS = 524288
REPS = 10
# the JAX package's TPU records live here; the port never writes there
_JAX_RECORDS = Path(__file__).resolve().parents[2] / "experiments"


def bench(name: str, fn: Callable[[], torch.Tensor], n: int,
          dev: torch.device, reps: int) -> float:
    """Median ms of ``reps`` single calls of ``fn`` after a warm-up; prints
    ``name: x.xxx ms``.  Raises if the probe does, or if its output is not
    finite (n, 128) f32."""
    out = fn()
    if tuple(out.shape) != (n, 128) or out.dtype != torch.float32 \
            or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{name}: output is not finite ({n}, 128) float32")
    times = []
    if dev.type == "cuda":
        fn()
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(reps):
            s = time.perf_counter()
            fn()
            times.append((time.perf_counter() - s) * 1e3)
    ms = sorted(times)[len(times) // 2]
    print(f"{name}: {ms:.3f} ms", flush=True)
    return ms


def report(ms: Dict[str, float], dev: torch.device, n: int, reps: int,
           out: Optional[str]) -> Dict[str, object]:
    """Print (and with ``out`` write) the run's one JSON object:
    ``{"device", "n", "reps", "ms": {name: ms}}``."""
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu (plain versions, host clock)"
    result = {"device": kind, "n": n, "reps": reps, "ms": ms}
    text = json.dumps(result, indent=1)
    if out is not None:
        path = Path(out).resolve()
        if _JAX_RECORDS in path.parents:
            raise ValueError(f"{out}: {_JAX_RECORDS} holds the JAX package's "
                             f"records; write somewhere else")
        path.write_text(text + "\n")
    print(text, flush=True)
    return result


def cli(main: Callable[..., Dict[str, object]], doc: str) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n", type=int, default=N_POINTS, help="points")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args()
    main(device=a.device, n=a.n, reps=a.reps, out=a.out)
