"""The PE-matmul probes without the epilogue's sinf (time only).

    python -m nerf_fl_torch.experiments.pe_ablation [--n POINTS]

``csrc/anatomy_pe.cu:pe_mm_hopper_kernel<TERMS>`` stores where(trg > 0,
sin(E + ph), E) * s.  The variant ``no_sin`` is a copy of
``nerf_fl_torch/csrc/`` whose epilogue stores E * s
(``fused_ablation.py``'s ``patched_sources`` / ``built_from``), built into
``nerf_fl_torch/_build/ablation/pe_no_sin/``: its values are wrong in the
trig columns, and it reads what the epilogue's sinf costs.  Each probe is
timed at the entry points' operands (seed 0, 524,288 points), per call and
queued (``probe_timing.py``); the shipped build runs first and last.
Prints the card's name and power limit, a line a variant with its
registers a thread, and last one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
from typing import Dict, List, Tuple

from .fused_ablation import built_from, patched_sources

PROBES = ("pe_mm", "pe_mm_bf16")
NO_SIN = [("anatomy_pe.cu",
           "make_float2(pe_out(acc[4 * j + 2 * h], p2.x, t2.x, s2.x),\n"
           "                        pe_out(acc[4 * j + 2 * h + 1], p2.y, t2.y, "
           "s2.y));",
           "make_float2(__fmul_rn(acc[4 * j + 2 * h], s2.x),\n"
           "                        __fmul_rn(acc[4 * j + 2 * h + 1], s2.y));")]


def _clear_pe() -> None:
    """Drop the cached encoder-probe library and its plans."""
    from ..ops import anatomy
    for f in (anatomy._launcher, anatomy.pe_plan, anatomy._check_pe_plan):
        f.cache_clear()


@contextlib.contextmanager
def without_sin():
    """Inside the block, the PE-matmul probes launch a build of ``csrc/``
    whose epilogue stores E * s (time only)."""
    from ..ops import _build
    texts = patched_sources("no_sin", variants={"no_sin": NO_SIN})
    with built_from(texts, _build.BUILD / "ablation" / "pe_no_sin",
                    _clear_pe):
        yield


def _registers(terms: int) -> int:
    """Registers a thread of the current build's pe_mm kernel for
    ``terms``, from ptxas."""
    from ..ops import _build
    log = _build.build_log("anatomy_pe")
    at = log.index(f"pe_mm_hopper_kernelILi{terms}EE")
    return int(re.search(r"Used (\d+) registers", log[at:]).group(1))


def main(n: int = 524_288, device=None) -> Dict:
    import torch
    from ..ops import anatomy
    from .probe_timing import per_call_ms, queued_ms

    dev = torch.device(device or "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise ValueError("the variants time CUDA kernels: they need a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    c = anatomy.chain_operands(n, 0, dev)
    ops = anatomy.pe_mm_rows(dev) + [c["x128"]]
    rows: Dict[str, Dict[str, List[float]]] = {}
    with torch.no_grad():
        for probe in PROBES:
            terms = anatomy.PE_TERMS[probe]
            runs: List[Tuple[str, object]] = [
                ("shipped", contextlib.nullcontext()),
                ("no_sin", without_sin()),
                ("shipped", contextlib.nullcontext())]
            for variant, ctx in runs:
                key = f"{probe}@{variant}"
                with ctx:
                    fn = (lambda p=anatomy.PROBES[probe]: p(*ops))
                    fn()                                      # warm up
                    call, _ = per_call_ms(fn)
                    queued, queued_all = queued_ms(fn)
                    regs_used = _registers(terms)
                row = rows.setdefault(key, {"per_call_ms": [],
                                            "device_ms": [], "registers": []})
                row["per_call_ms"].append(call)
                row["device_ms"].append(queued)
                row["registers"].append(regs_used)
                print(f"[pe] {key:18s} per call {call:.4f} ms, queued "
                      f"{queued:.4f} ms a call (windows: "
                      f"{[round(t, 4) for t in queued_all]}), {regs_used} "
                      f"registers", flush=True)
    out = {"device": torch.cuda.get_device_name(dev), "power": smi, "n": n,
           "ms": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=524_288)
    main(n=ap.parse_args().n)
