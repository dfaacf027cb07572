"""The chain probes' weight ring at other depths on the card.

    python -m nerf_fl_torch.experiments.chain_ablation [--n POINTS]

``csrc/anatomy_chain.cu`` ships each chain probe with one ring depth
(``CHAIN8_STAGES``, ``CC_STAGES``, ``SPLIT_STAGES``: weight slabs of 32 KB in
flight).  Each variant here is a copy of ``nerf_fl_torch/csrc/`` with one of
those constants changed (``fused_ablation.py``'s ``patched_sources`` /
``built_from``), built into ``nerf_fl_torch/_build/ablation/<probe>_ring<d>/``
and timed at the entry points' operands (seed 0, 524,288 points), per call
and queued (``probe_timing.py``), beside ``concat`` as it ships:

  * ``chain8`` at 3, 4 and 5 slabs (5 is the deepest that fits beside its 4
    operand tiles a warpgroup);
  * ``split`` at 2, 3 and 4 slabs (4 is the deepest beside its 6 tiles).

``split`` at concat's two slabs does concat's work without the copy, so
``concat - split@2`` is what the copy costs, and ``split@2 - split@d`` what
the ring depth does.  The depth moves no arithmetic: every variant's output
must equal the shipped build's bit for bit, or this raises.  Prints the
card's name and power limit, a line a variant, and last one JSON object.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
from typing import Dict, List, Tuple

from .fused_ablation import built_from, patched_sources

STAGES = {"chain8": "CHAIN8_STAGES", "concat": "CC_STAGES",
          "split": "SPLIT_STAGES"}
DEPTHS = {"chain8": (3, 4, 5), "split": (2, 3, 4)}


def shipped_depth(probe: str) -> int:
    """The ring depth ``probe`` ships with (``csrc/anatomy_chain.cu``)."""
    from ..ops import _build
    text = (_build.CSRC / "anatomy_chain.cu").read_text()
    return int(re.search(rf"constexpr int {STAGES[probe]} = (\d+);",
                         text).group(1))


def _clear_chain() -> None:
    """Drop the cached chain library and its plans."""
    from ..ops import anatomy
    for f in (anatomy._launcher, anatomy.chain_plan,
              anatomy._check_chain_plan):
        f.cache_clear()


@contextlib.contextmanager
def ring_depth(probe: str, depth: int):
    """Inside the block, the chain probes launch a build of ``csrc/`` in
    which ``probe``'s ring holds ``depth`` slabs."""
    from ..ops import _build
    const, now = STAGES[probe], shipped_depth(probe)
    variant = [("anatomy_chain.cu", f"constexpr int {const} = {now};",
                f"constexpr int {const} = {depth};")]
    texts = patched_sources("ring", variants={"ring": variant})
    with built_from(texts, _build.BUILD / "ablation" / f"{probe}_ring{depth}",
                    _clear_chain):
        yield


def main(n: int = 524_288, device=None) -> Dict:
    import torch
    from ..ops import anatomy
    from .probe_timing import per_call_ms, queued_ms

    dev = torch.device(device or "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise ValueError("the ring variants time CUDA kernels: they need a "
                         "card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    c = anatomy.chain_operands(n, 0, dev)
    ops = {name: anatomy.chain_inputs(c, name != "chain8")
           for name in anatomy.CHAIN_PROBES}
    rows: Dict[str, Dict[str, float]] = {}
    with torch.no_grad():
        shipped = {name: anatomy.PROBES[name](*ops[name])
                   for name in anatomy.CHAIN_PROBES}
        runs: List[Tuple[str, int]] = [("concat", shipped_depth("concat"))]
        runs += [(p, d) for p, ds in DEPTHS.items() for d in ds]
        runs += [("concat", shipped_depth("concat"))]   # before and after
        for probe, depth in runs:
            key = f"{probe}@{depth}"
            ctx = contextlib.nullcontext() if depth == shipped_depth(probe) \
                else ring_depth(probe, depth)
            with ctx:
                fn = (lambda p=anatomy.PROBES[probe], o=ops[probe]: p(*o))
                if not torch.equal(fn(), shipped[probe]):
                    raise RuntimeError(f"{key} differs from the shipped "
                                       f"{probe} build")
                fn()                                          # warm up
                call, _ = per_call_ms(fn)
                queued, queued_all = queued_ms(fn)
            rows.setdefault(key, {"per_call_ms": [], "device_ms": []})
            rows[key]["per_call_ms"].append(call)
            rows[key]["device_ms"].append(queued)
            print(f"[ring] {key:9s} per call {call:.4f} ms, queued "
                  f"{queued:.4f} ms a call (windows: {[round(t, 4) for t in queued_all]})"
                  f"{' shipped' if depth == shipped_depth(probe) else ''}",
                  flush=True)
    # concat ran first and last: its mean
    q = {k: sum(v["device_ms"]) / len(v["device_ms"]) for k, v in rows.items()}
    cc, sd = q[f"concat@{shipped_depth('concat')}"], shipped_depth("split")
    ring = q["split@2"] - q[f"split@{sd}"]
    print(f"[ring] queued: concat - split@2 = {cc - q['split@2']:.4f} ms (the "
          f"copy), split@2 - split@{sd} = {ring:.4f} (the ring depth)")
    out = {"device": torch.cuda.get_device_name(dev), "power": smi, "n": n,
           "ms": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=524_288)
    main(n=ap.parse_args().n)
