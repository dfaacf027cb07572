"""Layouts of the sin probe's kernel on the card: what its time depends on.

    python -m nerf_fl_torch.experiments.sin_ablation [--n POINTS]

Each variant is a copy of ``nerf_fl_torch/csrc/`` with ``anatomy_pe.cu``'s
sin kernel changed by a text substitution, built as ``fused_ablation``
builds its variants (into ``nerf_fl_torch/_build/ablation/sin_<variant>/``)
and timed through the sin probe at the probes' 524,288 points, queued behind
a device sleep (``probe_timing.queued_ms``: device time per call), beside
``torch.sin`` of the same input.  Every variant computes the same function
and is held to ``torch.sin`` bit for bit:

  * ``as_is``: one tile of 256 float4s a block, as many blocks as tiles
    (the hardware's block scheduler balances the SMs), plain 16-byte loads
    and stores;
  * ``streaming``: the same with streaming cache hints (``__ldcs`` /
    ``__stcs``: every byte is touched once);
  * ``unroll4``: four float4s a thread (four independent 16-byte loads
    before the first sinf), a quarter of the blocks;
  * ``persistent``: only as many blocks as the SMs hold at once, each
    walking the tiles with a grid stride (a fixed share an SM);
  * ``persistent_unroll4``: both, the layout of a classic persistent
    streaming kernel.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

from .fused_ablation import built_from, patched_sources

_SRC = "anatomy_pe.cu"
_UNROLL4 = [(_SRC, "constexpr int SIN_UNROLL = 1;",
             "constexpr int SIN_UNROLL = 4;")]
_PERSISTENT = [(
    _SRC,
    "  if (blocks == 0) blocks = 1;                          // the tail alone\n",
    """  if (blocks == 0) blocks = 1;                          // the tail alone
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sin_kernel,
                                                SIN_THREADS, 0);
  if (blocks > (size_t)sms * per_sm) blocks = (size_t)sms * per_sm;
""")]
VARIANTS: Dict[str, List[Tuple[str, str, str]]] = {
    "as_is": [],
    "streaming": [
        (_SRC, "v[u] = x4[i + u * SIN_THREADS];",
         "v[u] = __ldcs(x4 + i + u * SIN_THREADS);"),
        (_SRC, "o4[i + u * SIN_THREADS] = sin4(v[u]);",
         "__stcs(o4 + i + u * SIN_THREADS, sin4(v[u]));")],
    "unroll4": _UNROLL4,
    "persistent": _PERSISTENT,
    "persistent_unroll4": _PERSISTENT + _UNROLL4,
}


def main(n: int = 524_288, device=None) -> Dict:
    import torch
    from ..ops import _build, anatomy
    from .probe_timing import queued_ms

    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        raise ValueError("the ablations time CUDA kernels: they need a card")
    x = anatomy.chain_operands(n, 0, dev)["x128"]
    ref = torch.sin(x)
    probe = anatomy.PROBES["sin"]
    ms: Dict[str, List[float]] = {}

    def timed(name, fn):
        for _ in range(2):
            fn()
        ms.setdefault(name, []).append(queued_ms(fn)[0])
        print(f"[sin ablation] {name:20s} {ms[name][-1]:.4f} ms a call "
              f"queued, at {n} points", flush=True)

    with torch.no_grad():
        timed("torch.sin", lambda: torch.sin(x))
        for variant in list(VARIANTS) + ["as_is"]:
            with built_from(patched_sources(variant, variants=VARIANTS),
                            _build.BUILD / "ablation" / f"sin_{variant}",
                            anatomy._launcher.cache_clear):
                if not torch.equal(probe.cuda(x), ref):
                    raise RuntimeError(f"sin variant {variant} differs from "
                                       f"torch.sin")
                timed(variant, lambda: probe.cuda(x))
        timed("torch.sin", lambda: torch.sin(x))
    out = {"device": torch.cuda.get_device_name(dev), "n": n, "ms": ms}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=524_288)
    main(n=ap.parse_args().n)
