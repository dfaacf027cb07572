"""Ablations of the bf16 fused forward kernel on the card: where its time is.

    python -m nerf_fl_torch.experiments.fused_ablation [--n POINTS]

Each variant is a copy of ``nerf_fl_torch/csrc/`` with one part of the
kernel's block taken out by a text substitution, built into
``nerf_fl_torch/_build/ablation/<variant>/`` and timed at the render chunk's
shape (flagship fine pass, transient, appearance 48).  The variants compute
wrong values by design; only their time is read, beside the unchanged
kernel's in the same process:

  * ``half_slab_bytes``: the producer copies half of every weight slab, so
    the L2-to-shared traffic halves while the products stay the same;
  * ``no_encoders``: the positional encodings and the appearance copy are
    skipped (the operand tiles keep whatever they held);
  * ``plain_epilogue``: the hidden layers' epilogue is one add and a ReLU,
    without the two roundings on the way.

A variant that is not faster shows that its part does not bound the kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

VARIANTS: Dict[str, List[Tuple[str, str, str]]] = {
    "as_is": [],
    "half_slab_bytes": [(
        "fused_mlp_common.cuh",
        """      mbar_expect_tx(full + 8 * stage, plan.bytes[s]);
      bulk_g2s(buf + stage * stride, image + plan.off[s], plan.bytes[s],
               full + 8 * stage);""",
        """      mbar_expect_tx(full + 8 * stage, plan.bytes[s] / 2);
      bulk_g2s(buf + stage * stride, image + plan.off[s], plan.bytes[s] / 2,
               full + 8 * stage);""")],
    "no_encoders": [
        ("fused_mlp_common.cuh",
         "  const int r = t >> 1, half = t & 1;\n  const bool live =",
         "  return;\n  const int r = t >> 1, half = t & 1;\n"
         "  const bool live ="),
        ("fused_mlp_common.cuh",
         "  if (row >= (size_t)n) return;\n  const char* p =",
         "  return;\n  const char* p =")],
    "plain_epilogue": [(
        "fused_mlp_common.cuh",
        """    const uint32_t y = pack2(v0, v1);
    __nv_bfloat162 h = __floats2bfloat162_rn(lo_f(y) + b.x, hi_f(y) + b.y);
    h = __hmax2(h, __float2bfloat162_rn(0.0f));
    return *reinterpret_cast<uint32_t*>(&h);""",
        "    return pack2(fmaxf(v0 + b.x, 0.0f), fmaxf(v1 + b.y, 0.0f));")],
}


def patched_sources(variant: str, csrc=None,
                    variants: Optional[Dict] = None) -> Dict[str, str]:
    """File name -> text of every source under ``csrc`` (the package's own
    by default), with the substitutions of ``variants[variant]`` (this
    module's ``VARIANTS`` by default) applied; raises if a pattern does not
    occur exactly once."""
    from ..ops import _build
    variants = VARIANTS if variants is None else variants
    texts = {p.name: p.read_text()
             for p in sorted((csrc or _build.CSRC).iterdir())
             if p.suffix in (".cu", ".cuh", ".h")}
    for name, old, new in variants[variant]:
        if texts[name].count(old) != 1:
            raise RuntimeError(f"ablation {variant}: pattern occurs "
                               f"{texts[name].count(old)} times in {name}")
        texts[name] = texts[name].replace(old, new)
    return texts


@contextlib.contextmanager
def built_from(texts: Dict[str, str], root: Path,
               clear: Callable[[], None]):
    """Inside the block, ``ops/_build`` builds and loads the kernels from
    ``texts`` (file name -> source) written to ``root/csrc``, into
    ``root/_build``; ``clear`` drops the caller's cached libraries on the
    way in and out."""
    from ..ops import _build
    csrc, build = _build.CSRC, _build.BUILD
    shutil.rmtree(root, ignore_errors=True)
    (root / "csrc").mkdir(parents=True)
    for name, text in texts.items():
        (root / "csrc" / name).write_text(text)
    _build.CSRC, _build.BUILD = root / "csrc", root / "_build"
    clear()
    try:
        yield
    finally:
        _build.CSRC, _build.BUILD = csrc, build
        clear()


def main(n: int = 32 * 1024 * 128, reps: int = 7, device=None) -> Dict:
    import torch
    from ..models import NeRFConfig, init_nerf
    from ..ops import _build
    from ..ops import fused_mlp as fm

    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        raise ValueError("the ablations time CUDA kernels: they need a card")
    gen = torch.Generator().manual_seed(0)
    model = init_nerf(NeRFConfig(typ="fine", encode_appearance=True,
                                 encode_transient=True), generator=gen).to(dev)
    xyz = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
    d = torch.randn(n, 3, generator=gen)
    inp = fm.pack_inputs(xyz, (d / d.norm(dim=-1, keepdim=True)).to(dev),
                         torch.randn(n, 48, generator=gen).to(dev),
                         torch.randn(n, 16, generator=gen).to(dev))
    net = fm.pack_weights(model, 48, True, torch.bfloat16, 10, 4, 16)
    sx, sd = fm.default_scale_rows(10, 4, 48, device=dev)
    kw = dict(n_freq_xyz=10, n_freq_dir=4, a_dim=48, t_dim=16,
              has_transient=True, dtype=torch.bfloat16)

    def run():
        return fm.fused_mlp_fwd_cuda(inp, net, sx, sd, **kw)

    ms = {}
    for variant in list(VARIANTS) + ["as_is"]:
        with built_from(patched_sources(variant),
                        _build.BUILD / "ablation" / variant,
                        fm._lib.cache_clear):
            for _ in range(3):
                run()
            times = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
        ms.setdefault(variant, []).append(sorted(times)[reps // 2])
        print(f"[ablation] {variant:16s} {ms[variant][-1]:8.3f} ms at {n} "
              f"points", flush=True)
    out = {"device": torch.cuda.get_device_name(dev), "n": n, "ms": ms}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32 * 1024 * 128)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    main(n=args.n, reps=args.reps)
