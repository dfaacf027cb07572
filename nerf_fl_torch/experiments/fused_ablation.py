"""Ablations of the fused kernels on the card: where their time is.

    python -m nerf_fl_torch.experiments.fused_ablation [--n POINTS]
        [--kernel fwd_bf16|bwd_f32] [--csrc DIR]

Each variant is a copy of ``nerf_fl_torch/csrc/`` (or of ``--csrc DIR``, the
sources of another checkout whose C interface is this one's) with one part
of the kernel's block taken out by a text substitution, built into
``nerf_fl_torch/_build/ablation/<variant>/`` and timed beside the unchanged
kernel's build in the same process.  The variants compute wrong values by
design; only their time is read.

``--kernel fwd_bf16`` (``VARIANTS``): the bf16 forward at the render
chunk's shape (flagship fine pass, transient, appearance 48):

  * ``half_slab_bytes``: the producer copies half of every weight slab, so
    the L2-to-shared traffic halves while the products stay the same;
  * ``no_encoders``: the positional encodings and the appearance copy are
    skipped (the operand tiles keep whatever they held);
  * ``plain_epilogue``: the hidden layers' epilogue is one add and a ReLU,
    without the two roundings on the way.

``--kernel bwd_f32`` (``BWD_F32_VARIANTS``): the f32 backward at the train
step's fine pass (131,072 points, appearance 48, transient); the fused
recompute + dgrad kernel's device time alone (torch.profiler), beside the
whole launch's (CUDA events, the wgrad and reductions included):

  * ``half_stage_bytes``: the producer copies half of every ring stage;
  * ``hi_hi_only``: one TF32 pass a product (hi x hi) instead of three;
  * ``no_saves``: no operand slot leaves for the wgrad (``tf::save``);
  * ``bias_relu_epilogues``: the epilogues keep the bias and the ReLU and
    drop the ReLU bits, the cotangent masks and sums and the db column
    sums.

A variant that is not faster shows that its part does not bound the kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

# (file, old, new): old occurs exactly once; (file, old, new, True): old
# occurs at least once and every occurrence is replaced
VARIANTS: Dict[str, List[Tuple]] = {
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

# The f32 block's pieces in fused_mlp_common.cuh, each pattern wherever the
# backward's instances of it are written out (every occurrence).
_H = "fused_mlp_common.cuh"
BWD_F32_VARIANTS: Dict[str, List[Tuple]] = {
    "as_is": [],
    "half_stage_bytes": [(
        _H,
        """      hop::mbar_expect_tx(full + 8 * stage, bytes);
      hop::bulk_g2s(buf + stage * stride, src, bytes, full + 8 * stage);""",
        """      hop::mbar_expect_tx(full + 8 * stage, bytes / 2);
      hop::bulk_g2s(buf + stage * stride, src, bytes / 2, full + 8 * stage);""",
        True)],
    "hi_hi_only": [
        (_H, "Wgmma32<NP>::run(d, al[kk], hop::kdesc(hi + 32 * kk), 1);", "",
         True),
        (_H, "Wgmma32<NP>::run(d, ah[kk], hop::kdesc(lo + 32 * kk), 1);", "",
         True)],
    "no_saves": [(_H, "  const int groups = (cols + 7) / 8;\n",
                  "  return;\n  const int groups = (cols + 7) / 8;\n", True)],
    "bias_relu_epilogues": [
        (_H, "    if constexpr (ADD) {\n      const float4 o = *p;",
         "    if constexpr (false) {\n      const float4 o = *p;", True),
        (_H, "    if constexpr (MASK) {\n      const uint32_t bits = m[(4 * j) "
             "/ 32] >> ((4 * j) % 32);\n      v = make_float4(",
         "    if constexpr (false) {\n      const uint32_t bits = m[(4 * j) "
         "/ 32] >> ((4 * j) % 32);\n      v = make_float4(", True),
        (_H, "    if constexpr (DB) {\n      float s0 = v.x + v.z,",
         "    if constexpr (false) {\n      float s0 = v.x + v.z,", True),
        (_H, "    if (M)\n      m[(4 * j) / 32] |=",
         "    if (false)\n      m[(4 * j) / 32] |=", True)],
}


def patched_sources(variant: str, csrc=None,
                    variants: Optional[Dict] = None) -> Dict[str, str]:
    """File name -> text of every source under ``csrc`` (the package's own
    by default), with the substitutions of ``variants[variant]`` (this
    module's ``VARIANTS`` by default) applied; raises if a pattern does not
    occur exactly once (or, marked to replace every occurrence, at all)."""
    from ..ops import _build
    variants = VARIANTS if variants is None else variants
    texts = {p.name: p.read_text()
             for p in sorted((csrc or _build.CSRC).iterdir())
             if p.suffix in (".cu", ".cuh", ".h")}
    for name, old, new, *every in variants[variant]:
        count = texts[name].count(old)
        if count != 1 and not (every and count):
            raise RuntimeError(f"ablation {variant}: pattern occurs "
                               f"{count} times in {name}")
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


def device_ms(fn, reps: int, kernel: str) -> float:
    """ms a run of the kernels whose names hold ``kernel`` inside ``fn``,
    from torch.profiler's device records over ``reps`` runs (NaN if the
    profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", None)
             or getattr(e, "cuda_time_total", 0.0)
             for e in prof.key_averages() if kernel in e.key)
    return us / 1e3 / reps if us else float("nan")


def main(n: Optional[int] = None, reps: int = 7, device=None,
         kernel: str = "fwd_bf16", csrc: Optional[str] = None) -> Dict:
    import torch
    from ..models import NeRFConfig, init_nerf
    from ..ops import _build
    from ..ops import fused_mlp as fm
    from .f32_kernels import median_ms

    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        raise ValueError("the ablations time CUDA kernels: they need a card")
    bwd = kernel == "bwd_f32"
    n = n or (131_072 if bwd else 32 * 1024 * 128)
    variants = BWD_F32_VARIANTS if bwd else VARIANTS
    dtype = torch.float32 if bwd else torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    model = init_nerf(NeRFConfig(typ="fine", encode_appearance=True,
                                 encode_transient=True), generator=gen).to(dev)
    xyz = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
    d = torch.randn(n, 3, generator=gen)
    inp = fm.pack_inputs(xyz, (d / d.norm(dim=-1, keepdim=True)).to(dev),
                         torch.randn(n, 48, generator=gen).to(dev),
                         torch.randn(n, 16, generator=gen).to(dev))
    g = torch.zeros(n, fm.OUT_W)
    g[:, :9] = torch.randn(n, 9, generator=gen)
    g = g.to(dev)
    net = fm.pack_weights(model, fm.Layout(dtype, 10, 4, 48, 16))
    sx, sd = fm.default_scale_rows(10, 4, 48, device=dev)

    def run():
        if bwd:
            return fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
        return fm.fused_mlp_fwd_cuda(inp, net, sx, sd)

    ms, fused = {}, {}
    src = Path(csrc).resolve() / "nerf_fl_torch" / "csrc" if csrc else None
    if bwd:
        # the profiler's first window reads slow: one before the variants
        device_ms(lambda: torch.zeros(1, device=dev), 1, "none")
    for variant in list(variants) + ["as_is"]:
        with built_from(patched_sources(variant, src, variants),
                        _build.BUILD / "ablation" / variant,
                        fm._lib.cache_clear if not bwd
                        else fm._lib_bwd.cache_clear):
            run()
            ms.setdefault(variant, []).append(median_ms(run, reps))
            line = (f"[ablation] {variant:20s} {ms[variant][-1]:8.3f} ms at "
                    f"{n} points")
            if bwd:
                fused.setdefault(variant, []).append(min(
                    device_ms(run, reps, "fused_mlp_bwd_f32_kernel")
                    for _ in range(2)))
                line += (f" (the launch), fused kernel "
                         f"{fused[variant][-1]:8.3f} ms")
        print(line, flush=True)
    out = {"device": torch.cuda.get_device_name(dev), "kernel": kernel,
           "n": n, "csrc": str(src) if src else None, "ms": ms}
    if bwd:
        out["fused_ms"] = fused
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="points (default: 4,194,304 fwd_bf16, 131,072 "
                         "bwd_f32)")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--kernel", choices=("fwd_bf16", "bwd_f32"),
                    default="fwd_bf16")
    ap.add_argument("--csrc", default=None,
                    help="the root of another checkout whose sources to "
                         "ablate")
    args = ap.parse_args()
    main(n=args.n, reps=args.reps, kernel=args.kernel, csrc=args.csrc)
