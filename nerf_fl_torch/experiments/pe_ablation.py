"""The PE probes' kernels with one part changed at a time: what their time
depends on.

    python -m nerf_fl_torch.experiments.pe_ablation [--n POINTS] [PROBE ...]

Each variant is a copy of ``nerf_fl_torch/csrc/`` with ``anatomy_pe.cu``
changed by a text substitution (``fused_ablation.py``'s
``patched_sources`` / ``built_from``), built into
``nerf_fl_torch/_build/ablation/pe_<variant>/``:

  * ``pe_mm`` / ``pe_mm_bf16`` (``pe_mm_hopper_kernel<TERMS>``):
    ``no_sin`` stores E * s in the epilogue (wrong values in the trig
    columns, time only): what the epilogue's sinf costs;
  * ``pe_vpu`` (``pe_vpu_kernel``): ``all_sin`` drops the warp-uniform skip,
    so every column evaluates sinf and selects (exact); ``column_a_thread``
    is the kernel's first design (one thread a column, 16 rows a block, a
    dependent load before each 4-byte store, sinf on every column: exact);
    ``no_sin`` stores E * s and ``no_load`` reads no input (time only: the
    output's bytes with and without the input rows); beside them torch's
    ``fill_`` of a tensor of the output's shape (the written bytes alone).

Each probe is timed at the entry points' operands (seed 0, 524,288
points), per call and queued (``probe_timing.py``), the shipped build first
and last; an exact variant must equal the shipped build bit for bit.
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

_SRC = "anatomy_pe.cu"
_MM_NO_SIN = [(_SRC,
               "make_float2(pe_out(acc[4 * j + 2 * h], p2.x, t2.x, s2.x),\n"
               "                        pe_out(acc[4 * j + 2 * h + 1], p2.y, "
               "t2.y, s2.y));",
               "make_float2(__fmul_rn(acc[4 * j + 2 * h], s2.x),\n"
               "                        __fmul_rn(acc[4 * j + 2 * h + 1], "
               "s2.y));")]
_VPU_TRIG = ("  const bool trig = __any_sync(\n"
             "      0xffffffffu, tc.x > 0.0f || tc.y > 0.0f || tc.z > 0.0f "
             "|| tc.w > 0.0f);\n")
# the parent's pe_vpu kernel, launched in place of the shipped one
_COLUMN_KERNEL = """__global__ void __launch_bounds__(THREADS)
pe_vpu_column_kernel(const float* __restrict__ P, const float* __restrict__ ph,
                     const float* __restrict__ trg,
                     const float* __restrict__ s,
                     const float* __restrict__ inp, float* __restrict__ out,
                     int n) {
  const int c = threadIdx.x & (LANES - 1);
  const float p0 = P[c], p1 = P[LANES + c], p2 = P[2 * LANES + c];
  const float phc = ph[c], trgc = trg[c], sc = s[c];
  const size_t r0 = (size_t)blockIdx.x * ROWS_PER_BLOCK;
  for (int i = threadIdx.x >> 7; i < ROWS_PER_BLOCK; i += THREADS / LANES) {
    const size_t r = r0 + i;
    if (r >= (size_t)n) break;
    out[r * LANES + c] =
        pe_out(accum3(inp + r * LANES, p0, p1, p2), phc, trgc, sc);
  }
}

int launch_pe_vpu("""
VARIANTS: Dict[str, List[Tuple[str, str, str]]] = {
    "no_sin": _MM_NO_SIN,
    "vpu_all_sin": [(_SRC, _VPU_TRIG, "  const bool trig = true;\n")],
    "vpu_column_a_thread": [
        (_SRC, "int launch_pe_vpu(", _COLUMN_KERNEL),
        (_SRC, "  pe_vpu_kernel<<<blocks, VPU_THREADS, 0, stream>>>(",
         "  pe_vpu_column_kernel<<<(n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,"
         " THREADS, 0, stream>>>(")],
    "vpu_no_sin": [(_SRC, _VPU_TRIG, "  const bool trig = false;\n")],
    "vpu_no_load": [(
        _SRC, "    x[u] = r < (size_t)n ? ld4(inp + r * LANES)\n",
        "    x[u] = r < (size_t)n ? make_float4(0.125f * (r & 7), 0.5f, "
        "0.25f, 0.0f)\n")],
}
# probe -> (variant, its name in VARIANTS, exact: whether it must equal the
# shipped build bit for bit)
RUNS = {
    "pe_mm": [("no_sin", "no_sin", False)],
    "pe_mm_bf16": [("no_sin", "no_sin", False)],
    "pe_vpu": [("all_sin", "vpu_all_sin", True),
               ("column_a_thread", "vpu_column_a_thread", True),
               ("no_sin", "vpu_no_sin", False),
               ("no_load", "vpu_no_load", False)],
}


def _clear_pe() -> None:
    """Drop the cached encoder-probe library and its plans."""
    from ..ops import anatomy
    for f in (anatomy._launcher, anatomy.pe_plan, anatomy._check_pe_plan):
        f.cache_clear()


@contextlib.contextmanager
def variant_build(variant: str):
    """Inside the block, the PE probes launch a build of ``csrc/`` with
    ``VARIANTS[variant]`` applied."""
    from ..ops import _build
    texts = patched_sources(variant, variants=VARIANTS)
    with built_from(texts, _build.BUILD / "ablation" / f"pe_{variant}",
                    _clear_pe):
        yield


def _registers(probe: str, variant: str) -> str:
    """Registers a thread and spill bytes (stores / loads) of the current
    build's kernel for ``probe``, from ptxas."""
    from ..ops import _build, anatomy
    log = _build.build_log("anatomy_pe")
    if probe == "pe_vpu":
        at = log.index("pe_vpu_column_kernel" if variant == "column_a_thread"
                       else "pe_vpu_kernel")
    else:
        at = log.index(f"pe_mm_hopper_kernelILi{anatomy.PE_TERMS[probe]}EE")
    regs = re.search(r"Used (\d+) registers", log[at:]).group(1)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      log[at:])
    return f"{regs} registers, spill {spill.group(1)} / {spill.group(2)} B"


def main(n: int = 524_288, device=None, probes=tuple(RUNS)) -> Dict:
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
        for probe in probes:
            variants = RUNS[probe]
            shipped = anatomy.PROBES[probe](*ops)
            runs = [("shipped", None, True)] + variants + \
                [("shipped", None, True)]
            for variant, patch, exact in runs:
                key = f"{probe}@{variant}"
                ctx = contextlib.nullcontext() if patch is None \
                    else variant_build(patch)
                with ctx:
                    fn = (lambda p=anatomy.PROBES[probe]: p(*ops))
                    got = fn()                                # warm up
                    if exact and not torch.equal(got, shipped):
                        raise RuntimeError(f"{key} differs from the shipped "
                                           f"build")
                    del got
                    call, _ = per_call_ms(fn)
                    queued, queued_all = queued_ms(fn)
                    regs_used = _registers(probe, variant)
                row = rows.setdefault(key, {"per_call_ms": [],
                                            "device_ms": [], "registers": []})
                row["per_call_ms"].append(call)
                row["device_ms"].append(queued)
                row["registers"].append(regs_used)
                print(f"[pe] {key:26s} per call {call:.4f} ms, queued "
                      f"{queued:.4f} ms a call (windows: "
                      f"{[round(t, 4) for t in queued_all]}), {regs_used}"
                      f"{'' if exact else ' (time only)'}",
                      flush=True)
            if probe == "pe_vpu":
                # the output's bytes alone: torch's fill of an (n, 128) f32
                # tensor, the same 268 MB written and nothing read
                dst = torch.empty_like(shipped)
                fill, _ = queued_ms(lambda: dst.fill_(1.0))
                rows["torch_fill"] = {"device_ms": [fill]}
                print(f"[pe] {'torch fill_ of the output':26s} queued "
                      f"{fill:.4f} ms a call", flush=True)
                del dst
            del shipped
    out = {"device": torch.cuda.get_device_name(dev), "power": smi, "n": n,
           "ms": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=524_288)
    ap.add_argument("probes", nargs="*", default=list(RUNS),
                    help=f"of {list(RUNS)}")
    a = ap.parse_args()
    main(n=a.n, probes=a.probes)
