"""Attribute the fused kernel's time: the matmul-chain ceiling of its
building blocks, the cost of the skip as a concat against a split
contraction, and the PE as a matmul against multiply-adds.

    python -m nerf_fl_torch.experiments.kernel_anatomy [--device cpu]

Counterpart of ``experiments/kernel_anatomy.py``, under its result names.
Operands come from ``ops/anatomy.chain_operands`` (that file's draws, seed
0) and ``pe_mm_rows``; the kernels are ``csrc/anatomy_chain.cu`` and
``csrc/anatomy_pe.cu``.  The JAX file runs ``chain8_kernel`` under the TPU
grid semantics "arbitrary" and "parallel"; a CUDA grid has no such switch,
so one kernel is timed once and reported under both names.  See the
package docstring for how the timing differs from the JAX file's.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..device import resolve_device
from ..ops import anatomy
from . import N_POINTS, REPS, bench, cli, report

RESULT_NAMES = ("chain8_arbitrary", "chain8_parallel", "chain8_concat_skip",
                "chain8_split_skip", "pe_matmul_f32", "pe_vpu_bcast",
                "sin_only", "pe_matmul_bf16")


def main(device=None, n: int = N_POINTS, reps: int = REPS,
         out: Optional[str] = None) -> Dict[str, object]:
    dev = resolve_device(device)
    P = anatomy.PROBES
    o = anatomy.chain_operands(n, 0, dev)
    plain, skip = anatomy.chain_inputs(o, False), anatomy.chain_inputs(o, True)
    rows = anatomy.pe_mm_rows(dev) + [o["x128"]]
    ms: Dict[str, float] = {}

    def run(name, probe, ops):
        ms[name] = bench(name, lambda: P[probe](*ops), n, dev, reps)

    run("chain8_arbitrary", "chain8", plain)
    ms["chain8_parallel"] = ms["chain8_arbitrary"]
    print(f"chain8_parallel: {ms['chain8_parallel']:.3f} ms (the same "
          f"launches: a CUDA grid has one semantics)", flush=True)
    run("chain8_concat_skip", "concat", skip)
    run("chain8_split_skip", "split", skip)
    run("pe_matmul_f32", "pe_mm", rows)
    run("pe_vpu_bcast", "pe_vpu", rows)
    run("sin_only", "sin", [o["x128"]])
    run("pe_matmul_bf16", "pe_mm_bf16", rows)
    assert tuple(ms) == RESULT_NAMES
    return report(ms, dev, n, reps, out)


if __name__ == "__main__":
    cli(main, __doc__)
