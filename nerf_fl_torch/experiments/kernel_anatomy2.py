"""Incremental builds of the fused kernel, to find where its time goes:

  staticnet         trunk of 8 at the real padded shapes + fs2 + dir + rgb,
                    from pre-encoded inputs
  fullnet_nope      the same plus the transient branch
  pe_only_vpu       the fused kernel's encoders alone
  staticnet_consol  staticnet with its operands consolidated

    python -m nerf_fl_torch.experiments.kernel_anatomy2 [--device cpu]

Counterpart of ``experiments/kernel_anatomy2.py``, under its result names.
Operands come from ``ops/anatomy.net_operands`` (that file's draws, seed 0)
and ``encoder_rows``; the kernels are ``csrc/anatomy_net.cu`` and
``csrc/anatomy_pe.cu``.  See the package docstring for how the timing
differs from the JAX file's.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..device import resolve_device
from ..ops import anatomy
from . import N_POINTS, REPS, bench, cli, report

RESULT_NAMES = ("staticnet", "fullnet_nope", "pe_only_vpu",
                "staticnet_consol")


def main(device=None, n: int = N_POINTS, reps: int = REPS,
         out: Optional[str] = None) -> Dict[str, object]:
    dev = resolve_device(device)
    P = anatomy.PROBES
    o = anatomy.net_operands(n, 0, dev)
    ms: Dict[str, float] = {}

    def run(name, probe, ops):
        ms[name] = bench(name, lambda: P[probe](*ops), n, dev, reps)

    run("staticnet", "static", anatomy.net_inputs(o, "static"))
    run("fullnet_nope", "full", anatomy.net_inputs(o, "full"))
    run("pe_only_vpu", "pe_only", anatomy.encoder_rows(dev) + [o["inp"]])
    run("staticnet_consol", "consol", anatomy.net_inputs(o, "consol"))
    assert tuple(ms) == RESULT_NAMES
    return report(ms, dev, n, reps, out)


if __name__ == "__main__":
    cli(main, __doc__)
