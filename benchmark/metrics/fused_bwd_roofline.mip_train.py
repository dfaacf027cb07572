"""Roofline share of the IPE backward launches of the traced mip-NeRF
sub-steps (one a level): the least time of their wgrad and needed dgrad
(benchmark/flops_mip.py:fused_bwd) over the device time of the backward
wrapper's kernels (the fused dgrad kernel, the wgrad kernel and the
reductions), in percent."""
from benchmark import flops, flops_mip, trace


def read(w, cell):
    n = w.counts.get("sub_steps")
    t = w.kernel_seconds(trace.BWD)
    if not n or not w.fused_ok or t <= 0:
        return None
    least = sum(flops.least_seconds(*flops_mip.fused_bwd(cell.config, p),
                                    cell.peak_flops, cell.peak_bw)
                for p in flops_mip.launches(cell.config))
    return 100.0 * least * n / t
