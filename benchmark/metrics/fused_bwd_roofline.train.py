"""Roofline share of the fused backward of the train sub-steps: the least
time of their dgrad and wgrad (benchmark/flops.py:fused_bwd) over the
device time of the backward wrapper's kernels (the fused dgrad kernel,
the wgrad kernel and the reductions), in percent."""
from benchmark import flops, trace


def read(w, cell):
    n = w.counts.get("sub_steps")
    t = w.kernel_seconds(trace.BWD)
    if not n or not w.fused_ok or t <= 0:
        return None
    least = sum(flops.least_seconds(*flops.fused_bwd(cell.config, *launch),
                                    cell.peak_flops, cell.peak_bw)
                for launch in flops.train_launches(cell.config))
    return 100.0 * least * n / t
