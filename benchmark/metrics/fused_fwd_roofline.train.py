"""Roofline share of the fused forward launches of the train sub-steps:
their least time on the card (benchmark/flops.py:fused_fwd over the
peaks) over their device time in the trace, in percent."""
from benchmark import flops, trace


def read(w, cell):
    n = w.counts.get("sub_steps")
    t = w.kernel_seconds(trace.FWD)
    if not n or not w.fused_ok or t <= 0:
        return None
    least = sum(flops.least_seconds(*flops.fused_fwd(cell.config, *launch),
                                    cell.peak_flops, cell.peak_bw)
                for launch in flops.train_launches(cell.config))
    return 100.0 * least * n / t
