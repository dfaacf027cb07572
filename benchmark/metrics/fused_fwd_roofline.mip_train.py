"""Roofline share of the IPE forward launches of the traced mip-NeRF
sub-steps (one a level): their least time on the card
(benchmark/flops_mip.py:fused_fwd over the peaks) over the device time of
the fused forward's records, in percent."""
from benchmark import flops, flops_mip, trace


def read(w, cell):
    n = w.counts.get("sub_steps")
    t = w.kernel_seconds(trace.FWD)
    if not n or not w.fused_ok or t <= 0:
        return None
    least = sum(flops.least_seconds(*flops_mip.fused_fwd(cell.config, p),
                                    cell.peak_flops, cell.peak_bw)
                for p in flops_mip.launches(cell.config))
    return 100.0 * least * n / t
