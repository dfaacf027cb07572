"""Model operations of the traced window's mip-NeRF sub-steps over its host
seconds, as a percentage of the card's peak for the configuration's dtype
(benchmark/flops_mip.py:train_flops: both levels' forward, times 3)."""
from benchmark import flops_mip


def read(w, cell):
    n = w.counts.get("sub_steps")
    if not n or w.seconds <= 0:
        return None
    return 100.0 * flops_mip.train_flops(cell.config) * n / w.seconds \
        / cell.peak_flops
