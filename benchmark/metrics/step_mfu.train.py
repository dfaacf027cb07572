"""Model operations of the traced window's train sub-steps over its host
seconds, as a percentage of the card's peak for the configuration's
dtype (benchmark/flops.py:train_flops)."""
from benchmark import flops


def read(w, cell):
    n = w.counts.get("sub_steps")
    if not n or w.seconds <= 0:
        return None
    return 100.0 * flops.train_flops(cell.config) * n / w.seconds \
        / cell.peak_flops
