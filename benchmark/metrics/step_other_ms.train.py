"""Device milliseconds a train sub-step of every kernel outside the fused
pair (forward, and the backward wrapper's dgrad, wgrad and reductions):
the renderer, the loss, the optimizer and, under BARF, the pose path."""
from benchmark import trace


def read(w, cell):
    n = w.counts.get("sub_steps")
    if not n or not w.fused_ok:
        return None
    total = sum(k.get("dur", 0) for k in w.kernels) / 1e6
    other = total - w.kernel_seconds(trace.FWD) - w.kernel_seconds(trace.BWD)
    return 1e3 * other / n
