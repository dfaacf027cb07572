"""Kernel records a train sub-step in the trace: a count, which the
small kernels around the fused pair (renderer, loss, optimizer) make
up."""


def read(w, cell):
    n = w.counts.get("sub_steps")
    if not n or not w.fused_ok:
        return None
    return len(w.kernels) / n
