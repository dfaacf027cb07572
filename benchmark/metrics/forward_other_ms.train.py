"""Device milliseconds a train sub-step of the forward outside the fused
forward kernel: the stages `load` through `loss` (the batch gather, the
renderer's sampling and compositing, the MLPs' operand packing, the loss),
the pose path aside, by the program's stage marks (benchmark/stages.py)."""
from benchmark import stages, trace


def read(w, cell):
    segs = stages.sub_steps(w, cell)
    if segs is None:
        return None
    return stages.ms(segs, stages.FORWARD, len(segs), exclude=trace.FWD)
