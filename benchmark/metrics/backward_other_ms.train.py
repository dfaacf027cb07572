"""Device milliseconds a train sub-step of the backward outside the fused
backward's kernels (dgrad, wgrad, reductions): the stage `backward` (the
loss's, the compositing's and the sampling's backward, the gradients'
accumulation), the pose path's backward aside, by the program's stage
marks (benchmark/stages.py)."""
from benchmark import stages, trace


def read(w, cell):
    segs = stages.sub_steps(w, cell)
    if segs is None:
        return None
    return stages.ms(segs, ("backward",), len(segs), exclude=trace.BWD)
