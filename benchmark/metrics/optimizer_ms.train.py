"""Device milliseconds a train sub-step of the stage `optimizer` (Adam's
step and, under pose refinement, the pose deltas' scaled update), by the
program's stage marks (benchmark/stages.py)."""
from benchmark import stages


def read(w, cell):
    segs = stages.sub_steps(w, cell)
    if segs is None:
        return None
    return stages.ms(segs, ("optimizer",), len(segs))
