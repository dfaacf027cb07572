"""Device milliseconds a mip-NeRF train sub-step of the stage `cast` at
both levels (each interval's conical-frustum Gaussian and the IPE kernels'
operand rows), by the program's stage marks (benchmark/stages.py); None
where the program has no `cast` mark."""
from benchmark import stages


def read(w, cell):
    segs = stages.sub_steps(w, cell)
    if segs is None or not any("cast" in s for s in segs):
        return None
    return stages.ms(segs, ("cast",), len(segs))
