"""Device milliseconds a mip-NeRF train sub-step of the stage `pdf`: level
1's resampling (the blurred weights, the piecewise-constant pdf and its
search, the new interval edges), by the program's stage marks
(benchmark/stages.py)."""
from benchmark import stages


def read(w, cell):
    segs = stages.sub_steps(w, cell)
    if segs is None:
        return None
    return stages.ms(segs, ("pdf",), len(segs))
