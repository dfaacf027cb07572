"""Device milliseconds a frame of the renderer's sampling: the stages
`sample` (stratified depths, the coarse points) and `pdf` (the fine
samples drawn from the coarse weights, merged, the fine points), by the
program's stage marks (benchmark/stages.py)."""
from benchmark import stages


def read(w, cell):
    segs = stages.chunks(w, cell)
    if segs is None:
        return None
    return stages.ms(segs, ("sample", "pdf"), w.counts["frames"])
