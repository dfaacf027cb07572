"""Device milliseconds a frame of the renderer's compositing: the stages
`coarse_composite` and `fine_composite` (the static and transient fields
together and, at test time, each alone), by the program's stage marks
(benchmark/stages.py)."""
from benchmark import stages


def read(w, cell):
    segs = stages.chunks(w, cell)
    if segs is None:
        return None
    return stages.ms(segs, ("coarse_composite", "fine_composite"),
                     w.counts["frames"])
