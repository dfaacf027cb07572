"""Model operations of the traced frames (the sigma-only coarse pass and
the fine pass for the rays a frame needs, benchmark/flops.py:frame_flops)
over the window's host seconds, as a percentage of the card's peak."""
from benchmark import flops


def read(w, cell):
    frames = w.counts.get("frames")
    if not frames or w.seconds <= 0:
        return None
    return 100.0 * flops.frame_flops(cell.config, cell.rays_per_frame) \
        * frames / w.seconds / cell.peak_flops
