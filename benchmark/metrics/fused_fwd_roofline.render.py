"""Roofline share of the fine pass's fused forward launches in the traced
frames (one a chunk, every chunk padded to the chunk size): their least
time (benchmark/flops.py:fused_fwd) over their device time, in percent."""
from benchmark import flops, trace


def read(w, cell):
    frames = w.counts.get("frames")
    t = w.kernel_seconds(trace.FWD)
    if not frames or not w.fused_ok or t <= 0:
        return None
    m, r = cell.config["model"], cell.config["render"]
    points = cell.chunk * (r["N_samples"] + r["N_importance"])
    least = flops.least_seconds(
        *flops.fused_fwd(cell.config, points, m["N_a"] if m["encode_a"]
                         else 0, m["encode_t"]),
        cell.peak_flops, cell.peak_bw)
    return 100.0 * least * cell.chunks_per_frame * frames / t
