"""Device milliseconds a frame of the GEMM kernels in the traced frames:
the eval coarse pass's plain matmuls (the fine pass runs the fused
kernel, and no other matmul runs in a frame)."""
from benchmark import trace


def read(w, cell):
    frames = w.counts.get("frames")
    if not frames or not w.fused_ok:
        return None
    t = w.kernel_seconds(trace.GEMM)
    return 1e3 * t / frames if t > 0 else None
