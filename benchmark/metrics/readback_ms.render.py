"""Host milliseconds a frame inside the program's `nerf.render.readback`
spans: each chunk's outputs copied back to the host, which waits for the
chunk's render."""
from benchmark import stages


def read(w, cell):
    return stages.host_ms(w, "nerf.render.readback", w.counts.get("frames"))
