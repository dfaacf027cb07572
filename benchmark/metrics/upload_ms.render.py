"""Host milliseconds a frame inside the program's `nerf.render.upload`
spans: each chunk's pad and copy to the card, which waits for the work
queued before it where the rays lie in pageable memory."""
from benchmark import stages


def read(w, cell):
    return stages.host_ms(w, "nerf.render.upload", w.counts.get("frames"))
