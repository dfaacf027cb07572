"""The share of the traced mip-NeRF train window in which no kernel ran:
100 minus the union of the kernels' intervals over the window's host
seconds."""


def read(w, cell):
    if not w.kernels or w.seconds <= 0 or not w.counts.get("sub_steps"):
        return None
    return 100.0 * (1.0 - w.busy_s / w.seconds)
