"""Host milliseconds a frame from the call that enqueues its first chunk
to render_chunked_async's return (the chunks queued, all but the last
`inflight` read back on the way), timed around the call in the traced
frames."""


def read(w, cell):
    d = w.counts.get("dispatch_s")
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
