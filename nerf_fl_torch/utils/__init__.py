"""Host utilities of the port: the CLI flags, depth visualization, and
the tracing (host spans and device stage marks, ``spans.py``)."""
