"""Host utilities of the port: the CLI flags and depth visualization."""
