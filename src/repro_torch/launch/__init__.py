"""Launch-level entry points of the port: the batched server."""
