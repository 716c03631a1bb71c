"""Launch-level pieces of the port: the batched server and the meta-device
trace analysis (rung 1's counts)."""
