"""Launch-level pieces of the port: the batched server, the train step and
the meta-device trace analysis (rung 1's counts)."""
