"""Launch-level pieces of the port: the batched server, the train step, the
meta-device trace analysis (rung 1's counts, the dry run's collectives and
memory), the mesh constructors, and the dry run (``python -m
repro_torch.launch.dryrun`` / ``roofline``, imported by name only)."""
from repro_torch.launch.mesh import (init_process_group, make_host_mesh,
                                     make_production_mesh)

__all__ = ["init_process_group", "make_host_mesh", "make_production_mesh"]
