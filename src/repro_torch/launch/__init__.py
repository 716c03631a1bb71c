"""Launch-level pieces of the port: the batched server, the train step, the
meta-device trace analysis (rung 1's counts) and the mesh constructors."""
from repro_torch.launch.mesh import (init_process_group, make_host_mesh,
                                     make_production_mesh)

__all__ = ["init_process_group", "make_host_mesh", "make_production_mesh"]
