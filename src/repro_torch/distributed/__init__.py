"""The port's ``repro.distributed``: the active device mesh (``context``),
the name-based sharding rules as DTensor placements (``sharding``), the
models' collectives on local shards (``spmd``), the gradient compression
and its reduction over the "pod" axis (``collectives``), and
checkpoint-restart (``fault_tolerance``; a sharded state's placements for
a restore: ``sharding.train_state_shardings``)."""
from repro_torch.distributed.collectives import (apply_grad_compression,
                                                 compress_bf16, compress_init,
                                                 compress_int8_ef, decompress_bf16,
                                                 decompress_int8, reduce_gradients)
from repro_torch.distributed.context import get_mesh, set_mesh
from repro_torch.distributed.sharding import (distribute_params, param_shardings, placements,
                                              train_state_shardings)

__all__ = ["apply_grad_compression", "compress_bf16", "compress_init", "compress_int8_ef",
           "decompress_bf16", "decompress_int8", "distribute_params", "get_mesh",
           "param_shardings", "placements", "reduce_gradients", "set_mesh",
           "train_state_shardings"]
