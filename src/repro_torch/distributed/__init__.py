"""What the port has of ``repro.distributed``: the gradient compression the
train step applies (``collectives``) and checkpoint-restart
(``fault_tolerance``).  Meshes, sharding and communication hooks wait for
the multi-device item (ROADMAP Queue 1 item 12)."""
from repro_torch.distributed.collectives import (apply_grad_compression,
                                                 compress_bf16, compress_init,
                                                 compress_int8_ef, decompress_bf16,
                                                 decompress_int8)

__all__ = ["apply_grad_compression", "compress_bf16", "compress_init",
           "compress_int8_ef", "decompress_bf16", "decompress_int8"]
