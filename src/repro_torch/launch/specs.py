"""Meta-device stand-ins for every (architecture x shape cell): the
counterpart of ``repro.launch.specs``.

The JAX package lowers against ``ShapeDtypeStruct``s; the port traces on
tensors of the ``meta`` device, which carry shape, dtype and (as DTensors)
placements and allocate nothing.  Under an active mesh
(``distributed.context.set_mesh``) the parameters and AdamW moments are
DTensors placed by ``sharding.param_shardings`` and the decode cache is in
the layout the port executes with (``models.init_decode_cache``: rows over
the data axes, KV or Mamba heads over "model"; where the data axes do not
divide the batch, an attention cache's length over them, as the JAX
package's ``cache_shardings`` puts it for the ``long_500k`` cell's batch of
1, and on the head fallback the length over "model"; the head dim, and the
Mamba state over the data axes, stay whole).  The
batch and the decode tokens are the global ones:
the port's entry points take the global batch on every rank and cut this
rank's rows themselves (``spmd.local_rows``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import context as ctx
from repro_torch.distributed.sharding import distribute_params, param_shardings
from repro_torch.models import init_decode_cache, init_params
from repro_torch.optim import AdamWState, adamw_init

META = torch.device("meta")


def batch_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """The global train / prefill batch: int64 tokens and labels (B, S), as
    ``lm_loss`` takes them, and the modality extras."""
    B, S = cell.global_batch, cell.seq_len
    batch = {"tokens": torch.empty((B, S), dtype=torch.int64, device=META),
             "labels": torch.empty((B, S), dtype=torch.int64, device=META)}
    if cfg.modality == "vision" and cfg.n_prefix_embeds:
        batch["prefix_embeds"] = torch.empty((B, cfg.n_prefix_embeds, cfg.d_model),
                                             dtype=torch.bfloat16, device=META)
    if cfg.enc_dec:
        batch["enc_frames"] = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                                          device=META)
    return batch


def param_specs(cfg: ArchConfig, dtype=torch.float32):
    """(parameters on meta, their spec tree): matrices in ``dtype`` (fp32,
    as the JAX package's and the train step's; the server's are bf16).
    Under the active mesh DTensors placed by ``param_shardings`` (no
    allocation, no communication), with no mesh plain meta tensors and
    spec None."""
    params = init_params(cfg, torch.Generator().manual_seed(0), device=META, dtype=dtype)
    mesh = ctx.get_mesh()
    if mesh is None:
        return params, None
    return distribute_params(params, mesh, cfg), param_shardings(params, mesh, cfg)


def opt_specs(params) -> AdamWState:
    """AdamW's state for ``params``: the moments on meta, placed as the
    parameters; the step counter a CPU scalar, since the update reads it
    on the host (``int(state.step)``), which a meta tensor cannot give."""
    state = adamw_init(params)
    return AdamWState(torch.zeros((), dtype=torch.int32), state.mu, state.nu)


def cache_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """The decode cache of a decode cell (batch B, length seq_len; an
    encoder-decoder's cross cache of min(seq_len, 4096) frames), on meta,
    in the layout the port executes with under the active mesh."""
    enc_len = min(cell.seq_len, 4096) if cfg.enc_dec else 0
    return init_decode_cache(cfg, cell.global_batch, cell.seq_len, enc_len=enc_len,
                             device=META)


def token_specs(cfg: ArchConfig, cell: ShapeCell) -> torch.Tensor:
    """One decode step's global tokens (B,)."""
    return torch.empty((cell.global_batch,), dtype=torch.int64, device=META)
