"""Training step factory: the counterpart of ``repro.launch.train``.

train_step = microbatched gradient accumulation -> optional gradient
compression (bf16 / int8 + error feedback) -> global-norm clip -> AdamW.

Where the JAX package scans over the microbatches and returns new trees,
the port runs one backward per microbatch, accumulating the fp32 gradients
in each parameter's ``.grad``, and updates the parameters and moments in
place (``optim.adamw``).  Parameters are fp32 leaves that require grad;
compute runs in ``compute_dtype``, cast at each use as in the forward path.
``impl=None`` means ``"blocked"`` on every device: the hand-written kernels
have no backward (they refuse inputs that require grad), and the JAX
package's training path takes its blocked references too.

Under a mesh (``distributed.context.set_mesh``) the parameters and AdamW
moments are DTensors placed by ``sharding.param_shardings``
(``init_train_state`` places them when a mesh is active).  The batch is the global batch, the same on
every rank; microbatch i is its rows i*mb..(i+1)*mb-1, split over the
data-parallel ranks (which must divide it), as the JAX package splits it.
The backward leaves each parameter's gradient placed as the parameter,
each pod's own (``Partial`` over "pod"); ``collectives.reduce_gradients``
sums them over "pod" in the compressed dtype before clipping and AdamW
(with no mesh it is ``apply_grad_compression``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed import context as ctx
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import distribute_params
from repro_torch.models import init_params, lm_loss
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def default_microbatches(cfg: ArchConfig, global_batch: int,
                         seq_len: Optional[int] = None,
                         dp_shards: Optional[int] = None,
                         model_shards: Optional[int] = None,
                         act_budget_bytes: float = 6e9) -> int:
    """Pick the microbatch count so the per-device live temp fits memory:
    the JAX package's arithmetic, unchanged.

    Dominant live terms under per-period remat:
      * saved residuals: n_periods x tokens/nm x d_model x 2B
      * fp32 logits:     tokens/nm x vocab/model_shards x 4B
    Smallest nm keeping their sum under ``act_budget_bytes``.  The default,
    6 GB, is the JAX package's budget for a TPU v5e's 16 GB; it makes no
    claim for the card, whose callers pass a budget or an explicit count.
    Without ``seq_len`` falls back to the legacy logits-only bound.
    ``dp_shards`` and ``model_shards`` None are read from the active mesh,
    as the JAX package's dry run reads them (1 without a mesh; the model
    axis counts only where it divides the vocab).
    """
    if dp_shards is None:
        dp_shards = 1
        for a in ctx.batch_axes():
            dp_shards *= ctx.axis_size(a)
    if model_shards is None:
        mdl = ctx.axis_size("model")
        model_shards = mdl if cfg.vocab_size % mdl == 0 else 1
    if seq_len is None:
        for nm in (1, 2, 4, 8, 16, 32):
            if global_batch % nm == 0 and \
                    (global_batch // nm) * cfg.vocab_size <= (1 << 31):
                return nm
        return 32
    tokens_chip = global_batch * seq_len / max(dp_shards, 1)
    vocab_shard = cfg.vocab_size / max(model_shards, 1)
    for nm in (1, 2, 4, 8, 16, 32, 64, 128):
        if global_batch % nm:
            continue
        residuals = cfg.n_periods * (tokens_chip / nm) * cfg.d_model * 2
        logits = (tokens_chip / nm) * vocab_shard * 4
        moe_bufs = 0.0
        if cfg.moe is not None:
            # gate/up/down dispatch buffers: ~3 x capacity x d_model x bf16
            moe_bufs = (3 * (tokens_chip / nm) * cfg.moe.top_k
                        * cfg.moe.capacity_factor * cfg.d_model * 2)
        if residuals + logits + moe_bufs <= act_budget_bytes:
            return nm
    return 128


def batch_to_device(batch: dict, device) -> dict:
    """A pipeline batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    n_microbatches: int = 1, compression: str = "none",
                    compute_dtype=torch.bfloat16, impl: Optional[str] = None,
                    genome: Optional[dict] = None):
    """``train_step(params, opt_state, residual, batch) -> (params,
    opt_state, residual, metrics)``; ``params`` and ``opt_state`` are
    updated in place and returned, metrics are ``loss`` (the mean over the
    microbatches), ``grad_norm`` (before clipping) and ``lr``."""
    opt_cfg = opt_cfg or AdamWConfig()
    impl = impl or "blocked"
    nm = n_microbatches

    def train_step(params, opt_state, residual, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        B = batch["tokens"].shape[0]
        if B % nm:
            raise ValueError(f"batch {B} does not split into {nm} microbatches")
        mb = B // nm
        lsum = None
        for i in range(nm):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = lm_loss(params, cfg, micro, compute_dtype=compute_dtype,
                           impl=impl, genome=genome)
            loss.backward()
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        grads = tree_map(lambda p: spmd.zero_grad(p) if p.grad is None else p.grad,
                         params)
        for p in leaves:
            p.grad = None
        if nm > 1:
            for g in tree_leaves(grads):
                ctx.local(g).div_(nm)       # every rank's part of a partial sum too
        grads, residual = collectives.reduce_gradients(grads, params, compression, residual)
        params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = lsum / nm
        return params, opt_state, residual, metrics

    return train_step


def init_train_state(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                     device=None, compression: str = "none"):
    """Random fp32 parameters (``init_params``; ``generator`` None: seed 0 on
    ``device``), zero AdamW moments and, for ``int8_ef``, zero residuals.
    ``device`` None is the card.  Under an active mesh every rank draws the
    same full weights and keeps its shards."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, generator, device=device, dtype=torch.float32)
    if ctx.get_mesh() is not None:
        params = distribute_params(params, ctx.get_mesh(), cfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt_state = adamw_init(params)
    residual = (collectives.compress_init(params)
                if compression == "int8_ef" else None)
    return params, opt_state, residual
