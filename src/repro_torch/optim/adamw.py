"""AdamW + global-norm clipping + warmup-cosine schedule: the counterpart of
``repro.optim.adamw``.

The JAX package updates functionally and returns new trees.  The port
updates every leaf in place under ``torch.no_grad()``, one leaf at a time:
the gradient is clipped in place, then the moments, then the parameter.  A
functional update would hold a second copy of the parameters and moments,
and a ``torch._foreach_*`` chain full-size temporaries of every leaf at
once; here the transient memory is one leaf (the denominator).  The
arithmetic is the JAX package's,

    m <- b1 m + (1 - b1) g        v <- b2 v + (1 - b2) g^2
    p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)

with m_hat = m / (1 - b1^t) and v_hat = v / (1 - b2^t), evaluated as
p (1 - lr wd) - (lr / (1 - b1^t)) m / (sqrt(v_hat) + eps), which rounds
differently in the last bits.  The schedule and the bias corrections are
Python floats (the JAX package computes them in float32).

The leaves may be DTensors (a training state under a mesh), each gradient
placed as its parameter and moments are.  The global norm is then a full
reduction over every shard, and the update runs on each rank's local
shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.tree import tree_leaves, tree_map, zeros_like


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32 on the parameters' device
    mu: dict
    nu: dict


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params) -> AdamWState:
    device = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(zeros_like, params), tree_map(zeros_like, params))


def schedule(cfg: AdamWConfig, step) -> float:
    step = float(step)
    warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (0-d tensor)."""
    sq = [_square_norm(x) for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def _square_norm(x) -> torch.Tensor:
    """The squared norm of a leaf; of a DTensor, over all its shards."""
    if not isinstance(x, DTensor):
        return torch.linalg.vector_norm(x, dtype=torch.float32).square()
    sq = torch.linalg.vector_norm(x.to_local(), dtype=torch.float32).square()
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            dist.all_reduce(sq, group=x.device_mesh.get_group(i))
        elif not isinstance(pl, Replicate):
            raise ValueError(f"a leaf placed {x.placements}: reduce it first")
    return sq


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    for g in tree_leaves(grads):
        _local(g).mul_(scale)
    return grads, gn


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step, in place: ``grads`` are clipped in place (fp32 leaves;
    others are converted first), ``state`` and ``params`` are updated in
    place and returned with ``{"grad_norm", "lr"}``."""
    grads = tree_map(lambda g: g if g.dtype == torch.float32 else g.float(), grads)
    grads, gn = clip_by_global_norm(grads, cfg.max_grad_norm)
    state.step.add_(1)
    step = int(state.step)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(state.mu), tree_leaves(state.nu)):
        p, g, m, v = (_local(t) for t in leaf)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        denom = torch.div(v, b2c).sqrt_().add_(cfg.eps)
        p.mul_(1 - lr * cfg.weight_decay).addcdiv_(m, denom, value=-lr / b1c)
        del denom
    return params, state, {"grad_norm": gn, "lr": lr}
