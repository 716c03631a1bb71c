"""The active device mesh: the counterpart of ``repro.distributed.context``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimensions
are named from ``("pod", "data", "model")``, in that order.  With no mesh
set (one device, the CPU tests) every function here answers as for a mesh
of size 1.  The JAX package's ``shard`` constraints have no counterpart:
the models run on each rank's local shards (``spmd``), where the batch and
activation layouts hold by construction.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

_MESH = None


def set_mesh(mesh) -> None:
    """Make ``mesh`` (a ``DeviceMesh``, or None) the active mesh."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def axis_names() -> tuple:
    return tuple(_MESH.mesh_dim_names or ()) if _MESH is not None else ()


def batch_axes() -> tuple:
    """Mesh axes that jointly shard the global batch (pod DP x FSDP data)."""
    names = axis_names()
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(name: str) -> int:
    if name not in axis_names():
        return 1
    return _MESH.size(axis_names().index(name))


def div_axis(n: int, axis: str = "model"):
    """Return ``axis`` if the active mesh can evenly shard a dim of size n."""
    if axis not in axis_names():
        return None
    return axis if n % axis_size(axis) == 0 else None


def batch_spec(n: int):
    """The batch axes if they evenly shard a batch of ``n`` rows, else None
    (the batch stays replicated, as the JAX package's batch rule leaves it)."""
    ba = batch_axes()
    dp = 1
    for a in ba:
        dp *= axis_size(a)
    return ba if ba and n % dp == 0 else None


def length_spec(batch: int, length: int):
    """The batch axes for a decode cache's length of ``length`` keys when
    they do not shard a batch of ``batch`` rows (``batch_spec`` is None)
    and do divide the length, else None.  This is the JAX package's
    ``cache_shardings`` for such a batch (a batch of 1 at 524 288 keys): the
    cache's largest dim over (pod, data).  With one data-parallel rank every
    batch divides, so the length is never split."""
    ba = batch_axes()
    if not ba or batch_spec(batch) is not None:
        return None
    return ba if length % math.prod(axis_size(a) for a in ba) == 0 else None


def length_axes(batch: int, length: int, heads_whole: bool):
    """The axes a self-attention's decode cache of ``length`` keys splits its
    length over: the batch axes where ``length_spec`` puts it there (a
    batch of 1); else "model" where every model rank holds all the heads
    (``heads_whole``: the head fallback) and "model", of more than one
    rank, divides the length; else None.  The reference puts the batch over
    "model" and the length over the data axes there; the port keeps the
    batch over the data axes, and a rank holds and reads the same share."""
    ba = length_spec(batch, length)
    if ba is not None or not heads_whole or axis_size("model") == 1:
        return ba
    return div_axis(length)


def local(x) -> torch.Tensor:
    """This rank's shard of a DTensor as it is placed; a plain tensor as it
    is."""
    return x.to_local() if isinstance(x, DTensor) else x
