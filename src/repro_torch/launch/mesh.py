"""Mesh construction: the counterpart of ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module touches no
process group and no device.  A mesh spans the ranks of the process group
this process has joined (``init_process_group``); its dimensions are named
as the JAX package names them, and ``context.set_mesh`` makes one active.

Nothing here falls back: a card mesh needs a CUDA device and the NCCL
backend, and a process group that is not initialised is an error.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def _device_type(device) -> str:
    return resolve_device(device).type


def init_process_group(store_path: str, rank: int, world_size: int,
                       device=None) -> str:
    """Join a process group of ``world_size`` ranks through a ``file://``
    store at ``store_path`` (a path on a file system every rank sees; the
    file must not exist before the first rank joins).  ``device`` None is
    the card: NCCL, with this rank on card ``rank % device_count``;
    ``"cpu"``: gloo.  Returns the backend's name."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = "nccl"
        if not dist.is_nccl_available():
            raise RuntimeError("the card mesh needs NCCL, and this PyTorch has none")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(backend, init_method=f"file://{store_path}", rank=rank,
                            world_size=world_size)
    return backend


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group (or "
                           "torch.distributed.init_process_group) first")
    return dist.get_world_size()


def make_host_mesh(model: int = 1, device=None, *, pod: Optional[int] = None):
    """A mesh over every rank of the process group: (world / model, model)
    named ("data", "model"); with ``pod``, (pod, world / (pod x model),
    model) named ("pod", "data", "model").  ``device`` None is the card,
    ``"cpu"`` the gloo ranks."""
    n = _world()
    pods = pod or 1
    if n % (model * pods):
        raise ValueError(f"{n} ranks do not split into pod {pods} x model {model}")
    data = n // (model * pods)
    if pod is None:
        return init_device_mesh(_device_type(device), (data, model),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh(_device_type(device), (pods, data, model),
                            mesh_dim_names=("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 pods x
    256 ranks as (pod=2, data=16, model=16); the "pod" axis is pure data
    parallelism across pods.  Raises unless the world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 1
    for s in shape:
        want *= s
    n = _world()
    if n != want:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs {want} "
                         f"ranks; the process group has {n}")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)
