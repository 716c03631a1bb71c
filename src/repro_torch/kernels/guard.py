"""The kernels have no backward, and take local tensors.

A wrapper fills its output through ``ctypes``, so the output carries no
``grad_fn``: a loss taken through a launch would backpropagate without
error and leave every parameter upstream of the kernel without a gradient.
Each wrapper calls :func:`refuse_autograd` on its CUDA launch path, so such
a launch raises instead.  Serving launches under ``torch.no_grad()`` or on
inputs that need no gradient, and is not affected.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise if a DTensor reaches a kernel wrapper.  The wrappers take each
    rank's local shard (the models pass ``to_local()``); on a DTensor the
    plain version would run through DTensor's dispatch instead of the
    kernel."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"the {kernel} wrapper takes local tensors, not DTensors: "
                        f"pass each rank's shard (DTensor.to_local())")


def refuse_autograd(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a launch of ``kernel`` on ``tensors``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward: an input requires grad, so "
            f"the gradients upstream of it would be lost. Train with "
            f'impl="blocked", or launch it under torch.no_grad()')
