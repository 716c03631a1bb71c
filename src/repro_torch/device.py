"""Device resolution for the port's entry points.

The port's entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and on a host without a CUDA device it
raises instead of quietly running the CPU path.  Tests and CPU tooling pass
``device="cpu"``.

A CUDA device also gets IEEE fp32 matrix products: the correctness gate holds
fp32 results to ``CORRECTNESS_TOL = 2e-5``, which TF32 (about three decimal
digits) fails, so the fp32 oracle must not run in TF32.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run its plain PyTorch path")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def device_name(device: torch.device) -> str:
    """The name a result is filed under: the card's, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
