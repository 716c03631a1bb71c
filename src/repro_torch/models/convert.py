"""Weights carried across from the JAX package.

``params_from_jax(cfg, tree)`` takes the tree that the JAX package's
``init_params`` returns (leaves as numpy arrays or anything ``np.asarray``
takes; every block stacked over periods) and returns the port's parameters:
the same nested dicts, the same keys, the same shapes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

# leaves the JAX package uses in fp32: they stay fp32 whatever the dtype
FP32_KEYS = frozenset({"norm", "post_norm", "final_norm", "c_norm", "enc_final_norm",
                       "A_log", "dt_bias", "D_skip", "gate_norm", "conv_b",
                       "bq", "bk", "bv"})


def params_from_jax(cfg: ArchConfig, tree: dict, *, device=None,
                    dtype=torch.float32) -> dict:
    """The port's parameters from the JAX package's.  Matrices are stored in
    ``dtype`` (the JAX package casts them to the compute dtype at every
    use); the leaves of ``FP32_KEYS`` stay fp32."""

    def convert(node, key=None):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        return t.to(device=device, dtype=torch.float32 if key in FP32_KEYS else dtype)

    return convert(tree)
