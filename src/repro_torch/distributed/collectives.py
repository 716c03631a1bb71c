"""Gradient compression with error feedback: the arithmetic of
``repro.distributed.collectives`` that the train step applies.

The JAX package casts the gradients before the cross-pod reduction, so XLA
emits the all-reduce in the compressed dtype.  On one device the port
applies the same round trip: bf16 (2x fewer bytes), or int8 with a
per-tensor scale and an error-feedback residual carried into the next step
(4x).  ``torch.round`` and ``jnp.round`` both round half to even, so the
int8 codes equal the JAX package's.  Communication hooks that reduce in the
compressed dtype wait for the multi-device item (ROADMAP Queue 1 item 12).

The functions are functional, as the JAX package's are: each returns new
trees and leaves its inputs alone.  ``apply_grad_compression`` with
``bf16`` builds a second full-size gradient tree; with ``int8_ef`` it
builds a dequantised gradient tree and a new residual tree, so two
full-size fp32 trees exist beside the inputs until the caller drops them.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def compress_init(grads):
    """Error-feedback residual buffers (zeros, same structure as grads)."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def compress_bf16(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads):
    return tree_map(lambda g: g.to(torch.float32), grads)


def _int8(g, r):
    gf = g.float() + r
    scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
    qv = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_r = gf - qv.float() * scale
    return qv, scale, new_r


def compress_int8_ef(grads, residual):
    """Quantize (grad + residual) to int8 with per-tensor scale; return
    (quantized int8, scales, new_residual)."""
    out = tree_map(_int8, grads, residual)
    unzip = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    return unzip(0), unzip(1), unzip(2)


def decompress_int8(qgrads, scales):
    return tree_map(lambda q, s: q.float() * s, qgrads, scales)


@torch.no_grad()
def apply_grad_compression(grads, method: str, residual=None):
    """The round trip at the microbatch-reduction boundary.  Returns
    (grads_f32, new_residual)."""
    if method == "none":
        return grads, residual
    if method == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).float(), grads), residual
    if method == "int8_ef":
        if residual is None:
            raise ValueError("int8_ef needs error-feedback buffers")
        def round_trip(g, r):
            qv, scale, new_r = _int8(g, r)
            return qv.float() * scale, new_r

        out = tree_map(round_trip, grads, residual)
        return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)
    raise ValueError(f"unknown compression {method!r}")
