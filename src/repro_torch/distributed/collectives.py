"""Gradient compression with error feedback: the arithmetic of
``repro.distributed.collectives`` that the train step applies, and the
reduction over the mesh's "pod" axis in the compressed dtype.

The JAX package casts the gradients before the cross-pod reduction, so XLA
emits the all-reduce in the compressed dtype.  On one device the port
applies the same round trip: bf16 (2x fewer bytes), or int8 with a
per-tensor scale and an error-feedback residual carried into the next step
(4x).  ``torch.round`` and ``jnp.round`` both round half to even, so the
int8 codes equal the JAX package's.

Under a mesh, ``reduce_gradients`` is the communication hook: it reduces
each gradient DTensor to its parameter's placements, the "pod" axis in the
compressed dtype (bf16: the partial gradients all-reduced in bf16;
int8_ef: one per-tensor scale from an all-reduce MAX of |g + r|, the int8
codes summed in int32, then dequantised; the residual kept per rank and
placed ``Partial`` over "pod", so that its ``full_tensor()`` is the sum of
the pods' residuals).  With one pod that is the round trip above.  With more, the result differs from
compressing the reduced gradient, within the quantisation bound (ROADMAP
Queue 3).

The functions are functional, as the JAX package's are: each returns new
trees and leaves its inputs alone.  ``apply_grad_compression`` with
``bf16`` builds a second full-size gradient tree; with ``int8_ef`` it
builds a dequantised gradient tree and a new residual tree, so two
full-size fp32 trees exist beside the inputs until the caller drops them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial

from repro_torch.distributed import context as ctx
from repro_torch.distributed.spmd import grad_placements, zero_grad
from repro_torch.tree import tree_leaves, tree_map


def compress_init(grads):
    """Error-feedback residual buffers (fp32 zeros, same structure as
    grads); a DTensor's placed as its gradient is, ``Partial`` over "pod"."""
    return tree_map(lambda g: zero_grad(g, dtype=torch.float32), grads)


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


@torch.no_grad()
def reduce_gradients(grads, params, method: str = "none", residual=None):
    """Under the active mesh: each gradient DTensor reduced to its
    parameter's placements, and summed over "pod" in the compressed dtype of
    ``method``: the backward leaves each pod its own gradient, placed
    ``Partial`` over "pod" (``spmd.grad_placements``), and a gradient placed
    otherwise there raises.  Without a mesh, ``apply_grad_compression``.
    Returns (grads_f32, new_residual); the residual's leaves are DTensors
    whose local shard is this rank's own, placed as the parameters but
    ``Partial`` over "pod": the pods' residuals differ, and their sum is
    the error left in the reduced gradient, which ``full_tensor()`` and a
    checkpoint hold."""
    mesh = ctx.get_mesh()
    if mesh is None:
        return apply_grad_compression(grads, method, residual)
    if method not in ("none", "bf16", "int8_ef"):
        raise ValueError(f"unknown compression {method!r}")
    if method == "int8_ef" and residual is None:
        raise ValueError("int8_ef needs error-feedback buffers")
    names = ctx.axis_names()
    ip = names.index("pod") if "pod" in names else None
    pod_group = mesh.get_group("pod") if ip is not None else None
    out_g, out_r = [], []
    res_leaves = tree_leaves(residual) if residual is not None else [None] * len(
        tree_leaves(params))
    for g, p, r in zip(tree_leaves(grads), tree_leaves(params), res_leaves):
        target = list(p.placements)
        if ip is not None:
            if not isinstance(g.placements[ip], Partial):
                raise ValueError(f"a gradient placed {g.placements}: each pod's own "
                                 f"gradient is Partial over 'pod'")
            target[ip] = g.placements[ip]          # pod: summed below
        if tuple(g.placements) != tuple(target):
            g = g.redistribute(mesh, target)
        gl = g.to_local().float()
        if method == "none":
            if pod_group is not None:
                dist.all_reduce(gl, group=pod_group)
        elif method == "bf16":
            b = gl.to(torch.bfloat16)
            if pod_group is not None:
                dist.all_reduce(b, group=pod_group)
            gl = b.float()
        else:
            gf = gl + ctx.local(r)
            amax = gf.abs().max()
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)   # one scale per tensor
            scale = torch.clamp_min(amax, 1e-12) / 127.0
            qv = torch.clamp(torch.round(gf / scale), -127, 127)
            new_r = gf - qv * scale
            if pod_group is not None:
                q32 = qv.to(torch.int32)
                dist.all_reduce(q32, group=pod_group)
                qv = q32.float()
            gl = qv * scale
            out_r.append(DTensor.from_local(new_r, mesh, grad_placements(p), run_check=False))
        out_g.append(DTensor.from_local(gl, mesh, p.placements, run_check=False))
    it_g, it_r = iter(out_g), iter(out_r)
    new_grads = tree_map(lambda _: next(it_g), params)
    if method != "int8_ef":
        return new_grads, residual
    return new_grads, tree_map(lambda _: next(it_r), params)
