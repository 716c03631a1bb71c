"""Shared layers: norms, rotary embeddings, MLP variants, initializers.

The counterpart of ``repro.models.layers``.  Parameters are plain tensors in
nested dicts with the JAX package's layout, so weights convert array for
array (``models/convert.py``).  Every cast mirrors the JAX package's, so a
result in a given compute dtype is rounded at the same points.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, Block


def normal_init(gen: torch.Generator, shape, *, scale: float = 0.02,
                device=None, dtype=torch.float32) -> torch.Tensor:
    """N(0, scale^2) drawn with ``gen`` directly on ``device`` in ``dtype``.
    The ``*_init`` functions take ``lead``, a shape prefix: the stack of
    periods, drawn in one tensor so the full-width weights are never copied."""
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.normal_(0.0, scale, generator=gen)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_apply(x, w, cfg: ArchConfig, b=None):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + cfg.norm_eps)
        # gemma-style (1 + w) scaling when post_norms is on
        scale = (1.0 + w.float()) if cfg.post_norms else w.float()
        out = xf * scale
    else:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * w.float()
        if b is not None:
            out = out + b.float()
    return out.to(x.dtype)


def norm_init(cfg: ArchConfig, shape_d: int, device=None, lead=()) -> torch.Tensor:
    fill = torch.zeros if (cfg.norm == "rmsnorm" and cfg.post_norms) else torch.ones
    return fill((*lead, shape_d), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_apply(x, pos, theta: float):
    """x: (..., S, H, Dh) or (..., H, Dh) with matching pos (..., S) or scalar."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=x.device)
    ang = pos[..., None] * freqs                       # (..., S, half) or (half,)
    cos = torch.cos(ang)[..., None, :]                 # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_init(gen, cfg: ArchConfig, blk: Block, *, device=None,
             dtype=torch.float32, lead=()):
    D, Fd = cfg.d_model, cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    p = {"norm": norm_init(cfg, D, device, lead)}
    if blk.mlp in ("gated_silu", "gated_gelu"):
        p["w_gate"] = normal_init(gen, (*lead, D, Fd), **kw)
        p["w_up"] = normal_init(gen, (*lead, D, Fd), **kw)
        p["w_down"] = normal_init(gen, (*lead, Fd, D), **kw)
    elif blk.mlp in ("squared_relu", "relu"):
        p["w_up"] = normal_init(gen, (*lead, D, Fd), **kw)
        p["w_down"] = normal_init(gen, (*lead, Fd, D), **kw)
    else:
        raise ValueError(blk.mlp)
    if cfg.post_norms:
        p["post_norm"] = norm_init(cfg, D, device, lead)
    return p


def mlp_apply(x, p, cfg: ArchConfig, blk: Block, compute_dtype):
    h = norm_apply(x, p["norm"], cfg).to(compute_dtype)
    cd = compute_dtype
    if blk.mlp == "gated_silu":
        a = F.silu(h @ p["w_gate"].to(cd))
        h = (a * (h @ p["w_up"].to(cd))) @ p["w_down"].to(cd)
    elif blk.mlp == "gated_gelu":
        a = F.gelu(h @ p["w_gate"].to(cd), approximate="tanh")
        h = (a * (h @ p["w_up"].to(cd))) @ p["w_down"].to(cd)
    elif blk.mlp == "squared_relu":
        a = F.relu(h @ p["w_up"].to(cd))
        h = (a * a) @ p["w_down"].to(cd)
    elif blk.mlp == "relu":
        a = F.relu(h @ p["w_up"].to(cd))
        h = a @ p["w_down"].to(cd)
    if cfg.post_norms:
        h = norm_apply(h, p["post_norm"], cfg)
    return x + h.to(x.dtype)


def logit_softcap(logits, cap: float):
    return cap * torch.tanh(logits / cap) if cap else logits
