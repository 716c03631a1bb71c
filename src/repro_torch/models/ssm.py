"""Mamba-2 block (SSD mixer): prefill through the chunked SSD kernel, decode
through the O(1) recurrent update.  The counterpart of ``repro.models.ssm``.

Layout follows the Mamba-2 reference: in_proj -> [z | x | B | C | dt],
depthwise causal conv over [x|B|C], SiLU, SSD, skip (D term), gated RMSNorm,
out_proj.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import norm_apply, norm_init, normal_init


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, H, conv_dim


def mamba_init(gen, cfg: ArchConfig, *, device=None, dtype=torch.float32, lead=()):
    s, d_in, H, conv_dim = _dims(cfg)
    D = cfg.d_model
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + H
    kw = dict(device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)
    return {
        "norm": norm_init(cfg, D, device, lead),
        "in_proj": normal_init(gen, (*lead, D, proj_out), **kw),
        "conv_w": normal_init(gen, (*lead, s.conv_kernel, conv_dim), scale=0.1, **kw),
        "conv_b": torch.zeros((*lead, conv_dim), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(*lead, H).clone(),
        "D_skip": torch.ones((*lead, H), **f32),
        "dt_bias": torch.zeros((*lead, H), **f32),
        "gate_norm": torch.ones((*lead, d_in), **f32),
        "out_proj": normal_init(gen, (*lead, d_in, D), **kw),
    }


def _split_proj(proj, cfg):
    s, d_in, H, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(proj, [d_in, d_in, gn, gn, H], dim=-1)   # z, x, B, C, dt


def _gated_norm(y, z, w, eps):
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + eps)
    return g * w.float()


def mamba_apply(x, p, cfg: ArchConfig, compute_dtype, impl=None):
    """Full-sequence path (prefill).  x: (B, S, D).  Returns the new x and
    the decode-resumable cache pieces: the final SSM state and the conv tail."""
    s, d_in, H, conv_dim = _dims(cfg)
    B, S, D = x.shape
    h = norm_apply(x, p["norm"], cfg).to(compute_dtype)
    proj = h @ p["in_proj"].to(compute_dtype)
    z, xv, Bv, Cv, dt = _split_proj(proj, cfg)

    # depthwise causal conv over [x|B|C]
    xbc = torch.cat([xv, Bv, Cv], dim=-1)                              # (B,S,conv_dim)
    K = s.conv_kernel
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    w = p["conv_w"].to(compute_dtype)
    conv = pad[:, 0:S] * w[0]
    for i in range(1, K):
        conv = conv + pad[:, i:i + S] * w[i]
    conv = F.silu(conv + p["conv_b"].to(compute_dtype))
    gn = s.n_groups * s.d_state
    xv, Bv, Cv = torch.split(conv, [d_in, gn, gn], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                         # (B,S,H)
    A = -torch.exp(p["A_log"])                                         # (H,)
    xh = xv.reshape(B, S, H, s.head_dim)
    Bm = Bv.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cv.reshape(B, S, s.n_groups, s.d_state)
    y, state = ops.ssd(xh, dt, A, Bm, Cm, chunk=s.chunk, impl=impl)
    y = y + p["D_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_in)
    y = _gated_norm(y, z, p["gate_norm"], cfg.norm_eps).to(compute_dtype)
    out = y @ p["out_proj"].to(compute_dtype)
    if S >= K - 1:
        conv_tail = xbc[:, S - (K - 1):]
    else:
        conv_tail = F.pad(xbc, (0, 0, K - 1 - S, 0))
    return x + out.to(x.dtype), {"ssm": state, "conv": conv_tail.float()}


def mamba_cache_init(cfg: ArchConfig, batch: int, device=None):
    s, d_in, H, conv_dim = _dims(cfg)
    f32 = dict(device=device, dtype=torch.float32)
    return {"ssm": torch.zeros((batch, H, s.head_dim, s.d_state), **f32),
            "conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim), **f32)}


def mamba_decode(x, p, cache, cfg: ArchConfig, compute_dtype):
    """Single-token path.  x: (B, D); cache: {"ssm": (B,H,P,N), "conv":
    (B,K-1,C)}.  Returns the new x and the new cache pieces."""
    s, d_in, H, conv_dim = _dims(cfg)
    B, D = x.shape
    h = norm_apply(x, p["norm"], cfg).to(compute_dtype)
    proj = h @ p["in_proj"].to(compute_dtype)
    z, xv, Bv, Cv, dt = _split_proj(proj, cfg)

    xbc = torch.cat([xv, Bv, Cv], dim=-1)                              # (B, conv_dim)
    hist = torch.cat([cache["conv"].to(compute_dtype), xbc[:, None]], dim=1)
    conv = torch.einsum("bkc,kc->bc", hist, p["conv_w"].to(compute_dtype))
    conv = F.silu(conv + p["conv_b"].to(compute_dtype))
    gn = s.n_groups * s.d_state
    xv, Bv, Cv = torch.split(conv, [d_in, gn, gn], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                         # (B,H)
    A = -torch.exp(p["A_log"])
    xh = xv.reshape(B, H, s.head_dim)
    Bm = Bv.reshape(B, s.n_groups, s.d_state)
    Cm = Cv.reshape(B, s.n_groups, s.d_state)
    y, new_state = ops.ssd_decode(xh, dt, A, Bm, Cm, cache["ssm"])
    y = y + p["D_skip"].to(y.dtype)[None, :, None] * xh
    y = y.reshape(B, d_in)
    y = _gated_norm(y, z, p["gate_norm"], cfg.norm_eps).to(compute_dtype)
    out = y @ p["out_proj"].to(compute_dtype)
    return x + out.to(x.dtype), {"ssm": new_state, "conv": hist[:, 1:].float()}
