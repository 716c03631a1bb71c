"""Mamba-2 block (SSD mixer): prefill through the chunked SSD kernel, decode
through the O(1) recurrent update.  The counterpart of ``repro.models.ssm``.

Layout follows the Mamba-2 reference: in_proj -> [z | x | B | C | dt],
depthwise causal conv over [x|B|C], SiLU, SSD, skip (D term), gated RMSNorm,
out_proj.

Under a mesh (``distributed.spmd``: this rank's rows) the heads are split
over "model" where they divide it (one group).  ``in_proj``'s output dim is
sharded over "model" by the rules at points that are not the split's, so
the projection and the conv are computed whole on every model rank; each
rank scans its heads, applies the gated norm to its channels (the squares
summed over "model") and its rows of ``out_proj``, and the parts are summed
over "model".  The recurrent state is held per rank: its rows and heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import context as ctx
from repro_torch.distributed import spmd
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


def head_axis(cfg: ArchConfig):
    """The axis the heads split over under the mesh, or None (always None
    with no mesh)."""
    return ctx.div_axis(_dims(cfg)[2]) if cfg.ssm.n_groups == 1 else None


def _project(x, p, cfg: ArchConfig, compute_dtype):
    """The whole projection of norm(x) on every model rank, and this rank's
    heads: (split, z, x|B|C, dt, heads (start, count), channels (start,
    end)).  Where the heads split, what follows is this rank's part: the
    weights' gradients are partial over "model"."""
    s, d_in, H, _ = _dims(cfg)
    split = head_axis(cfg) is not None
    h = norm_apply(x, spmd.use(p["norm"]), cfg).to(compute_dtype)
    if split:
        h = spmd.enter_model(h)
    proj = spmd.dot(h, p["in_proj"], model_partial=split)
    z, xv, Bv, Cv, dt = _split_proj(proj, cfg)
    n = H // ctx.axis_size("model") if split else H
    h0 = spmd.rank("model") * n if split else 0
    return split, z, torch.cat([xv, Bv, Cv], dim=-1), dt, (h0, n), \
        (h0 * s.head_dim, (h0 + n) * s.head_dim)


def _conv_params(p, split, compute_dtype):
    w = spmd.use(p["conv_w"], model_partial=split).to(compute_dtype)
    return w, spmd.use(p["conv_b"], model_partial=split).to(compute_dtype)


def _heads(p, cfg, conv, dt, heads, chans, split):
    """This rank's heads of the conv output and dt, its A, and B and C."""
    s, d_in = cfg.ssm, _dims(cfg)[1]
    (h0, n), (c0, c1) = heads, chans
    gn = s.n_groups * s.d_state
    xv, Bv, Cv = torch.split(conv, [d_in, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + spmd.use(p["dt_bias"], model_partial=split))   # (..., H)
    A = -torch.exp(spmd.use(p["A_log"], "model" if split else None))
    if split:
        xv, dt = xv[..., c0:c1], dt[..., h0:h0 + n]
    return xv, Bv, Cv, dt, A


def _out(x, y, xh, z, p, cfg: ArchConfig, split, chans, compute_dtype):
    """The skip (D term), the gated RMSNorm (the squares summed over every
    channel) and this rank's rows of ``out_proj``, its part summed over
    "model"."""
    d_in = _dims(cfg)[1]
    ax = "model" if split else None
    y = y + spmd.use(p["D_skip"], ax).to(y.dtype)[..., :, None] * xh
    y = y.reshape(*y.shape[:-2], -1)
    if split:
        z = z[..., chans[0]:chans[1]]
    g = y.float() * F.silu(z.float())
    if split:                     # the squares of every channel; the gradient's
        ms = spmd.enter_model(spmd.sum_model((g * g).sum(-1, keepdim=True))) / d_in
    else:                         # parts summed back in the backward
        ms = (g * g).mean(dim=-1, keepdim=True)
    g = g * torch.rsqrt(ms + cfg.norm_eps)
    y = (g * spmd.use(p["gate_norm"], ax).float()).to(compute_dtype)
    out = spmd.dot(y, p["out_proj"], ax, None)
    return x + (spmd.sum_model(out) if split else out).to(x.dtype)


def mamba_apply(x, p, cfg: ArchConfig, compute_dtype, impl=None):
    """Full-sequence path (prefill).  x: (B, S, D).  Returns the new x and
    the decode-resumable cache pieces: the final SSM state and the conv tail
    (under a mesh, this rank's rows and heads)."""
    s = cfg.ssm
    B, S, _ = x.shape
    split, z, xbc, dt, heads, chans = _project(x, p, cfg, compute_dtype)
    # depthwise causal conv over [x|B|C]
    K = s.conv_kernel
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    w, b = _conv_params(p, split, compute_dtype)
    conv = pad[:, 0:S] * w[0]
    for i in range(1, K):
        conv = conv + pad[:, i:i + S] * w[i]
    conv = F.silu(conv + b)
    xv, Bv, Cv, dt, A = _heads(p, cfg, conv, dt, heads, chans, split)
    xh = xv.reshape(B, S, heads[1], s.head_dim)
    Bm = Bv.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cv.reshape(B, S, s.n_groups, s.d_state)
    y, state = ops.ssd(xh, dt, A, Bm, Cm, chunk=s.chunk, impl=impl)
    out = _out(x, y, xh, z, p, cfg, split, chans, compute_dtype)
    if S >= K - 1:
        conv_tail = xbc[:, S - (K - 1):]
    else:
        conv_tail = F.pad(xbc, (0, 0, K - 1 - S, 0))
    return out, {"ssm": state, "conv": conv_tail.float()}


def mamba_cache_init(cfg: ArchConfig, batch: int, device=None):
    s, d_in, H, conv_dim = _dims(cfg)
    f32 = dict(device=device, dtype=torch.float32)
    return {"ssm": torch.zeros((batch, H, s.head_dim, s.d_state), **f32),
            "conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim), **f32)}


def mamba_decode(x, p, cache, cfg: ArchConfig, compute_dtype):
    """Single-token path.  x: (B, D); cache: {"ssm": (B,H,P,N), "conv":
    (B,K-1,C)}.  Returns the new x and the new cache pieces."""
    s = cfg.ssm
    B = x.shape[0]
    split, z, xbc, dt, heads, chans = _project(x, p, cfg, compute_dtype)
    w, b = _conv_params(p, split, compute_dtype)
    hist = torch.cat([cache["conv"].to(compute_dtype), xbc[:, None]], dim=1)
    conv = F.silu(torch.einsum("bkc,kc->bc", hist, w) + b)
    xv, Bv, Cv, dt, A = _heads(p, cfg, conv, dt, heads, chans, split)
    xh = xv.reshape(B, heads[1], s.head_dim)
    Bm = Bv.reshape(B, s.n_groups, s.d_state)
    Cm = Cv.reshape(B, s.n_groups, s.d_state)
    y, new_state = ops.ssd_decode(xh, dt, A, Bm, Cm, cache["ssm"])
    out = _out(x, y, xh, z, p, cfg, split, chans, compute_dtype)
    return out, {"ssm": new_state, "conv": hist[:, 1:].float()}
