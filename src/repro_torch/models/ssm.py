"""Mamba-2 block (SSD mixer): prefill through the chunked SSD kernel, decode
through the O(1) recurrent update.  The counterpart of ``repro.models.ssm``.

Layout follows the Mamba-2 reference: in_proj -> [z | x | B | C | dt],
depthwise causal conv over [x|B|C], SiLU, SSD, skip (D term), gated RMSNorm,
out_proj.

Under a mesh (``distributed.spmd``: this rank's rows) the heads are split
over "model" where they divide it (one group).  In prefill and training
each model rank then projects and convolves only what its heads use
(``_own_route``): the columns of ``in_proj`` for z's and x's channels of its
heads, B and C whole (every head reads them), and dt of its heads, as the
reference's ``in_proj`` sharded over "model" on its output dim computes
about 1/m of the columns a chip.  Decode projects every column
(``spmd.dot``'s stationary route: each rank its shard's columns, gathered
over "model"), since its conv state holds every channel.  Each rank scans
its heads, applies the gated norm to its channels (the squares summed over
"model") and its rows of ``out_proj``, and the parts are summed over
"model".  The recurrent state is held per rank: its rows and heads; the
conv tail whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import context as ctx
from repro_torch.distributed import spmd
from repro_torch.kernels import ops
from repro_torch.models.layers import norm_apply, norm_init, normal_init

# Mamba blocks whose prefill or training projected only this rank's columns
# of ``in_proj`` (``_own_route``), since the caller last set it to 0
counts = {"own_columns": 0}


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


def _split_proj(proj, cfg, n):
    """z, x, B, C, dt of a projection of ``n`` heads' channels."""
    s = cfg.ssm
    gn = s.n_groups * s.d_state
    c = n * s.head_dim
    return torch.split(proj, [c, c, gn, gn, n], dim=-1)


def head_axis(cfg: ArchConfig):
    """The axis the heads split over under the mesh, or None (always None
    with no mesh)."""
    return ctx.div_axis(_dims(cfg)[2]) if cfg.ssm.n_groups == 1 else None


def _own_route(cfg: ArchConfig) -> bool:
    """Whether prefill and training project and convolve only this rank's
    columns: where the heads split over "model" into more than one part.
    On one model rank its columns are every column, and the whole weight
    goes in as it is."""
    return head_axis(cfg) is not None and ctx.axis_size("model") > 1


def _conv_columns(cfg, chans) -> list:
    """This rank's columns of [x|B|C] as (start, end) ranges: x's channels
    of its heads, then B and C whole."""
    _, d_in, _, conv_dim = _dims(cfg)
    return [chans, (d_in, conv_dim)]


def _columns(t, ranges) -> torch.Tensor:
    """The columns ``ranges`` of ``t``'s last dim, in order, as one tensor."""
    return torch.cat([t[..., a:b] for a, b in ranges], dim=-1)


def _project(x, p, cfg: ArchConfig, compute_dtype, own: bool):
    """norm(x) through ``in_proj``, and this rank's heads: (split, z, x|B|C,
    dt, heads (start, count), channels (start, end)).  With ``own`` z, x and
    dt are this rank's channels and heads, computed from its columns of the
    gathered weight (B and C whole; the other columns' gradient is 0 on this
    rank); else every column.  Where the heads split, what follows is this
    rank's part: the weights' gradients are partial over "model"."""
    s, d_in, H, conv_dim = _dims(cfg)
    split = head_axis(cfg) is not None
    h = norm_apply(x, spmd.use(p["norm"]), cfg).to(compute_dtype)
    if split:
        h = spmd.enter_model(h)
    n = H // ctx.axis_size("model") if split else H
    h0 = spmd.rank("model") * n if split else 0
    chans = (h0 * s.head_dim, (h0 + n) * s.head_dim)
    if own:                       # z's channels, x|B|C's, dt's heads
        cols = [chans] + [(d_in + a, d_in + b) for a, b in _conv_columns(cfg, chans)] \
            + [(d_in + conv_dim + h0, d_in + conv_dim + h0 + n)]
        w = _columns(spmd.use(p["in_proj"], model_partial=True), cols).to(h.dtype)
        proj = h @ w
        counts["own_columns"] += 1
    else:
        proj = spmd.dot(h, p["in_proj"], model_partial=split)
    z, xv, Bv, Cv, dt = _split_proj(proj, cfg, n if own else H)
    return split, z, torch.cat([xv, Bv, Cv], dim=-1), dt, (h0, n), chans


def _conv_params(p, split, compute_dtype, ranges=None):
    """The conv's weight and bias: their columns ``ranges``, or all."""
    w = spmd.use(p["conv_w"], model_partial=split)
    w = (w if ranges is None else _columns(w, ranges)).to(compute_dtype)
    b = spmd.use(p["conv_b"], model_partial=split)
    return w, (b if ranges is None else _columns(b, ranges)).to(compute_dtype)


def _heads(p, cfg, conv, dt, heads, chans, split, own):
    """This rank's heads of the conv output and dt (sliced from every
    head's unless ``own``), its A, and B and C."""
    s = cfg.ssm
    (h0, n), (c0, c1) = heads, chans
    gn = s.n_groups * s.d_state
    xv, Bv, Cv = torch.split(conv, [conv.shape[-1] - 2 * gn, gn, gn], dim=-1)
    bias = spmd.use(p["dt_bias"], model_partial=split)
    if own:
        bias = bias[h0:h0 + n]
    dt = F.softplus(dt.float() + bias)                                  # (..., heads)
    A = -torch.exp(spmd.use(p["A_log"], "model" if split else None))
    if split and not own:
        xv, dt = xv[..., c0:c1], dt[..., h0:h0 + n]
    return xv, Bv, Cv, dt, A


def _out(x, y, xh, z, p, cfg: ArchConfig, split, own, chans, compute_dtype):
    """The skip (D term), the gated RMSNorm (the squares summed over every
    channel) and this rank's rows of ``out_proj``, its part summed over
    "model".  ``z`` is every channel's unless ``own``."""
    d_in = _dims(cfg)[1]
    ax = "model" if split else None
    y = y + spmd.use(p["D_skip"], ax).to(y.dtype)[..., :, None] * xh
    y = y.reshape(*y.shape[:-2], -1)
    if split and not own:
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


def mamba_apply(x, p, cfg: ArchConfig, compute_dtype, impl=None, collect=True):
    """Full-sequence path (prefill and training).  x: (B, S, D).  Returns the
    new x and, with ``collect``, the decode-resumable cache pieces (else
    None): the final SSM state (under a mesh, this rank's rows and heads)
    and the conv tail (its rows, every channel: on the own-columns route x's
    tail rows are gathered over "model")."""
    s = cfg.ssm
    B, S, _ = x.shape
    own = _own_route(cfg)
    split, z, xbc, dt, heads, chans = _project(x, p, cfg, compute_dtype, own)
    # depthwise causal conv over [x|B|C]
    K = s.conv_kernel
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    w, b = _conv_params(p, split, compute_dtype, _conv_columns(cfg, chans) if own else None)
    conv = pad[:, 0:S] * w[0]
    for i in range(1, K):
        conv = conv + pad[:, i:i + S] * w[i]
    conv = F.silu(conv + b)
    xv, Bv, Cv, dt, A = _heads(p, cfg, conv, dt, heads, chans, split, own)
    xh = xv.reshape(B, S, heads[1], s.head_dim)
    Bm = Bv.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cv.reshape(B, S, s.n_groups, s.d_state)
    y, state = ops.ssd(xh, dt, A, Bm, Cm, chunk=s.chunk, impl=impl)
    out = _out(x, y, xh, z, p, cfg, split, own, chans, compute_dtype)
    if not collect:
        return out, None
    if S >= K - 1:
        conv_tail = xbc[:, S - (K - 1):]
    else:
        conv_tail = F.pad(xbc, (0, 0, K - 1 - S, 0))
    if own:                       # every rank's x channels, in rank order
        c = chans[1] - chans[0]
        conv_tail = torch.cat([spmd.gather(conv_tail[..., :c], -1, "model", partial=False),
                               conv_tail[..., c:]], dim=-1)
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
    split, z, xbc, dt, heads, chans = _project(x, p, cfg, compute_dtype, own=False)
    w, b = _conv_params(p, split, compute_dtype)
    hist = torch.cat([cache["conv"].to(compute_dtype), xbc[:, None]], dim=1)
    conv = F.silu(torch.einsum("bkc,kc->bc", hist, w) + b)
    xv, Bv, Cv, dt, A = _heads(p, cfg, conv, dt, heads, chans, split, own=False)
    xh = xv.reshape(B, heads[1], s.head_dim)
    Bm = Bv.reshape(B, s.n_groups, s.d_state)
    Cm = Cv.reshape(B, s.n_groups, s.d_state)
    y, new_state = ops.ssd_decode(xh, dt, A, Bm, Cm, cache["ssm"])
    out = _out(x, y, xh, z, p, cfg, split, False, chans, compute_dtype)
    return out, {"ssm": new_state, "conv": hist[:, 1:].float()}
