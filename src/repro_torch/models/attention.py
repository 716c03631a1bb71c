"""Attention block: projections, kernel dispatch and KV-cache management.

The counterpart of ``repro.models.attention`` on one device (its sharding
constraints are no-ops there and are dropped; multi-device is ROADMAP Queue 1
item 12).  Cross-attention belongs to the encoder-decoder path, which is not
ported yet (ROADMAP Queue 1 item 9).  Cache layout per block position: (B, Hkv, Lc, Dh) with
Lc = min(window, max_len): sliding-window layers keep a ring buffer of
exactly the window.  Keys are rotary-encoded at write time (absolute
positions), so ring order is free.

Unlike the JAX package, whose arrays are immutable, ``attn_decode`` writes
the new token's K/V into the cache in place (one slot of the preallocated
buffer), so a decode step allocates no new cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, Block
from repro_torch.kernels import ops
from repro_torch.models.layers import norm_apply, norm_init, normal_init, rope_apply


def attn_init(gen, cfg: ArchConfig, blk: Block, *, device=None,
              dtype=torch.float32, lead=()):
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": normal_init(gen, (*lead, D, Hq * Dh), **kw),
        "wk": normal_init(gen, (*lead, D, Hkv * Dh), **kw),
        "wv": normal_init(gen, (*lead, D, Hkv * Dh), **kw),
        "wo": normal_init(gen, (*lead, Hq * Dh, D), **kw),
        "norm": norm_init(cfg, D, device, lead),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", Hq * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            p[name] = torch.zeros((*lead, n), dtype=torch.float32, device=device)
    if cfg.post_norms:
        p["post_norm"] = norm_init(cfg, D, device, lead)
    return p


def _project_qkv(h, p, cfg, compute_dtype):
    B, S, D = h.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = h @ p["wq"].to(compute_dtype)
    k = h @ p["wk"].to(compute_dtype)
    v = h @ p["wv"].to(compute_dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(compute_dtype)
        k = k + p["bk"].to(compute_dtype)
        v = v + p["bv"].to(compute_dtype)
    return (q.reshape(B, S, Hq, Dh), k.reshape(B, S, Hkv, Dh), v.reshape(B, S, Hkv, Dh))


def attn_apply(x, p, cfg: ArchConfig, blk: Block, *, causal: bool, compute_dtype,
               impl: Optional[str] = None, genome: Optional[dict] = None,
               return_kv: bool = False):
    """Full-sequence self-attention (prefill).  x: (B, S, D)."""
    h = norm_apply(x, p["norm"], cfg).to(compute_dtype)
    q, k, v = _project_qkv(h, p, cfg, compute_dtype)
    qpos = torch.arange(x.shape[1], device=x.device)
    q = rope_apply(q, qpos, cfg.rope_theta)
    k = rope_apply(k, qpos, cfg.rope_theta)
    # (B, H, S, D) layout for the kernels
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = ops.attention(qt, kt, vt, causal=causal, window=blk.window,
                      softcap=cfg.attn_softcap, impl=impl, genome=genome)
    B, S = x.shape[0], x.shape[1]
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    out = o @ p["wo"].to(compute_dtype)
    if cfg.post_norms:
        out = norm_apply(out.to(x.dtype), p["post_norm"], cfg)
    result = x + out.to(x.dtype)
    if return_kv:
        return result, (kt, vt)      # (B, Hkv, S, Dh): pre-cache layout
    return result


# ---------------------------------------------------------------------------
# KV cache (decode path)
# ---------------------------------------------------------------------------


def cache_len(blk: Block, max_len: int) -> int:
    return min(blk.window, max_len) if blk.window else max_len


def attn_cache_init(cfg: ArchConfig, blk: Block, batch: int, max_len: int,
                    dtype=torch.bfloat16, device=None):
    Lc = cache_len(blk, max_len)
    shape = (batch, cfg.n_kv_heads, Lc, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_from_prefill(kt, vt, blk: Block, max_len: int):
    """Arrange prefill K/V (..., Hkv, S, Dh) into the decode cache layout:
    the last Lc positions, rolled so position t sits in slot t % Lc on a
    windowed layer; zero-padded to Lc when the prompt is shorter."""
    S = kt.shape[-2]
    Lc = cache_len(blk, max_len)
    if S >= Lc:
        last_k, last_v = kt[..., S - Lc:, :], vt[..., S - Lc:, :]
        shift = (S - Lc) % Lc if blk.window else 0
        k = torch.roll(last_k, shift, dims=-2)
        v = torch.roll(last_v, shift, dims=-2)
    else:
        k = torch.nn.functional.pad(kt, (0, 0, 0, Lc - S))
        v = torch.nn.functional.pad(vt, (0, 0, 0, Lc - S))
    return {"k": k.contiguous(), "v": v.contiguous()}


def attn_decode(x, p, cache, cfg: ArchConfig, blk: Block, *, pos: int, compute_dtype,
                impl: Optional[str] = None):
    """Single-token attention.  x: (B, D); pos: the absolute position (one
    for the whole batch: decode runs in lockstep).  Writes the token's K/V
    into ``cache`` in place and returns the new x."""
    B, D = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = norm_apply(x, p["norm"], cfg).to(compute_dtype)
    q = h @ p["wq"].to(compute_dtype)
    k = h @ p["wk"].to(compute_dtype)
    v = h @ p["wv"].to(compute_dtype)
    if cfg.qkv_bias:
        q, k, v = (q + p["bq"].to(compute_dtype), k + p["bk"].to(compute_dtype),
                   v + p["bv"].to(compute_dtype))
    q = q.reshape(B, Hq, Dh)
    k = k.reshape(B, Hkv, Dh)
    v = v.reshape(B, Hkv, Dh)
    q = rope_apply(q[:, None], pos, cfg.rope_theta)[:, 0]
    k = rope_apply(k[:, None], pos, cfg.rope_theta)[:, 0]

    kc, vc = cache["k"], cache["v"]
    Lc = kc.shape[2]
    # the JAX package's dynamic_update_slice clamps an index past the end
    slot = pos % Lc if blk.window else min(pos, Lc - 1)
    kc[:, :, slot] = k.to(kc.dtype)
    vc[:, :, slot] = v.to(vc.dtype)
    valid_len = torch.full((B,), min(pos + 1, Lc), dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q, kc, vc, valid_len, softcap=cfg.attn_softcap, impl=impl)
    out = o.reshape(B, Hq * Dh) @ p["wo"].to(compute_dtype)
    if cfg.post_norms:
        out = norm_apply(out.to(x.dtype), p["post_norm"], cfg)
    return x + out.to(x.dtype)
