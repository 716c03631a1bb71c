"""Attention block: projections, kernel dispatch and KV-cache management.

The counterpart of ``repro.models.attention`` on one device (its sharding
constraints are no-ops there and are dropped; multi-device is ROADMAP Queue 1
item 12).  Cache layout per block position: (B, Hkv, Lc, Dh) with
Lc = min(window, max_len): sliding-window layers keep a ring buffer of
exactly the window.  Keys are rotary-encoded at write time (absolute
positions), so ring order is free.

Cross-attention (the encoder-decoder's decoder blocks) has parameters of its
own, prefixed ``c_`` (no bias, no post-norm): queries from the decoder,
keys and values from the encoder's memory, no rotary encoding, no mask.  At
decode it reads a cross cache of the memory's K/V that is never written.

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
              dtype=torch.float32, lead=(), cross: bool = False):
    """The block's attention parameters; with ``cross``, the cross-attention's
    (keys prefixed ``c_``, no bias, no post-norm)."""
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(device=device, dtype=dtype)
    prefix = "c_" if cross else ""
    p = {
        prefix + "wq": normal_init(gen, (*lead, D, Hq * Dh), **kw),
        prefix + "wk": normal_init(gen, (*lead, D, Hkv * Dh), **kw),
        prefix + "wv": normal_init(gen, (*lead, D, Hkv * Dh), **kw),
        prefix + "wo": normal_init(gen, (*lead, Hq * Dh, D), **kw),
        prefix + "norm": norm_init(cfg, D, device, lead),
    }
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", Hq * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            p[name] = torch.zeros((*lead, n), dtype=torch.float32, device=device)
    if cfg.post_norms and not cross:
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
               kv_source: Optional[torch.Tensor] = None,
               impl: Optional[str] = None, genome: Optional[dict] = None,
               return_kv: bool = False):
    """Full-sequence attention (train / prefill).  x: (B, S, D).  With
    ``kv_source`` (the encoder's memory, (B, Se, D)) it is cross-attention:
    the ``c_`` parameters, keys and values from the memory, no rotary
    encoding, no mask whatever ``causal`` and the block's window say."""
    cross = kv_source is not None
    prefix = "c_" if cross else ""
    h = norm_apply(x, p[prefix + "norm"], cfg).to(compute_dtype)
    if not cross:
        q, k, v = _project_qkv(h, p, cfg, compute_dtype)
        qpos = torch.arange(x.shape[1], device=x.device)
        q = rope_apply(q, qpos, cfg.rope_theta)
        k = rope_apply(k, qpos, cfg.rope_theta)
    else:
        B, S, _ = h.shape
        Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (h @ p["c_wq"].to(compute_dtype)).reshape(B, S, Hq, Dh)
        mem = kv_source.to(compute_dtype)
        Se = mem.shape[1]
        k = (mem @ p["c_wk"].to(compute_dtype)).reshape(B, Se, Hkv, Dh)
        v = (mem @ p["c_wv"].to(compute_dtype)).reshape(B, Se, Hkv, Dh)
    # (B, H, S, D) layout for the kernels
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = ops.attention(qt, kt, vt, causal=causal and not cross,
                      window=None if cross else blk.window,
                      softcap=cfg.attn_softcap, impl=impl, genome=genome)
    B, S = x.shape[0], x.shape[1]
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    out = o @ p[prefix + "wo"].to(compute_dtype)
    if cfg.post_norms and not cross:
        out = norm_apply(out.to(x.dtype), p["post_norm"], cfg)
    result = x + out.to(x.dtype)
    if return_kv:
        return result, (kt, vt)      # (B, Hkv, S or Se, Dh): pre-cache layout
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
                cross_cache: Optional[dict] = None, enc_len: Optional[int] = None,
                impl: Optional[str] = None):
    """Single-token attention.  x: (B, D); pos: the absolute position (one
    for the whole batch: decode runs in lockstep).  Writes the token's K/V
    into ``cache`` in place and returns the new x.  With ``cross_cache``
    ({"k", "v"}: (B, Hkv, Se, Dh)), cross-attention follows over its first
    ``enc_len`` keys; the cross cache is only read."""
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
    x = x + out.to(x.dtype)

    if cross_cache is not None:
        hc = norm_apply(x, p["c_norm"], cfg).to(compute_dtype)
        qc = (hc @ p["c_wq"].to(compute_dtype)).reshape(B, Hq, Dh)
        vl = torch.full((B,), enc_len, dtype=torch.int32, device=x.device)
        oc = ops.decode_attention(qc, cross_cache["k"].to(compute_dtype),
                                  cross_cache["v"].to(compute_dtype), vl,
                                  softcap=cfg.attn_softcap, impl=impl)
        x = x + (oc.reshape(B, Hq * Dh) @ p["c_wo"].to(compute_dtype)).to(x.dtype)
    return x
