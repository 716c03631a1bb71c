"""Model assembly for the decoder-only LMs of the registry: the counterpart
of ``repro.models.transformer`` on one device.

Parameters keep the JAX package's layout: ``params["dec"]["pos<i>"]`` holds
the block at pattern position i, every tensor stacked over the periods
(leading dim ``cfg.n_periods``).  Where the JAX package scans over periods,
the port loops over them and indexes the stack (views, no copies).  The
decode cache is stacked the same way.

Public API:
  init_params(cfg, generator, device, dtype)          -> params
  lm_logits(params, cfg, tokens, ...)                 -> (B, S, V)
  prefill(params, cfg, tokens, max_len, ...)          -> (last_logits, cache)
  decode_step(params, cfg, cache, token, ...)         -> (logits, cache)

Not ported yet: the encoder-decoder path (``encode``, cross-attention) and
``lm_loss``, which raise, and ``init_decode_cache`` (the decode-only dry-run
cells, ROADMAP Queue 1 item 12).  ``remat`` is a training concern and is
ignored.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, Block
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (logit_softcap, mlp_apply, mlp_init,
                                       norm_apply, norm_init, normal_init)

ENC_DEC_TODO = ("the encoder-decoder path (encode, cross-attention) is not "
                "ported yet (ROADMAP Queue 1 item 9)")
LM_LOSS_TODO = "lm_loss and training are not ported yet (ROADMAP Queue 1 item 11)"


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.enc_dec or any(b.cross_attn for b in cfg.pattern):
        raise NotImplementedError(ENC_DEC_TODO)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(gen, cfg: ArchConfig, blk: Block, lead, kw):
    p = {}
    if blk.kind == "attn":
        p["attn"] = attn_mod.attn_init(gen, cfg, blk, lead=lead, **kw)
    elif blk.kind == "mamba":
        p["mamba"] = ssm_mod.mamba_init(gen, cfg, lead=lead, **kw)
    if blk.mlp == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, lead=lead, **kw)
    elif blk.mlp != "none":
        p["mlp"] = mlp_init(gen, cfg, blk, lead=lead, **kw)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random weights with the JAX package's distributions, drawn with
    ``generator`` directly on ``device``.  Matrices are stored in ``dtype``
    (the JAX package casts them to the compute dtype at every use); norm
    weights, ``A_log``, ``dt_bias``, ``D_skip``, ``gate_norm``, ``conv_b`` and
    biases stay fp32.  The numbers differ from ``jax.random``'s: tests that
    compare the two packages convert JAX weights with ``params_from_jax``."""
    _check_supported(cfg)
    kw = dict(device=device, dtype=dtype)
    lead = (cfg.n_periods,)
    params = {
        "embed": normal_init(generator, (cfg.vocab_size, cfg.d_model), **kw),
        "final_norm": norm_init(cfg, cfg.d_model, device),
        "dec": {f"pos{i}": _block_init(generator, cfg, blk, lead, kw)
                for i, blk in enumerate(cfg.pattern)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(generator, (cfg.d_model, cfg.vocab_size), **kw)
    return params


def _period(tree, i: int):
    """The slice of a period-stacked tree for period i (views)."""
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _apply_block(x, p, cfg: ArchConfig, blk: Block, *, compute_dtype, impl=None,
                 genome=None, collect=False):
    cache = {}
    if blk.kind == "attn":
        out = attn_mod.attn_apply(x, p["attn"], cfg, blk, causal=True,
                                  compute_dtype=compute_dtype, impl=impl,
                                  genome=genome, return_kv=collect)
        if collect:
            x, cache["kv"] = out
        else:
            x = out
    elif blk.kind == "mamba":
        x, mcache = ssm_mod.mamba_apply(x, p["mamba"], cfg, compute_dtype, impl=impl)
        if collect:
            cache["mamba"] = mcache
    if blk.mlp == "moe":
        x = moe_mod.moe_apply(x, p["moe"], cfg, compute_dtype)
    elif blk.mlp != "none":
        x = mlp_apply(x, p["mlp"], cfg, blk, compute_dtype)
    return x, cache


def _run_stack(params_stack, x, cfg: ArchConfig, *, compute_dtype, impl=None,
               genome=None, collect=False):
    """Every period in order; with ``collect``, a list (one per period) of
    each position's cache pieces."""
    caches = []
    for per in range(cfg.n_periods):
        pslice = _period(params_stack, per)
        cs = {}
        for i, blk in enumerate(cfg.pattern):
            x, cs[f"pos{i}"] = _apply_block(
                x, pslice[f"pos{i}"], cfg, blk, compute_dtype=compute_dtype,
                impl=impl, genome=genome, collect=collect)
        caches.append(cs)
    return x, caches


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed(params, cfg: ArchConfig, tokens, prefix_embeds=None,
           compute_dtype=torch.bfloat16):
    # gather, then cast: the same values as the JAX package's cast-then-
    # gather, without a copy of the whole table
    x = params["embed"][tokens].to(compute_dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
    if prefix_embeds is not None and cfg.n_prefix_embeds:
        P = min(cfg.n_prefix_embeds, x.shape[1])
        x[:, :P] = prefix_embeds[:, :P].to(compute_dtype)
    return x


def _head(params, cfg: ArchConfig, x, compute_dtype):
    """LM head: logits in fp32 with the final softcap."""
    x = norm_apply(x, params["final_norm"], cfg).to(compute_dtype)
    w = (params["embed"].to(compute_dtype).T if cfg.tie_embeddings
         else params["lm_head"].to(compute_dtype))
    return logit_softcap((x @ w).float(), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# full-sequence paths
# ---------------------------------------------------------------------------


def encode(*args, **kwargs):
    raise NotImplementedError(ENC_DEC_TODO)


def lm_loss(*args, **kwargs):
    raise NotImplementedError(LM_LOSS_TODO)


def lm_logits(params, cfg: ArchConfig, tokens, *, prefix_embeds=None,
              compute_dtype=torch.bfloat16, impl=None, genome=None):
    _check_supported(cfg)
    x = _embed(params, cfg, tokens, prefix_embeds, compute_dtype)
    x, _ = _run_stack(params["dec"], x, cfg, compute_dtype=compute_dtype,
                      impl=impl, genome=genome)
    return _head(params, cfg, x, compute_dtype)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def prefill(params, cfg: ArchConfig, tokens, max_len: int, *, prefix_embeds=None,
            cache_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, impl=None,
            genome=None):
    """The prompt through the stack; returns the last position's fp32 logits
    and the decode cache, stacked over periods: attention K/V (n_per, B,
    Hkv, Lc, Dh) in ``cache_dtype``, Mamba states (n_per, B, H, P, N) and
    conv tails (n_per, B, K-1, C) in fp32.  ``cache["pos"]`` is the prompt
    length, a Python int."""
    _check_supported(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, prefix_embeds, compute_dtype)
    x, raw = _run_stack(params["dec"], x, cfg, compute_dtype=compute_dtype,
                        impl=impl, genome=genome, collect=True)
    logits = _head(params, cfg, x[:, -1:], compute_dtype)[:, 0]

    layers = {}
    for i, blk in enumerate(cfg.pattern):
        per = [c[f"pos{i}"] for c in raw]
        entry = {}
        if blk.kind == "attn":
            arranged = [attn_mod.cache_from_prefill(
                kt.to(cache_dtype), vt.to(cache_dtype), blk, max_len)
                for kt, vt in (c["kv"] for c in per)]
            entry["k"] = torch.stack([a["k"] for a in arranged])
            entry["v"] = torch.stack([a["v"] for a in arranged])
        elif blk.kind == "mamba":
            entry["mamba"] = {k: torch.stack([c["mamba"][k] for c in per])
                              for k in ("ssm", "conv")}
        layers[f"pos{i}"] = entry
    return logits, {"pos": S, "layers": layers}


def decode_step(params, cfg: ArchConfig, cache, token, *,
                compute_dtype=torch.bfloat16, impl=None):
    """One token for every sequence in the batch.  token: (B,) int.

    The cache's tensors are updated in place (the JAX package returns new
    arrays); the returned cache is a new dict over the same tensors with
    ``pos`` advanced by one."""
    x = params["embed"][token].to(compute_dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
    pos = cache["pos"]
    for per in range(cfg.n_periods):
        pslice = _period(params["dec"], per)
        for i, blk in enumerate(cfg.pattern):
            p, c = pslice[f"pos{i}"], cache["layers"][f"pos{i}"]
            if blk.kind == "attn":
                x = attn_mod.attn_decode(
                    x, p["attn"], {"k": c["k"][per], "v": c["v"][per]}, cfg, blk,
                    pos=pos, compute_dtype=compute_dtype, impl=impl)
            elif blk.kind == "mamba":
                mc = c["mamba"]
                x, new = ssm_mod.mamba_decode(
                    x, p["mamba"], {"ssm": mc["ssm"][per], "conv": mc["conv"][per]},
                    cfg, compute_dtype)
                mc["ssm"][per].copy_(new["ssm"])
                mc["conv"][per].copy_(new["conv"])
            if blk.mlp == "moe":
                x = moe_mod.moe_apply(x[:, None], p["moe"], cfg, compute_dtype)[:, 0]
            elif blk.mlp != "none":
                x = mlp_apply(x[:, None], p["mlp"], cfg, blk, compute_dtype)[:, 0]
    logits = _head(params, cfg, x, compute_dtype)
    return logits, dict(cache, pos=pos + 1)
