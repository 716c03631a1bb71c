"""Model assembly for the decoder-only and encoder-decoder LMs of the
registry: the counterpart of ``repro.models.transformer``.

Parameters keep the JAX package's layout: ``params["dec"]["pos<i>"]`` holds
the block at pattern position i, every tensor stacked over the periods
(leading dim ``cfg.n_periods``).  An encoder-decoder adds ``params["enc"]``
(the pattern again, stacked over ``cfg.n_enc_layers`` periods, without
cross-attention) and ``params["enc_final_norm"]``; its decoder blocks carry
the cross-attention's ``c_`` parameters.  Where the JAX package scans over
periods, the port loops over them and unbinds the stack (views, no copies).
The decode cache is stacked the same way.

Public API:
  init_params(cfg, generator, device, dtype)          -> params
  encode(params, cfg, frames, ...)                    -> (B, Se, D)
  lm_logits(params, cfg, tokens, ...)                 -> (B, S, V)
  lm_loss(params, cfg, batch, ...)                    -> scalar
  prefill(params, cfg, tokens, max_len, ...)          -> (last_logits, cache)
  init_decode_cache(cfg, batch, max_len, ...)         -> cache
  decode_step(params, cfg, cache, token, ...)         -> (logits, cache)

``cfg.remat`` checkpoints the stack as the JAX package does: per period,
and per block inside the period when the pattern has more than two blocks
(``torch.utils.checkpoint``, non-reentrant), whenever autograd records the
forward.

Under a mesh (``distributed.context.set_mesh``) the entry points take the
parameters as DTensors placed by ``distributed.sharding`` and the global
batch (tokens, labels, frames: the same on every rank).  Each rank runs
the stack on its rows (``distributed.spmd``): its data-parallel shard of
the batch at every block, as the JAX package constrains the stack, or the
whole batch where the shards do not divide it.  The logits come back as a
DTensor sharded over "model" on the vocab, in ``Shard``'s uneven layout
where the vocab does not divide it (the loss pads it to divide,
``pad_vocab``), the decode cache as DTensors in the kernels' layout
(rows over the data axes, KV or Mamba heads over "model"; a self-attention
cache's length over the data axes where they do not divide the batch and
do divide that length, else over "model" where the attention keeps every
head on every model rank and "model" divides it, ``_cache_specs``), and
``lm_loss`` as this rank's value of the global loss whose gradient is this
rank's share.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, Block
from repro_torch.distributed import context as ctx
from repro_torch.distributed import spmd
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (logit_softcap, mlp_apply, mlp_init,
                                       norm_apply, norm_init, normal_init)

# since the caller last set them to 0: head calls outside the loss that
# computed only this model rank's columns of a vocab the model axis does not
# divide (``_uneven_vocab``), and ``lm_loss`` calls whose log-softmax ran on
# this model rank's vocab shard (``_ShardNLL``)
counts = {"head_columns": 0, "loss_shards": 0}

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(gen, cfg: ArchConfig, blk: Block, lead, kw, causal_stack: bool):
    p = {}
    if blk.kind == "attn":
        p["attn"] = attn_mod.attn_init(gen, cfg, blk, lead=lead, **kw)
        if blk.cross_attn and causal_stack:
            p["attn"].update(attn_mod.attn_init(gen, cfg, blk, lead=lead, cross=True,
                                                **kw))
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
    kw = dict(device=device, dtype=dtype)

    def stack(n_periods, causal_stack):
        return {f"pos{i}": _block_init(generator, cfg, blk, (n_periods,), kw, causal_stack)
                for i, blk in enumerate(cfg.pattern)}

    params = {
        "embed": normal_init(generator, (cfg.vocab_size, cfg.d_model), **kw),
        "final_norm": norm_init(cfg, cfg.d_model, device),
        "dec": stack(cfg.n_periods, True),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(generator, (cfg.d_model, cfg.vocab_size), **kw)
    if cfg.enc_dec:
        # the encoder runs a uniform pattern (full attention and
        # pattern[0]'s MLP) over these stacks, as the JAX package does
        params["enc"] = stack(cfg.n_enc_layers, False)
        params["enc_final_norm"] = norm_init(cfg, cfg.d_model, device)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _apply_block(x, p, cfg: ArchConfig, blk: Block, *, causal, compute_dtype,
                 enc_out=None, impl=None, genome=None, collect=False):
    """One block; with ``collect``, its cache pieces: the self-attention's
    K/V ("kv"), the cross-attention's K/V of the memory ("cross"), the Mamba
    states ("mamba")."""
    cache = {}
    if blk.kind == "attn":
        out = attn_mod.attn_apply(x, p["attn"], cfg, blk, causal=causal,
                                  compute_dtype=compute_dtype, impl=impl,
                                  genome=genome, return_kv=collect)
        if collect:
            x, cache["kv"] = out
        else:
            x = out
        if blk.cross_attn and enc_out is not None:
            out = attn_mod.attn_apply(x, p["attn"], cfg, blk, causal=False,
                                      compute_dtype=compute_dtype, kv_source=enc_out,
                                      impl=impl, genome=genome, return_kv=collect)
            if collect:
                x, cache["cross"] = out
            else:
                x = out
    elif blk.kind == "mamba":
        x, mcache = ssm_mod.mamba_apply(x, p["mamba"], cfg, compute_dtype, impl=impl,
                                         collect=collect)
        if collect:
            cache["mamba"] = mcache
    if blk.mlp == "moe":
        x = moe_mod.moe_apply(x, p["moe"], cfg, compute_dtype)
    elif blk.mlp != "none":
        x = mlp_apply(x, p["mlp"], cfg, blk, compute_dtype)
    return x, cache


def _unstack(tree, n: int) -> list:
    """The period-stacked tree as ``n`` per-period trees of views.  One
    ``unbind`` per leaf: its backward stacks the periods' gradients once,
    where indexing each period would add a full-size gradient per period."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    if isinstance(tree, DTensor):                    # under a mesh: local shards
        return spmd.unstack(tree)
    return list(torch.unbind(tree, 0))


def _n_periods(params_stack) -> int:
    """The stack's leading dimension: the decoder's ``cfg.n_periods`` or the
    encoder's ``cfg.n_enc_layers``."""
    while isinstance(params_stack, dict):
        params_stack = next(iter(params_stack.values()))
    return params_stack.shape[0]


def _run_stack(params_stack, x, cfg: ArchConfig, pattern, *, causal, compute_dtype,
               enc_out=None, impl=None, genome=None, collect=False):
    """Every period of ``pattern`` in order; with ``collect``, a list (one
    per period) of each position's cache pieces.  ``cfg.remat`` recomputes
    each period in the backward, and each block too when the pattern is
    longer than two blocks; the period functions take the parameters by
    closure, which the non-reentrant checkpoint supports."""
    remat = cfg.remat and not collect and torch.is_grad_enabled()
    inner_ckpt = remat and len(pattern) > 2
    sharded = spmd.rows_sharded()         # read again where remat recomputes

    def period(x, pslice):
        cs = {}
        for i, blk in enumerate(pattern):
            apply_i = functools.partial(
                _apply_block, cfg=cfg, blk=blk, causal=causal,
                compute_dtype=compute_dtype, enc_out=enc_out,
                impl=impl, genome=genome, collect=collect)
            if inner_ckpt:
                apply_i = functools.partial(checkpoint, apply_i, use_reentrant=False)
            with spmd.rows(sharded):
                x, cs[f"pos{i}"] = apply_i(x, pslice[f"pos{i}"])
        return x, cs

    if remat:
        period = functools.partial(checkpoint, period, use_reentrant=False)
    caches = []
    for pslice in _unstack(params_stack, _n_periods(params_stack)):
        x, cs = period(x, pslice)
        caches.append(cs)
    return x, caches


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed(params, cfg: ArchConfig, tokens, prefix_embeds=None,
           compute_dtype=torch.bfloat16):
    # gather, then cast: the same values as the JAX package's cast-then-
    # gather, without a copy of the whole table (``spmd.lookup``)
    x = spmd.lookup(params["embed"], tokens, compute_dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
    if prefix_embeds is not None and cfg.n_prefix_embeds:
        P = min(cfg.n_prefix_embeds, x.shape[1])
        x[:, :P] = prefix_embeds[:, :P].to(compute_dtype)
    return x


def _uneven_vocab(cfg: ArchConfig) -> bool:
    """Whether a model axis of more than one rank does not divide the vocab:
    outside the loss the head then splits it unevenly (``_head``)."""
    m = ctx.axis_size("model")
    return m > 1 and cfg.vocab_size % m != 0


def _head(params, cfg: ArchConfig, x, compute_dtype, pad_vocab: bool = False):
    """The LM head with the final softcap on this rank's rows: (fp32 logits
    of its vocab shard, the vocab's axis or None; with no mesh, all of the
    vocab and None).  ``pad_vocab`` (the loss path) pads the vocab to a
    multiple of the model axis, so the logits shard over it even where the
    vocab does not divide it; the pad columns carry logits of -1e30, which
    softmax does not see, and the padded shape is kept through the loss.
    Without it a vocab that does not divide the model axis splits as
    ``Shard`` splits it (``spmd.part``): each model rank computes only its
    own columns, ceil(V / m) of them, fewer on the last (``counts``)."""
    V, m = cfg.vocab_size, ctx.axis_size("model")
    pad = (-V) % m if pad_vocab and m > 1 else 0
    uneven = not pad_vocab and _uneven_vocab(cfg)
    v_ax = "model" if uneven else ctx.div_axis(V + pad)
    h = norm_apply(x, spmd.use(params["final_norm"]), cfg).to(compute_dtype)
    if v_ax:
        h = spmd.enter_model(h)
    tied = cfg.tie_embeddings
    if pad:                      # a slice of the whole, padded (the loss path)
        n = (V + pad) // m if v_ax else V + pad
        v0 = spmd.rank("model") * n if v_ax else 0
        kw = dict(model_partial=bool(v_ax))
        w = (spmd.use(params["embed"], **kw).T if tied
             else spmd.use(params["lm_head"], **kw)).to(compute_dtype)
        w = torch.cat([w, w.new_zeros((w.shape[0], pad))], dim=1)[:, v0:v0 + n]
        logits = h @ w
    elif tied:
        logits = spmd.dot(h, params["embed"], v_ax, None, transposed=True)
    else:
        logits = spmd.dot(h, params["lm_head"], None, v_ax)
    if uneven:
        counts["head_columns"] += 1
    logits = logit_softcap(logits.float(), cfg.logit_softcap)
    if pad:
        cols = torch.arange(v0, v0 + n, device=logits.device)
        logits = logits + torch.where(cols >= V, -1e30, 0.0)
    return logits, v_ax


def _wrap_logits(logits, cfg: ArchConfig, batch: int, v_ax):
    """Every rank's logits as one DTensor: rows over the data axes where
    they divide the batch, the vocab over ``v_ax`` (unevenly where the
    vocab does not divide it, ``_head``)."""
    spec = (ctx.batch_spec(batch),) + (None,) * (logits.ndim - 2) + (v_ax,)
    return spmd.wrap(logits, *spec, shape=(batch, *logits.shape[1:-1], cfg.vocab_size))


# ---------------------------------------------------------------------------
# full-sequence paths
# ---------------------------------------------------------------------------


def encode(params, cfg: ArchConfig, frames, *, compute_dtype=torch.bfloat16,
           impl=None, genome=None):
    """The encoder stack over precomputed frame embeddings (B, Se, D) (the
    speech frontend is a stub): non-causal, rotary-encoded self-attention at
    positions 0..Se-1 and pattern[0]'s MLP, then ``enc_final_norm``."""
    B = frames.shape[0]
    with spmd.rows(spmd.batch_sharded(B)):
        out = _encode(params, cfg, spmd.local_rows(frames), compute_dtype=compute_dtype,
                      impl=impl, genome=genome)
    return spmd.wrap(out, ctx.batch_spec(B), None, None)


def _encode(params, cfg: ArchConfig, frames, *, compute_dtype, impl, genome):
    enc_pattern = (Block(kind="attn", mlp=cfg.pattern[0].mlp, cross_attn=False),)
    x = frames.to(compute_dtype)
    x, _ = _run_stack(params["enc"], x, cfg, enc_pattern, causal=False,
                      compute_dtype=compute_dtype, impl=impl, genome=genome)
    return norm_apply(x, spmd.use(params["enc_final_norm"]), cfg)


def _encoded(params, cfg: ArchConfig, enc_frames, **kw):
    """The encoder's memory for an encoder-decoder arch, else None."""
    if not cfg.enc_dec:
        return None
    if enc_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass enc_frames")
    return _encode(params, cfg, enc_frames, **kw)


def lm_logits(params, cfg: ArchConfig, tokens, *, prefix_embeds=None,
              enc_frames=None, compute_dtype=torch.bfloat16, impl=None, genome=None):
    """fp32 logits (B, S, V) of every position; under a mesh a DTensor, its
    rows over the data axes where they divide and its vocab over "model"
    (unevenly where the vocab does not divide it)."""
    B = tokens.shape[0]
    with spmd.rows(spmd.batch_sharded(B)):
        logits, v_ax = _logits(params, cfg, tokens, prefix_embeds, enc_frames, compute_dtype,
                               impl, genome)
    return _wrap_logits(logits, cfg, B, v_ax)


def _logits(params, cfg: ArchConfig, tokens, prefix_embeds, enc_frames, compute_dtype,
            impl, genome, pad_vocab: bool = False):
    """This rank's logits (its rows, its vocab shard) and the vocab's axis."""
    tokens, prefix_embeds, enc_frames = (spmd.local_rows(t)
                                         for t in (tokens, prefix_embeds, enc_frames))
    x = _embed(params, cfg, tokens, prefix_embeds, compute_dtype)
    enc_out = _encoded(params, cfg, enc_frames, compute_dtype=compute_dtype,
                       impl=impl, genome=genome)
    x, _ = _run_stack(params["dec"], x, cfg, cfg.pattern, causal=True,
                      compute_dtype=compute_dtype, enc_out=enc_out,
                      impl=impl, genome=genome)
    return _head(params, cfg, x, compute_dtype, pad_vocab)


class _ShardNLL(torch.autograd.Function):
    """Each row's log-probability of its label from this model rank's shard
    ``z`` (B_r, S, n) of the fp32 logits, the columns [v0, v0 + n) of the
    padded vocab: the row max and the sum of exponentials reduced over
    "model", and the label's logit from the one rank that holds it (0 from
    the others), summed over "model": three (B_r, S) all-reduces.  Pad
    columns (-1e30) add exp 0.  The backward is g · (one-hot − softmax) on
    the shard, with no collective; the model ranks' partial gradients of
    the head's input are summed by ``_head``'s ``enter_model``."""

    @staticmethod
    def forward(fctx, z, labels, v0):
        n = z.shape[-1]
        top = spmd.reduce_over("model", z.amax(-1), "max")
        e = (z - top[..., None]).exp_()
        total = spmd.reduce_over("model", e.sum(-1))
        local = labels - v0
        held = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)[..., None]
        picked = spmd.reduce_over("model", torch.where(held, z.gather(-1, local)[..., 0], 0.0))
        fctx.save_for_backward(e.div_(total[..., None]), local, held)
        return picked - top - torch.log(total)

    @staticmethod
    def backward(fctx, g):
        p, local, held = fctx.saved_tensors
        grad = p.mul_(-g[..., None])          # p is not read again
        grad.scatter_add_(-1, local, (g * held)[..., None])
        return grad, None, None


def lm_loss(params, cfg: ArchConfig, batch, *, compute_dtype=torch.bfloat16,
            impl=None, genome=None):
    """Next-token cross-entropy.  batch: {tokens, labels, [prefix_embeds],
    [enc_frames]};
    labels < 0 carry no loss, and the sum is divided by the number of the
    others (at least 1).  Training takes ``impl="blocked"``: the kernels
    have no backward and refuse inputs that require grad.  Under a mesh the
    batch must divide the data-parallel ranks, and the vocab is padded to a
    multiple of the model axis (``_head``); with more than one model rank
    each takes the log-softmax over its own vocab shard (``_ShardNLL``,
    ``counts["loss_shards"]``), the logits never gathered."""
    B = batch["tokens"].shape[0]
    if B % spmd.dp_size():
        raise ValueError(f"a batch of {B} does not split over the "
                         f"{spmd.dp_size()} data-parallel ranks")
    with spmd.rows(spmd.batch_sharded(B)):
        logits, _ = _logits(params, cfg, batch["tokens"], batch.get("prefix_embeds"),
                            batch.get("enc_frames"), compute_dtype, impl, genome,
                            pad_vocab=True)
    labels = spmd.local_rows(batch["labels"]).long()
    mask = (labels >= 0).float()
    if ctx.axis_size("model") > 1:            # the padded vocab divides "model"
        n = logits.shape[-1]
        ll = _ShardNLL.apply(logits, labels.clamp_min(0), spmd.rank("model") * n)
        counts["loss_shards"] += 1
    else:
        logp = torch.log_softmax(logits, dim=-1)
        del logits
        ll = torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    part = -(ll * mask).sum() / torch.clamp_min(spmd.batch_axes_sum(mask.sum()), 1.0)
    return part + (spmd.batch_axes_sum(part) - part).detach()


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def prefill(params, cfg: ArchConfig, tokens, max_len: int, *, prefix_embeds=None,
            enc_frames=None, cache_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
            impl=None, genome=None):
    """The prompt through the stack; returns the last position's fp32 logits
    and the decode cache, stacked over periods: attention K/V (n_per, B,
    Hkv, Lc, Dh) in ``cache_dtype``, Mamba states (n_per, B, H, P, N) and
    conv tails (n_per, B, K-1, C) in fp32.  ``cache["pos"]`` is the prompt
    length, a 0-d int32 tensor on the cache's device (the JAX package's
    int32 array), which ``decode_step`` advances on the device.  An
    encoder-decoder encodes ``enc_frames`` first;
    its cache adds the cross K/V of the memory (n_per, B, Hkv, Se, Dh) in the
    compute dtype, as the JAX package keeps them, and ``cache["enc_len"]``
    = Se.  The cross K/V are the ones the prefill's cross-attention computed
    (the JAX package projects the memory a second time for the cache: the
    same products on the same inputs)."""
    B, S = tokens.shape
    with spmd.rows(spmd.batch_sharded(B)):
        tokens, prefix_embeds, enc_frames = (
            spmd.local_rows(t) for t in (tokens, prefix_embeds, enc_frames))
        x = _embed(params, cfg, tokens, prefix_embeds, compute_dtype)
        enc_out = _encoded(params, cfg, enc_frames, compute_dtype=compute_dtype,
                           impl=impl, genome=genome)
        x, raw = _run_stack(params["dec"], x, cfg, cfg.pattern, causal=True,
                            compute_dtype=compute_dtype, enc_out=enc_out,
                            impl=impl, genome=genome, collect=True)
        logits, v_ax = _head(params, cfg, x[:, -1:], compute_dtype)
        logits = _wrap_logits(logits[:, 0], cfg, B, v_ax)

    layers = {}
    for i, blk in enumerate(cfg.pattern):
        per = [c[f"pos{i}"] for c in raw]
        entry = {}
        if blk.kind == "attn":
            arranged = [attn_mod.cache_from_prefill(
                kt.to(cache_dtype), vt.to(cache_dtype), blk, max_len)
                for kt, vt in (c["kv"] for c in per)]
            # this rank's shard of the length where the cache splits it
            length = (None, None, None, _cache_specs(cfg, blk, B, max_len)["k"][3], None)
            entry["k"] = _shard_of(torch.stack([a["k"] for a in arranged]), length)
            entry["v"] = _shard_of(torch.stack([a["v"] for a in arranged]), length)
            if "cross" in per[0]:
                entry["cross"] = {name: torch.stack([c["cross"][j] for c in per])
                                  for j, name in enumerate(("k", "v"))}
        elif blk.kind == "mamba":
            entry["mamba"] = {k: torch.stack([c["mamba"][k] for c in per])
                              for k in ("ssm", "conv")}
        layers[f"pos{i}"] = entry
    cache = {"pos": torch.full((), S, dtype=torch.int32, device=tokens.device),
             "layers": _wrap_cache(layers, cfg, B, max_len)}
    if cfg.enc_dec:
        cache["enc_len"] = enc_out.shape[1]
    return logits, cache


def _length_axes(cfg: ArchConfig, batch: int, length: int):
    """The axes a self-attention cache of ``length`` keys splits its length
    over (``context.length_axes``): the data axes at a batch of 1, "model"
    on the head fallback (no Q-head and no KV-head axis), else None."""
    q_ax, kv_ax, _ = attn_mod._head_layout(cfg)
    return ctx.length_axes(batch, length, heads_whole=q_ax is None and kv_ax is None)


def _cache_specs(cfg: ArchConfig, blk: Block, batch: int, max_len: int) -> dict:
    """The specs of one block position's cache leaves, as its entry of the
    cache nests them, in the kernels' layout: rows over the data axes where
    they divide them, KV heads (Mamba heads) over "model" where they divide
    it, the head dim whole.  A self-attention cache's length goes over the
    data axes where they do not divide the batch and do divide the length
    (the JAX package's ``cache_shardings`` for a batch of 1), else over
    "model" where the attention keeps every head on every model rank and
    "model" divides the length (``_length_axes``; the JAX package puts the
    batch over "model" and the length over the data axes there: the same
    share a rank), else stays whole, as the cross cache's always does.  The
    Mamba state stays whole over the data axes (the JAX package shards its
    largest dim over them at a batch of 1)."""
    bs = ctx.batch_spec(batch)
    if blk.kind == "mamba":
        return {"mamba": {"ssm": (None, bs, ssm_mod.head_axis(cfg), None, None),
                          "conv": (None, bs, None, None)}}
    kv_ax = attn_mod._head_layout(cfg)[1]
    kv = (None, bs, kv_ax, _length_axes(cfg, batch, attn_mod.cache_len(blk, max_len)), None)
    cross = (None, bs, kv_ax, None, None)
    return {"k": kv, "v": kv, "cross": {"k": cross, "v": cross}}


def _wrap_cache(layers: dict, cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Every rank's local cache as DTensors (``_cache_specs``); with no mesh,
    as it is."""
    def wrap(tree, specs):
        return {k: wrap(v, specs[k]) if isinstance(v, dict) else spmd.wrap(v, *specs[k])
                for k, v in tree.items()}
    return {f"pos{i}": wrap(layers[f"pos{i}"], _cache_specs(cfg, blk, batch, max_len))
            for i, blk in enumerate(cfg.pattern)}


def _local_cache(layers: dict) -> dict:
    """Each rank's shards of a cache of DTensors (views: written in place)."""
    return {k: _local_cache(v) if isinstance(v, dict) else ctx.local(v)
            for k, v in layers.items()}


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                      cache_dtype=torch.bfloat16, enc_len: int = 0, device=None):
    """A zero cache for decode alone (the decode-only dry-run cells): the
    layout ``prefill`` returns, with ``pos`` = max_len - 1 (a 0-d int32
    tensor on ``device``: on meta for the dry run's specs).  The cross
    caches (n_per, B, Hkv, enc_len, Dh) are in ``cache_dtype`` here, as the
    JAX package makes them.  The JAX package broadcasts one zero block over
    the periods; ``decode_step`` writes the port's cache in place, so every
    period gets its own.  Under a mesh each rank allocates its shard only
    (``_cache_specs``)."""
    n_per = cfg.n_periods
    meta = torch.device("meta")             # the whole cache's shapes

    def stacked(one: dict) -> dict:
        return {k: torch.empty((n_per, *t.shape), dtype=t.dtype, device=meta)
                for k, t in one.items()}
    layers = {}
    for i, blk in enumerate(cfg.pattern):
        entry = {}
        if blk.kind == "attn":
            entry.update(stacked(attn_mod.attn_cache_init(cfg, blk, batch, max_len,
                                                          cache_dtype, meta)))
            if blk.cross_attn and cfg.enc_dec:
                shape = (n_per, batch, cfg.n_kv_heads, enc_len, cfg.head_dim)
                entry["cross"] = {k: torch.empty(shape, dtype=cache_dtype, device=meta)
                                  for k in ("k", "v")}
        elif blk.kind == "mamba":
            entry["mamba"] = stacked(ssm_mod.mamba_cache_init(cfg, batch, meta))
        layers[f"pos{i}"] = entry

    def local(tree, specs):               # this rank's shards of the zero cache
        return {k: local(v, specs[k]) if isinstance(v, dict) else
                torch.zeros(_shard_of(v, specs[k]).shape, dtype=v.dtype, device=device)
                for k, v in tree.items()}
    layers = {f"pos{i}": local(layers[f"pos{i}"], _cache_specs(cfg, blk, batch, max_len))
              for i, blk in enumerate(cfg.pattern)}
    cache = {"pos": torch.full((), max_len - 1, dtype=torch.int32, device=device),
             "layers": _wrap_cache(layers, cfg, batch, max_len)}
    if cfg.enc_dec:
        cache["enc_len"] = enc_len
    return cache


def _shard_of(t: torch.Tensor, spec) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` placed by ``spec``."""
    for dim, entry in enumerate(spec):
        if entry == "model":
            t = t.chunk(ctx.axis_size("model"), dim)[spmd.rank("model")]
        elif entry is not None:                          # the data axes
            t = t.chunk(spmd.dp_size(), dim)[spmd.dp_rank()]
    return t.contiguous()


def decode_step(params, cfg: ArchConfig, cache, token, *,
                compute_dtype=torch.bfloat16, impl=None):
    """One token for every sequence in the batch.  token: (B,) int.

    The cache's tensors are updated in place (the JAX package returns new
    arrays); the returned cache is a new dict over the same tensors with
    ``pos`` + 1, a new 0-d tensor.  The position stays on the device: every
    layer computes its rotary angle, slot and valid length from it there
    (``attn_decode``), so the step never reads it on the host, and
    ``launch.serve`` can capture the step in a CUDA graph.  An attention
    cache whose length the mesh
    splits, over the data axes at a batch of 1 or over "model" on the head
    fallback (``_length_axes``; its global length is the DTensor's),
    decodes each rank's shard and merges the ranks' partials
    (``attn_decode``).  Under a mesh every product multiplies this rank's
    shard of its weight (``spmd.stationary``): no weight is gathered, and
    the step takes no gradient."""
    B = token.shape[0]
    split = {pos: _length_axes(cfg, B, c["k"].shape[3]) if "k" in c else None
             for pos, c in cache["layers"].items()}
    token, layers = spmd.local_rows(token), _local_cache(cache["layers"])
    with spmd.rows(spmd.batch_sharded(B)), spmd.stationary():
        x = _embed(params, cfg, token, compute_dtype=compute_dtype)
        pos = cache["pos"]
        enc_len = cache.get("enc_len", 0)
        for per, pslice in enumerate(_unstack(params["dec"], cfg.n_periods)):
            for i, blk in enumerate(cfg.pattern):
                p, c = pslice[f"pos{i}"], layers[f"pos{i}"]
                if blk.kind == "attn":
                    cross = ({"k": c["cross"]["k"][per], "v": c["cross"]["v"][per]}
                             if "cross" in c else None)
                    x = attn_mod.attn_decode(
                        x, p["attn"], {"k": c["k"][per], "v": c["v"][per]}, cfg, blk,
                        pos=pos, compute_dtype=compute_dtype, cross_cache=cross,
                        enc_len=enc_len, impl=impl, length_axes=split[f"pos{i}"])
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
        logits, v_ax = _head(params, cfg, x, compute_dtype)
        logits = _wrap_logits(logits, cfg, B, v_ax)
    return logits, dict(cache, pos=pos + 1)
