"""Attention block: projections, kernel dispatch and KV-cache management.

The counterpart of ``repro.models.attention``.  Cache layout per block
position: (B, Hkv, Lc, Dh) with Lc = min(window, max_len): sliding-window
layers keep a ring buffer of exactly the window.  Keys are rotary-encoded at write time (absolute
positions), so ring order is free.

Cross-attention (the encoder-decoder's decoder blocks) has parameters of its
own, prefixed ``c_`` (no bias, no post-norm): queries from the decoder,
keys and values from the encoder's memory, no rotary encoding, no mask.  At
decode it reads a cross cache of the memory's K/V that is never written.

Unlike the JAX package, whose arrays are immutable, ``attn_decode`` writes
the new token's K/V into the cache in place (one slot of the preallocated
buffer), so a decode step allocates no new cache.

Under a mesh (``distributed.spmd``) each rank runs the block on its rows
and launches the kernels on its local shard: Q heads over "model" when
``n_heads`` divides it, KV heads when ``n_kv_heads`` does
(``_head_layout``), the output projection's parts summed over "model".
Where Q heads divide and KV heads do not, each rank keeps all KV heads and
reads the ones its Q heads share; where no cache is kept (training), it
projects only those (``_own_kv``).  Where the Q heads do not divide
(qwen2-7b's 28 heads on 16 model ranks), a self-attention in prefill and
training takes the JAX package's sequence parallelism for Q/O where
"model" divides the sequence (``_row_split``): model rank r projects Q from its rows [r S/m, (r + 1)
S/m), K/V from all S, launches the kernel with ``q_offset`` = r S/m,
multiplies its rows by ``wo`` and gathers the rows over "model".  Where the
sequence does not divide either, and in cross-attention and decode, every
model rank computes all heads (the head fallback).  The decode cache is
held in the same layout, its head dim whole, and its length split where
``context.length_axes`` says: over the data axes where they do not divide
the batch and do divide the length (a batch of 1 at long context), else
over "model" where a self-attention takes the head fallback and "model"
divides the length (qwen2-7b's 28 heads on 16 model ranks: each holds and
reads 1/16 of its rows' keys, 1/256 of the cache on (data=16, model=16),
as the reference's chip does with the batch over "model" and the length
over "data"; Q and the output projection stay whole).  Each rank then
decodes its shard with the kernel's partial mode, and the ranks' partials
are merged (``spmd.merge_over``) before the output projection.  Otherwise
the length stays whole, as the cross cache's always does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, Block
from repro_torch.distributed import context as ctx
from repro_torch.distributed import spmd
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


def _head_layout(cfg: ArchConfig):
    """The kernels' layout: (Q-head axis, KV-head axis, the
    KV heads this model rank reads or None).  Q heads go over "model" when
    ``n_heads`` divides it, KV heads when ``n_kv_heads`` does.  Where the Q
    heads divide and the KV heads do not, each model rank holds every KV
    head and reads the contiguous range its Q heads share; where that range
    is uneven across the Q heads, or the Q heads do not divide, every model
    rank holds all heads: the head fallback, or, for a self-attention over
    a sequence "model" divides, the row split (``_row_split``).  With no
    mesh: (None, None, None), every head."""
    q_ax, kv_ax = ctx.div_axis(cfg.n_heads), ctx.div_axis(cfg.n_kv_heads)
    kv_range = None
    if q_ax is not None and kv_ax is None:
        hq = cfg.n_heads // ctx.axis_size("model")      # local Q heads
        rep = cfg.n_heads // cfg.n_kv_heads
        if hq % rep == 0 or rep % hq == 0:
            r = spmd.rank("model")
            kv_range = ((r * hq) // rep, ((r + 1) * hq - 1) // rep + 1)
        else:
            q_ax = None
    return q_ax, kv_ax, kv_range


# since the caller last set them to 0: self-attentions that took the row
# split (``_row_split``), decode self-attentions whose cache length is
# split over "model" (``attn_decode``'s ``length_axes``), and attentions
# that projected only this rank's KV heads (``_own_kv``)
counts = {"row_split": 0, "length_model": 0, "kv_columns": 0}


def _own_kv(kv_range, return_kv: bool) -> bool:
    """Whether ``attn_apply`` projects only the KV heads this model rank
    reads (``kv_range``, from ``_head_layout``): where "model" has more
    than one rank and no K/V is kept for a cache, which holds every KV head
    on each model rank (prefill projects them whole)."""
    return kv_range is not None and ctx.axis_size("model") > 1 and not return_kv


def _row_split(cfg: ArchConfig, S: int):
    """This model rank's query rows as a slice, where a self-attention of
    ``S`` rows takes the JAX package's sequence parallelism for Q/O (its Q
    heads do not divide "model" and "model" divides S), else None."""
    if ctx.div_axis(cfg.n_heads) is not None or ctx.div_axis(S) is None:
        return None
    n = S // ctx.axis_size("model")
    lo = spmd.rank("model") * n
    return slice(lo, lo + n)


def _local_heads(cfg: ArchConfig, q_ax, kv_ax) -> tuple:
    m = ctx.axis_size("model")
    return (cfg.n_heads // m if q_ax else cfg.n_heads,
            cfg.n_kv_heads // m if kv_ax else cfg.n_kv_heads)


def _kv_partial(q_ax, kv_ax, rows=None) -> dict:
    """``spmd``'s keywords for K/V's weights and biases: partial over "model"
    where each model rank holds K/V whole and reads its part (its Q heads',
    or its query rows')."""
    return dict(model_partial=rows is not None or (q_ax is not None and kv_ax is None))


def _kv_columns(t, cols: Optional[slice]):
    """The columns ``cols`` of ``t``'s last dim (``_own_kv``), or all."""
    return t if cols is None else t[..., cols]


def _biases(p, q_ax, kv_ax, compute_dtype, rows=None, cols=None) -> dict:
    """The self-attention's Q/K/V biases as this rank adds them; K's and V's
    columns ``cols`` only, where given."""
    kv = _kv_partial(q_ax, kv_ax, rows)
    return {"bq": spmd.use(p["bq"], q_ax, model_partial=rows is not None).to(compute_dtype),
            "bk": _kv_columns(spmd.use(p["bk"], kv_ax, **kv), cols).to(compute_dtype),
            "bv": _kv_columns(spmd.use(p["bv"], kv_ax, **kv), cols).to(compute_dtype)}


def _kv_read(t, kv_range):
    """The KV heads (dim 1) this model rank reads: all, or its range."""
    return t if kv_range is None else t[:, kv_range[0]:kv_range[1]]


def attn_apply(x, p, cfg: ArchConfig, blk: Block, *, causal: bool, compute_dtype,
               kv_source: Optional[torch.Tensor] = None,
               impl: Optional[str] = None, genome: Optional[dict] = None,
               return_kv: bool = False):
    """Full-sequence attention (train / prefill).  x: (B, S, D).  With
    ``kv_source`` (the encoder's memory, (B, Se, D)) it is cross-attention:
    the ``c_`` parameters, keys and values from the memory, no rotary
    encoding, no mask whatever ``causal`` and the block's window say.
    Under a mesh it runs on this rank's rows: the kernel on its local heads
    (``_head_layout``), the output projection's parts summed over "model";
    or, on the row split (``_row_split``), on its query rows, the rows of
    the output gathered over "model".  Either way the result is whole over
    "model", as ``x`` is.  Where the rank reads a range of KV heads and
    keeps no K/V (``_own_kv``), it multiplies by only those heads' columns
    of the whole ``wk`` and ``wv`` (the others' gradient 0 on this rank,
    the parts summed over "model")."""
    cross = kv_source is not None
    prefix = "c_" if cross else ""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    q_ax, kv_ax, kv_range = _head_layout(cfg)
    hq, hkv = _local_heads(cfg, q_ax, kv_ax)
    cols = None                   # K/V's columns of this rank's KV heads, on _own_kv
    if _own_kv(kv_range, return_kv):
        cols, hkv = slice(kv_range[0] * Dh, kv_range[1] * Dh), kv_range[1] - kv_range[0]
        kv_range = None           # K/V hold only the heads this rank reads
    rows = None if cross else _row_split(cfg, S)
    split = q_ax is not None or rows is not None
    h = norm_apply(x, spmd.use(p[prefix + "norm"]), cfg).to(compute_dtype)
    src = kv_source.to(compute_dtype) if cross else h
    if split:                     # each model rank's part: the backward sums them
        h = spmd.enter_model(h)
        src = spmd.enter_model(src) if cross else h
    Sk = src.shape[1]
    # Q over this rank's heads or rows [q0, q0 + Sq), K and V over its KV
    # heads or whole (spmd.dot); on the row split every weight's gradient
    # is partial
    hr, q0 = (h, 0) if rows is None else (h[:, rows], rows.start)
    Sq = hr.shape[1]
    part = dict(model_partial=rows is not None)
    kv = _kv_partial(q_ax, kv_ax, rows)
    q = spmd.dot(hr, p[prefix + "wq"], None, q_ax, **part)
    if cols is None:
        k = spmd.dot(src, p[prefix + "wk"], None, kv_ax, **kv)
        v = spmd.dot(src, p[prefix + "wv"], None, kv_ax, **kv)
    else:                         # the whole weights' columns, cast as dot casts
        k = src @ _kv_columns(spmd.use(p[prefix + "wk"], **kv), cols).to(src.dtype)
        v = src @ _kv_columns(spmd.use(p[prefix + "wv"], **kv), cols).to(src.dtype)
        counts["kv_columns"] += 1
    if not cross and cfg.qkv_bias:
        b = _biases(p, q_ax, kv_ax, compute_dtype, rows, cols)
        q, k, v = q + b["bq"], k + b["bk"], v + b["bv"]
    q, k, v = (q.reshape(B, Sq, hq, Dh), k.reshape(B, Sk, hkv, Dh), v.reshape(B, Sk, hkv, Dh))
    if not cross:
        pos = torch.arange(S, device=x.device)
        q = rope_apply(q, pos if rows is None else pos[rows], cfg.rope_theta)
        k = rope_apply(k, pos, cfg.rope_theta)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = ops.attention(qt, _kv_read(kt, kv_range), _kv_read(vt, kv_range),
                      causal=causal and not cross,
                      window=None if cross else blk.window, softcap=cfg.attn_softcap,
                      q_offset=q0, impl=impl, genome=genome)
    out = spmd.dot(o.transpose(1, 2).reshape(B, Sq, hq * Dh), p[prefix + "wo"], q_ax, None,
                   **part)
    if rows is not None:
        counts["row_split"] += 1
        out = spmd.gather(out, 1, "model", partial=False)
    elif split:
        out = spmd.sum_model(out)
    if cfg.post_norms and not cross:
        out = norm_apply(out.to(x.dtype), spmd.use(p["post_norm"]), cfg)
    result = x + out.to(x.dtype)
    if return_kv:
        return result, (kt, vt)      # (B, Hkv, S or Se, Dh): the cache layout
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


def _write_slot(cache, at, new, masked: bool) -> None:
    """Writes ``new`` (B, Hkv, Dh) into slot ``at`` (a 0-d tensor on the
    device) of ``cache`` (B, Hkv, Lr, Dh), in place.  With ``masked`` the
    slot may lie outside [0, Lr) (another rank's): the write goes to the
    clamped slot and puts back what is there, so that no rank reads ``at``
    on the host."""
    idx = at.clamp(0, cache.shape[2] - 1).reshape(1).long()
    new = new.to(cache.dtype)[:, :, None]
    if masked:
        own = (at >= 0) & (at < cache.shape[2])
        new = torch.where(own, new, cache.index_select(2, idx))
    cache.index_copy_(2, idx, new)


def attn_decode(x, p, cache, cfg: ArchConfig, blk: Block, *, pos, compute_dtype,
                cross_cache: Optional[dict] = None, enc_len: Optional[int] = None,
                impl: Optional[str] = None, length_axes=None):
    """Single-token attention.  x: (B, D); pos: the absolute position (one
    for the whole batch: decode runs in lockstep), a 0-d int32 tensor on
    x's device, as ``decode_step`` keeps it (a Python int is moved there).
    Everything that depends on it is computed on the device: the rotary
    angle, the slot (pos % Lc on a window, else clamped to the last slot,
    as the JAX package's ``dynamic_update_slice`` clamps) and the valid
    length, so the step reads nothing on the host and can be captured in a
    CUDA graph.  Writes the token's K/V into ``cache`` in place and returns
    the new x.  With ``cross_cache`` ({"k", "v"}: (B, Hkv, Se, Dh)),
    cross-attention follows over its first ``enc_len`` keys; the cross
    cache is only read.  Under a mesh it runs on this rank's rows, and the
    caches hold this rank's shard (``_head_layout``).  With
    ``length_axes`` (``context.length_axes``: the data axes, or "model" on
    the head fallback) the self-attention cache holds this rank's shard
    over those axes of the length, slots [r Lr, (r + 1) Lr) of the whole Lc
    = n Lr: the rank that owns the token's slot writes it (a masked write
    on every rank), each rank decodes its live keys (keys sit in slots [0,
    min(pos + 1, Lc)), on a ring too; a rank with none reads a partial of
    weight 0) and the partials are merged across the ranks
    (``spmd.merge_over``).  Q and the output projection stay whole on every
    model rank there."""
    B = x.shape[0]
    Dh = cfg.head_dim
    q_ax, kv_ax, kv_range = _head_layout(cfg)
    hq, hkv = _local_heads(cfg, q_ax, kv_ax)
    split = q_ax is not None
    kw = dict(softcap=cfg.attn_softcap, impl=impl)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    h = norm_apply(x, spmd.use(p["norm"]), cfg).to(compute_dtype)
    kv = _kv_partial(q_ax, kv_ax)
    q = spmd.dot(h, p["wq"], None, q_ax)
    k = spmd.dot(h, p["wk"], None, kv_ax, **kv)
    v = spmd.dot(h, p["wv"], None, kv_ax, **kv)
    if cfg.qkv_bias:
        b = _biases(p, q_ax, kv_ax, compute_dtype)
        q, k, v = q + b["bq"], k + b["bk"], v + b["bv"]
    q = rope_apply(q.reshape(B, 1, hq, Dh), pos, cfg.rope_theta)[:, 0]
    k = rope_apply(k.reshape(B, 1, hkv, Dh), pos, cfg.rope_theta)[:, 0]
    kc, vc = cache["k"], cache["v"]
    Lr = kc.shape[2]                                 # this rank's slots
    n, r = spmd.axes_size(length_axes), spmd.axes_rank(length_axes)
    Lc, lo = n * Lr, r * Lr
    # the JAX package's dynamic_update_slice clamps an index past the end
    slot = torch.remainder(pos, Lc) if blk.window else pos.clamp(max=Lc - 1)
    masked = length_axes is not None
    _write_slot(kc, slot - lo, k, masked)
    _write_slot(vc, slot - lo, v.reshape(B, hkv, Dh), masked)
    live = ((pos + 1).clamp(max=Lc) - lo).clamp(0, Lr)
    valid_len = live.expand(B).contiguous()
    kr, vr = _kv_read(kc, kv_range), _kv_read(vc, kv_range)
    if length_axes is not None:
        if length_axes == "model":
            counts["length_model"] += 1
        o = spmd.merge_over(length_axes, *ops.decode_attention(q, kr, vr, valid_len,
                                                               partial=True, **kw)).to(q.dtype)
    else:
        o = ops.decode_attention(q, kr, vr, valid_len, **kw)
    out = spmd.dot(o.reshape(B, hq * Dh), p["wo"], q_ax, None)
    if split:
        out = spmd.sum_model(out)
    if cfg.post_norms:
        out = norm_apply(out.to(x.dtype), spmd.use(p["post_norm"]), cfg)
    x = x + out.to(x.dtype)

    if cross_cache is not None:
        hc = norm_apply(x, spmd.use(p["c_norm"]), cfg).to(compute_dtype)
        qc = spmd.dot(hc, p["c_wq"], None, q_ax).reshape(B, hq, Dh)
        vl = torch.full((B,), enc_len, dtype=torch.int32, device=x.device)
        ck, cv = (_kv_read(cross_cache[n], kv_range).to(compute_dtype) for n in ("k", "v"))
        oc = ops.decode_attention(qc, ck, cv, vl, **kw)
        out = spmd.dot(oc.reshape(B, hq * Dh), p["c_wo"], q_ax, None)
        x = x + (spmd.sum_model(out) if split else out).to(x.dtype)
    return x
