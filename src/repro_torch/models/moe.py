"""Token-choice top-k Mixture-of-Experts with fixed-capacity dispatch: the
counterpart of ``repro.models.moe``.

Off a mesh the JAX package takes ``_moe_apply_global(groups=1)`` ->
``_moe_flat``: router softmax in fp32 -> top-k (ties to the lower expert) ->
gate renormalisation -> rank within expert by a cumsum in (token, slot)
order -> scatter into a capacity-bounded (E, cap, D) buffer with an overflow
row for dropped tokens -> expert products -> weighted combine.  This module
is that path, step for step (``_dispatch``).  The expert products are plain
batched matrix products: no Pallas kernel ran them.

``_moe_apply_global(groups=G)`` splits the tokens into G contiguous groups,
each with its own capacity and dispatch, as the JAX package's grouped path
does.  Under a mesh ``moe_apply`` makes the JAX package's decision:
per-shard dispatch (each data-parallel rank dispatches its own tokens with
a per-shard capacity: the grouped semantics with G = the data-parallel
size) when the mesh has data axes, they divide the batch, no auxiliary loss
is asked for and a shard holds at least ``PER_SHARD_MIN_TOKENS`` tokens;
else global dispatch over the tokens of every data-parallel rank, each rank
keeping its own rows.  Expert weights are EP over ``model`` when the expert
count divides it, else TP over the expert hidden dim
(``distributed.sharding``): each model rank computes its experts' (or its
hidden slice's) part of the output, and the parts are summed over
``model``.  Every model rank routes the same tokens the same way, so the
drop order is ``_moe_flat``'s on each.  In decode (``spmd.stationary``) the
router and the expert products take each data rank's slice of D, and
``w_down``'s columns are gathered over "data": each data rank multiplies
1/dp of every expert weight, and capacity, top-k order and drops are
unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import context as ctx
from repro_torch.distributed import spmd
from repro_torch.models.layers import norm_apply, norm_init, normal_init

PER_SHARD_MIN_TOKENS = 256     # below it the JAX package keeps global dispatch


def moe_init(gen, cfg: ArchConfig, *, device=None, dtype=torch.float32, lead=()):
    m = cfg.moe
    D, E, Fd = cfg.d_model, m.n_experts, m.d_ff_expert
    kw = dict(device=device, dtype=dtype)
    p = {
        "norm": norm_init(cfg, D, device, lead),
        "router": normal_init(gen, (*lead, D, E), **kw),
        "w_gate": normal_init(gen, (*lead, E, D, Fd), **kw),
        "w_up": normal_init(gen, (*lead, E, D, Fd), **kw),
        "w_down": normal_init(gen, (*lead, E, Fd, D), **kw),
    }
    if cfg.post_norms:
        p["post_norm"] = norm_init(cfg, D, device, lead)
    return p


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert: int(max(8, ceil(Nt K / E) * capacity_factor)),
    clipped to the token count."""
    m = cfg.moe
    cap = int(max(8, -(-n_tokens * m.top_k // m.n_experts) * m.capacity_factor))
    return min(cap, n_tokens)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    toward the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(x, p, cfg: ArchConfig, compute_dtype, return_aux: bool = False):
    """x: (B, S, D) -> x + MoE(norm(x)), global dispatch over all B x S tokens
    (under a mesh: the dispatch decision of the module docstring).  With
    ``return_aux``, (result, aux): the Switch-style load-balancing loss
    E * sum_e f_e p_e, f_e the share of tokens whose first choice is expert
    e and p_e the mean router probability of e."""
    B, S, D = x.shape
    E = cfg.moe.n_experts
    sharded = spmd.rows_sharded()
    per_shard = bool(ctx.batch_axes()) and sharded and not return_aux \
        and B * S >= PER_SHARD_MIN_TOKENS
    experts = _expert_specs(cfg)
    split = experts.split
    h = norm_apply(x, spmd.use(p["norm"]), cfg).to(compute_dtype)
    if split:
        h = spmd.enter_model(h)
    hf = h if per_shard or not sharded else spmd.gather_rows(h, partial=True)
    with spmd.rows(per_shard):               # global dispatch: every rank's rows, whole
        y, probs, gate_idx = _dispatch(hf.reshape(-1, D), p, cfg, compute_dtype, experts)
    y = y.reshape(-1, S, D)
    if not per_shard and sharded:            # global dispatch: keep this rank's rows
        y = y[spmd.dp_rank() * B:(spmd.dp_rank() + 1) * B]
    if split:
        y = spmd.sum_model(y)
    post = {"post_norm": spmd.use(p["post_norm"])} if cfg.post_norms else {}
    result = _finish(x, y, post, cfg)
    if not return_aux:
        return result
    if not (sharded or split):              # the dispatch saw every token, whole
        return result, _aux(probs, gate_idx, E)
    # the auxiliary loss over every token, alike on every rank: its gradient
    # is whole on each, unlike the dispatch's partial sums
    whole = dict(rows_partial=False)
    hx = norm_apply(x, spmd.use(p["norm"], **whole), cfg).to(compute_dtype)
    if sharded:
        hx = spmd.gather_rows(hx, partial=False)
    logits = spmd.dot(hx.reshape(-1, D), p["router"], **whole).float()
    probs = torch.softmax(logits, dim=-1)
    return result, _aux(probs, top_k(probs, cfg.moe.top_k)[1], E)


def _experts(buf, p, experts: _Experts):
    """The expert products on an (E, cap, D) buffer (this rank's experts)."""
    a = F.silu(spmd.dot(buf, p["w_gate"], *experts.wspec))
    u = spmd.dot(buf, p["w_up"], *experts.wspec)
    return spmd.dot(a * u, p["w_down"], *experts.dspec)         # (E, cap, D)


def _dispatch(hf, p, cfg: ArchConfig, compute_dtype, experts: _Experts):
    """The flat dispatch of the tokens ``hf`` (Nt, D) through the router and
    expert weights of ``p``: returns the combined expert output y (Nt, D)
    in fp32, the router probabilities and the top-k indices.  ``experts``
    may give this rank a slice of the experts, from ``expert0`` on (EP), or
    of the hidden dim (TP): y is then this slice's part of the output."""
    m = cfg.moe
    Nt, D = hf.shape
    E, K = m.n_experts, m.top_k
    logits = spmd.dot(hf, p["router"], model_partial=experts.split).float()
    probs = torch.softmax(logits, dim=-1)                  # (Nt, E)
    gate_vals, gate_idx = top_k(probs, K)                  # (Nt, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    cap = capacity(Nt, cfg)
    eidx = gate_idx.reshape(-1)                            # (Nt*K,) token-major
    onehot = (eidx[:, None] == torch.arange(E, device=hf.device)).long()
    rank = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(rank, 1, eidx[:, None])[:, 0]
    keep = pos < cap
    dst = torch.where(keep, eidx * cap + pos, torch.full_like(eidx, E * cap))

    src_rows = hf.repeat_interleave(K, dim=0)              # (Nt*K, D)
    buf = torch.zeros((E * cap + 1, D), dtype=compute_dtype, device=hf.device)
    buf.index_copy_(0, dst, src_rows)                      # overflow row = drop
    buf = buf[:-1].reshape(E, cap, D)

    e0, n_local = experts.expert0, experts.n_local
    out = _experts(buf[e0:e0 + n_local], p, experts)
    if n_local != E:                                       # EP: the other experts are 0 here
        out = torch.cat([out.new_zeros((e0, cap, D)), out,
                         out.new_zeros((E - e0 - n_local, cap, D))])
    out_flat = torch.cat([out.reshape(E * cap, D),
                          torch.zeros((1, D), dtype=compute_dtype, device=hf.device)])
    gathered = out_flat[dst]                               # (Nt*K, D)
    weighted = gathered.float() * gate_vals.reshape(-1)[:, None]
    return weighted.reshape(Nt, K, D).sum(dim=1), probs, gate_idx


def _aux(probs, gate_idx, E: int):
    frac_tokens = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
    return E * torch.sum(frac_tokens * probs.mean(dim=0))


def _finish(x, y, p, cfg: ArchConfig):
    if cfg.post_norms:
        y = norm_apply(y.to(x.dtype), p["post_norm"], cfg).float()
    return x + y.to(x.dtype)


def _moe_apply_global(x, p, cfg: ArchConfig, compute_dtype, return_aux: bool = False,
                      groups: int = 1):
    """Dispatch in ``groups`` contiguous groups of the B x S tokens, each with
    its own capacity (``groups=1``: the flat path, ``_moe_flat``)."""
    B, S, D = x.shape
    E = cfg.moe.n_experts
    Nt = B * S
    if Nt % groups:
        raise ValueError(f"{Nt} tokens do not split into {groups} groups")
    hf = norm_apply(x, p["norm"], cfg).to(compute_dtype).reshape(Nt, D)
    parts = [_dispatch(h, p, cfg, compute_dtype, _expert_specs(cfg)) for h in hf.chunk(groups)]
    y = torch.cat([t[0] for t in parts]).reshape(B, S, D)
    result = _finish(x, y, p, cfg)
    if return_aux:
        return result, _aux(torch.cat([t[1] for t in parts]),
                            torch.cat([t[2] for t in parts]), E)
    return result


class _Experts(NamedTuple):
    """How this rank holds the expert weights: the specs of w_gate / w_up
    and of w_down for ``spmd.dot``, whether the work splits over "model",
    and its experts' range [expert0, expert0 + n_local)."""
    wspec: tuple
    dspec: tuple
    split: bool
    expert0: int
    n_local: int


def _expert_specs(cfg: ArchConfig) -> _Experts:
    """Per-period expert-weight layout: EP over ``model`` when the expert
    count divides it, else TP over the hidden dim when that divides it, else
    whole."""
    m = cfg.moe
    E = m.n_experts
    if ctx.div_axis(E):
        n = E // ctx.axis_size("model")
        return _Experts(("model", None, None), ("model", None, None), True,
                        spmd.rank("model") * n, n)
    if ctx.div_axis(m.d_ff_expert):
        return _Experts((None, None, "model"), (None, "model", None), True, 0, E)
    return _Experts((None, None, None), (None, None, None), False, 0, E)
