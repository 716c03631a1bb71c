"""Token-choice top-k Mixture-of-Experts with fixed-capacity dispatch: the
counterpart of ``repro.models.moe`` on one device.

Off a mesh the JAX package takes ``_moe_apply_global(groups=1)`` ->
``_moe_flat``: router softmax in fp32 -> top-k (ties to the lower expert) ->
gate renormalisation -> rank within expert by a cumsum in (token, slot)
order -> scatter into a capacity-bounded (E, cap, D) buffer with an overflow
row for dropped tokens -> expert products -> weighted combine.  This module
is that path, step for step.  The expert products are plain batched matrix
products: no Pallas kernel ran them.  The grouped and ``shard_map`` paths
wait for the multi-device item (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import norm_apply, norm_init, normal_init


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


def moe_apply(x, p, cfg: ArchConfig, compute_dtype):
    """x: (B, S, D) -> x + MoE(norm(x)), global dispatch over all B x S tokens."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    Nt = B * S
    hf = norm_apply(x, p["norm"], cfg).to(compute_dtype).reshape(Nt, D)
    logits = (hf @ p["router"].to(compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)                  # (Nt, E)
    gate_vals, gate_idx = top_k(probs, K)                  # (Nt, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    cap = capacity(Nt, cfg)
    eidx = gate_idx.reshape(-1)                            # (Nt*K,) token-major
    onehot = (eidx[:, None] == torch.arange(E, device=x.device)).long()
    rank = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(rank, 1, eidx[:, None])[:, 0]
    keep = pos < cap
    dst = torch.where(keep, eidx * cap + pos, torch.full_like(eidx, E * cap))

    src_rows = hf.repeat_interleave(K, dim=0)              # (Nt*K, D)
    buf = torch.zeros((E * cap + 1, D), dtype=compute_dtype, device=x.device)
    buf.index_copy_(0, dst, src_rows)                      # overflow row = drop
    buf = buf[:-1].reshape(E, cap, D)

    a = F.silu(torch.bmm(buf, p["w_gate"].to(compute_dtype)))
    u = torch.bmm(buf, p["w_up"].to(compute_dtype))
    out = torch.bmm(a * u, p["w_down"].to(compute_dtype))  # (E, cap, D)

    out_flat = torch.cat([out.reshape(E * cap, D),
                          torch.zeros((1, D), dtype=compute_dtype, device=x.device)])
    gathered = out_flat[dst]                               # (Nt*K, D)
    weighted = gathered.float() * gate_vals.reshape(-1)[:, None]
    y = weighted.reshape(Nt, K, D).sum(dim=1).reshape(B, S, D)
    if cfg.post_norms:
        y = norm_apply(y.to(x.dtype), p["post_norm"], cfg).float()
    return x + y.to(x.dtype)

