"""Plain PyTorch reference oracles (the counterpart of ``repro.kernels.ref``).

``mha_reference`` is the correctness gate's oracle: naive attention with the
full score matrix materialized, in fp32, at small shapes only.  The blocked
and banded attention references, the decode oracle and the three SSD oracles
are the ``blocked`` / ``naive`` paths of ``ops`` and the ground truth the
kernels' plain versions are held against.  Each follows the JAX function of
the same name line for line (``jax.lax.scan`` becomes a Python loop).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/where() NaN-free


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def mha_reference(
    q: torch.Tensor,               # (B, Hq, Sq, D)
    k: torch.Tensor,               # (B, Hkv, Sk, D)
    v: torch.Tensor,               # (B, Hkv, Sk, D)
    *,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Naive attention with full score materialization.  GQA via head repeat.

    ``q_offset`` is the absolute position of q[…, 0, :] (used when scoring a
    suffix of the sequence against a longer K/V, e.g. decode).
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    assert Hq % Hkv == 0
    rep = Hq // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = _softcap(s, softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


def flash_reference_blocked(
    q: torch.Tensor,               # (B, Hq, Sq, D)
    k: torch.Tensor,               # (B, Hkv, Sk, D)
    v: torch.Tensor,               # (B, Hkv, Sk, D)
    *,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    block_k: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """FlashAttention math as a loop over K/V chunks: never more than
    (B, Hq, Sq, block_k) scores at once."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    rep = Hq // Hkv
    scale_ = scale if scale is not None else 1.0 / (D ** 0.5)
    bk = min(block_k, Sk)
    pad = (-Sk) % bk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    nk = (Sk + pad) // bk
    qf = q.float()
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    for j in range(nk):
        kb, vb = k[:, :, j * bk:(j + 1) * bk], v[:, :, j * bk:(j + 1) * bk]
        if rep > 1:
            kb = kb.repeat_interleave(rep, dim=1)
            vb = vb.repeat_interleave(rep, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()) * scale_
        s = _softcap(s, softcap)
        kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
        mask = kpos < Sk
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
        l = l * alpha + p.sum(dim=-1)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def flash_reference_banded(
    q: torch.Tensor,               # (B, Hq, S, D)
    k: torch.Tensor,               # (B, Hkv, S, D)
    v: torch.Tensor,               # (B, Hkv, S, D)
    *,
    window: int,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    chunk_q: int = 2048,
) -> torch.Tensor:
    """Causal sliding-window attention over static K/V bands: each q chunk
    of ``cq`` rows attends a band of ``window + cq`` keys."""
    B, Hq, S, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if S != Sk:
        raise ValueError("the banded path assumes aligned q/k (prefill)")
    rep = Hq // Hkv
    scale_ = scale if scale is not None else 1.0 / (D ** 0.5)
    cq = min(chunk_q, S)
    if S % cq:
        raise ValueError(f"S={S} is not a multiple of chunk_q={cq}")
    band = min(S, window + cq)
    kr = k.repeat_interleave(rep, dim=1) if rep > 1 else k
    vr = v.repeat_interleave(rep, dim=1) if rep > 1 else v
    qf = q.float()
    chunks = []
    for i in range(S // cq):
        q_lo = i * cq
        start = max(0, q_lo + cq - band)
        kb, vb = kr[:, :, start:start + band], vr[:, :, start:start + band]
        s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, q_lo:q_lo + cq],
                         kb.float()) * scale_
        s = _softcap(s, softcap)
        qpos = q_lo + torch.arange(cq, device=q.device)[:, None]
        kpos = start + torch.arange(band, device=q.device)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        chunks.append(torch.einsum("bhqk,bhkd->bhqd", p, vb.float()).to(q.dtype))
    return torch.cat(chunks, dim=2)


def decode_reference(
    q: torch.Tensor,               # (B, Hq, D): one new token per sequence
    k_cache: torch.Tensor,         # (B, Hkv, L, D)
    v_cache: torch.Tensor,         # (B, Hkv, L, D)
    valid_len: torch.Tensor,       # (B,) int32: entries [0, valid_len) are live
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, D = q.shape
    _, Hkv, L, _ = k_cache.shape
    rep = Hq // Hkv
    kc = k_cache.repeat_interleave(rep, dim=1) if rep > 1 else k_cache
    vc = v_cache.repeat_interleave(rep, dim=1) if rep > 1 else v_cache
    scale_ = scale if scale is not None else 1.0 / (D ** 0.5)
    s = torch.einsum("bhd,bhld->bhl", q.float(), kc.float()) * scale_
    s = _softcap(s, softcap)
    live = torch.arange(L, device=q.device)[None, :] < valid_len.to(q.device)[:, None]
    s = torch.where(live[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhl,bhld->bhd", p, vc.float())
    return o.to(q.dtype)


def _groups_to_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, L, G, N) -> (B, L, H, N): groups broadcast over heads."""
    return t.repeat_interleave(H // t.shape[2], dim=2)


def ssd_reference(
    x: torch.Tensor,               # (B, L, H, P)
    dt: torch.Tensor,              # (B, L, H): already softplus'd
    A: torch.Tensor,               # (H,): negative decay rates
    Bm: torch.Tensor,              # (B, L, G, N)
    Cm: torch.Tensor,              # (B, L, G, N)
    *,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> tuple:
    """Sequential SSD recurrence:  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t . h_t.  Groups broadcast over heads (H % G == 0)."""
    B, L, H, P = x.shape
    N = Bm.shape[3]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = _groups_to_heads(Bm, H).float(), _groups_to_heads(Cm, H).float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * Af[None, :])                    # (B, H)
        upd = torch.einsum("bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1)                                        # (B, L, H, P)
    return y.to(x.dtype), h


def ssd_chunked_reference(x, dt, A, Bm, Cm, *, chunk: int = 64,
                          init_state=None) -> tuple:
    """Chunked SSD (the algorithm the kernel implements): an intra-chunk
    quadratic term plus an inter-chunk state recurrence.  L % chunk == 0."""
    B, L, H, P = x.shape
    N = Bm.shape[3]
    Q = chunk
    if L % Q:
        raise ValueError(f"L={L} is not a multiple of chunk={Q}")
    Bh, Ch = _groups_to_heads(Bm, H).float(), _groups_to_heads(Cm, H).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ii = torch.arange(Q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    ys = []
    for c in range(L // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xf[:, sl], dtf[:, sl], Bh[:, sl], Ch[:, sl]
        cum = torch.cumsum(dtq * Af[None, None, :], dim=1)           # (B, Q, H)
        total = cum[:, -1]                                            # (B, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]                 # (B, Qi, Qj, H)
        # mask BEFORE exp: future entries have seg >> 0
        decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, NEG_INF)))
        cb = torch.einsum("bihn,bjhn->bijh", Cq, Bq)
        w = cb * decay * dtq[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xq)
        y_inter = torch.einsum("bihn,bhpn,bih->bihp", Cq, h, torch.exp(cum))
        w_state = torch.exp(total[:, None, :] - cum) * dtq            # (B, Q, H)
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bjh,bjhp,bjhn->bhpn", w_state, xq, Bq)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return y.to(x.dtype), h


def ssd_decode_reference(
    x_t: torch.Tensor,             # (B, H, P): one step
    dt_t: torch.Tensor,            # (B, H)
    A: torch.Tensor,               # (H,)
    B_t: torch.Tensor,             # (B, G, N)
    C_t: torch.Tensor,             # (B, G, N)
    state: torch.Tensor,           # (B, H, P, N)
) -> tuple:
    H = x_t.shape[1]
    hpg = H // B_t.shape[1]
    Bh = B_t.repeat_interleave(hpg, dim=1).float()
    Ch = C_t.repeat_interleave(hpg, dim=1).float()
    decay = torch.exp(dt_t.float() * A.float()[None])
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt_t.float(), x_t.float(), Bh)
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x_t.dtype), state
