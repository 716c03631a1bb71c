"""Plain PyTorch reference oracles (the counterpart of ``repro.kernels.ref``).

``mha_reference`` is the correctness gate's oracle: naive attention with the
full score matrix materialized, in fp32, at small shapes only.  The other
oracles of the reference module come with the slices that need them.
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
