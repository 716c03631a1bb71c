"""Dispatch over the port's kernels, their plain versions and the
references: the counterpart of ``repro.kernels.ops``.

Implementation selection (``impl``):
  "kernel"   the kernel wrapper: the sm_90a kernel for CUDA tensors (it
             launches or raises), its plain version for CPU tensors
  "plain"    the kernels' plain PyTorch versions, on any device
  "blocked"  the online-softmax / chunked references of ``ref`` (the JAX
             package's "blocked" path)
  "naive"    full score matrix / sequential recurrence (tiny shapes only)
  "auto"     "kernel" for CUDA tensors, "blocked" otherwise (the default)

The active attention genome is a plain dict of kernel kwargs, so models stay
decoupled from the search code.

``checking(record)`` turns on the checking hook: while it is active, every
kernel launch is followed by the kernel's plain version on the same inputs
and ``record(name, stats)`` gets the bf16 agreement of the two.  Only
``chip_smoke.py`` and the card tests turn it on; nothing on the served path
does.  The check reads values on the host, so a decode step captured in a
CUDA graph cannot hold it: ``launch.serve.BatchedServer`` refuses a graph
while it is on (``checking_active``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd

DEFAULT_ATTN_GENOME = dict(
    block_q=128, block_k=128, rescale_mode="branchless",
    mask_mode="block_skip", div_mode="deferred", kv_in_grid=True,
    acc_dtype="f32",
)

IMPLS = ("kernel", "plain", "blocked", "naive", "auto")

_check: Optional[Callable[[str, dict], None]] = None


@contextlib.contextmanager
def checking(record: Callable[[str, dict], None]):
    """While active, hold every kernel launch against its plain version and
    hand ``(kernel name, agreement stats)`` to ``record``."""
    global _check
    prev, _check = _check, record
    try:
        yield
    finally:
        _check = prev


def checking_active() -> bool:
    """Whether the checking hook is on (a CUDA graph cannot hold it)."""
    return _check is not None


def resolve_impl(impl: Optional[str], t: torch.Tensor) -> str:
    impl = impl or "auto"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "kernel" if t.device.type == "cuda" else "blocked"
    return impl


def attention(
    q: torch.Tensor,               # (B, Hq, Sq, D)
    k: torch.Tensor,               # (B, Hkv, Sk, D)
    v: torch.Tensor,               # (B, Hkv, Sk, D)
    *,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,
    impl: Optional[str] = None,
    genome: Optional[dict] = None,
) -> torch.Tensor:
    impl = resolve_impl(impl, q)
    g = dict(DEFAULT_ATTN_GENOME, **(genome or {}))
    if impl in ("kernel", "plain"):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                  q_offset=q_offset, **g)
        if impl == "plain":
            return _fa.flash_attention_plain(q, k, v, **kw)
        out = _fa.flash_attention(q, k, v, **kw)
        if _check is not None and q.device.type == "cuda":
            plain = _fa.flash_attention_plain(q, k, v, **kw)
            mag = _fa.flash_attention_plain(q, k, v.abs(), **kw)
            _check("flash_attention", _fa.bf16_agreement(out, plain, mag))
        return out
    if impl == "blocked":
        # causal SWA with a band narrower than the sequence: the q-chunked
        # banded path skips dead key blocks entirely
        Sq, Sk = q.shape[2], k.shape[2]
        cq = min(2048, Sq)
        if (causal and window is not None and q_offset == 0 and Sq == Sk
                and Sq % cq == 0 and window + cq < Sk):
            return _ref.flash_reference_banded(
                q, k, v, window=window, softcap=softcap, scale=scale, chunk_q=cq)
        return _ref.flash_reference_blocked(
            q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
            block_k=max(512, g["block_k"]), q_offset=q_offset)
    return _ref.mha_reference(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,               # (B, Hq, D)
    k_cache: torch.Tensor,         # (B, Hkv, L, D)
    v_cache: torch.Tensor,         # (B, Hkv, L, D)
    valid_len: torch.Tensor,       # (B,) int32
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
    partial: bool = False,
):
    """One query token per sequence against its cache.  With ``partial``
    (the route of a cache whose length is sharded over ranks): ``(out, M,
    l)``, the output in fp32 and each query row's softmax statistics (B,
    Hq), which ``spmd.merge_over`` merges across the ranks; the
    checking hook holds the statistics against the plain version's too."""
    impl = resolve_impl(impl, q)
    if impl in ("kernel", "plain"):
        kw = dict(softcap=softcap, scale=scale, partial=partial)
        q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), v_cache.contiguous()
        if impl == "plain":
            return _fd.flash_decode_plain(q, k_cache, v_cache, valid_len, **kw)
        out = _fd.flash_decode(q, k_cache, v_cache, valid_len, **kw)
        if _check is not None and q.device.type == "cuda":
            kw["splits"] = _fd.kernel_splits(q, k_cache)     # like for like
            plain = _fd.flash_decode_plain(q, k_cache, v_cache, valid_len, **kw)
            mag = _fd.flash_decode_plain(q, k_cache, v_cache.abs(), valid_len, **kw)
            _check("flash_decode", _fd.partial_agreement(out, plain, mag[0]) if partial
                   else _fd.bf16_agreement(out, plain, mag))
        return out
    return _ref.decode_reference(q, k_cache, v_cache, valid_len,
                                 softcap=softcap, scale=scale, partial=partial)


def ssd(
    x: torch.Tensor,               # (B, L, H, P)
    dt: torch.Tensor,              # (B, L, H) fp32
    A: torch.Tensor,               # (H,) fp32
    Bm: torch.Tensor,              # (B, L, G, N)
    Cm: torch.Tensor,              # (B, L, G, N)
    *,
    chunk: int = 256,
    impl: Optional[str] = None,
) -> tuple:
    """Returns (y, final_state).  "kernel" and "plain" take any L (the last
    chunk may be short); the JAX package sends a ragged L to the chunked
    reference instead.  Like the JAX package, G > 1 goes to the chunked
    reference whatever ``impl`` says: the kernel takes one group."""
    impl = resolve_impl(impl, x)
    L = x.shape[1]
    if impl in ("kernel", "plain") and Bm.shape[2] == 1:
        kw = dict(chunk=chunk)
        args = [t.contiguous() for t in (x, dt, A, Bm, Cm)]
        if impl == "plain":
            return _ssd.ssd_chunked_plain(*args, **kw)
        y, state = _ssd.ssd_chunked(*args, **kw)
        if _check is not None and x.device.type == "cuda":
            py, pst = _ssd.ssd_chunked_plain(*args, **kw)
            xa, da, Aa, Ba, Ca = args
            my, _ = _ssd.ssd_chunked_plain(xa.abs(), da, Aa, Ba.abs(), Ca.abs(), **kw)
            _check("ssd_chunked", _ssd.bf16_agreement(y, state, py, pst, my))
        return y, state
    if impl == "naive":
        return _ref.ssd_reference(x, dt, A, Bm, Cm)
    ch = min(chunk, L)
    while L % ch:
        ch //= 2
    return _ref.ssd_chunked_reference(x, dt, A, Bm, Cm, chunk=max(ch, 1))


def ssd_decode(x_t, dt_t, A, B_t, C_t, state):
    return _ref.ssd_decode_reference(x_t, dt_t, A, B_t, C_t, state)
