"""Single-token decode attention over a KV cache: the hand-written sm_90a
kernels, their plain PyTorch version, and the wrapper that picks between
them by device.

Source note.
  Replaces  the Pallas TPU kernel ``repro/kernels/flash_decode.py::
            flash_decode`` (body ``_decode_body``).
  Kernel    ``csrc/flash_decode.cu``, CUDA C++ for ``sm_90a``, built by
            ``_build.py`` with ``nvcc`` and bound with ``ctypes``.  Split-K
            (flash-decoding): ``decode_split`` runs a grid of (splits, Hkv,
            B) CTAs; each reads ``valid_len[b]`` on the device and walks its
            share of the live 64-key tiles, double-buffered with
            ``cp.async``, the ``rep`` query heads of its KV head being the
            rows of each (rep x D) . (D x 64) product (the TPU kernel's GQA
            packing).  It writes partial (m, l, acc) to fp32 scratch that
            this wrapper allocates; ``decode_combine`` merges the splits per
            (sequence, query head) and writes the output.  fp32 and bf16
            inputs; products, statistics and accumulator in IEEE fp32.
  Bound     bytes.  One call reads the live K/V rows once: 2 x valid_len x
            D x 2 bytes per (b, KV head), against 4 x rep x valid_len x D
            operations: one operation per byte, far below the H100's
            ~295 operations per byte of bf16 tensor-core balance.  One CTA
            per (b, KV head) left 100 of 132 SMs idle at the served Jamba
            shape; ``decode_splits`` picks enough splits to fill every SM:
            5 there, 39-43 us with the L2 cold against a 9.4 us bound
            (NVIDIA H100 80GB HBM3 at 700.00 W, ``chip_smoke.py``; PERF.md).
  Later     TMA loads; CUDA graphs over the host-bound decode step.

Head dims.  The kernels are compiled for ``HEAD_DIMS`` = 16, 64 and 128.
A call at another head_dim D <= 128 (phi-3-vision-4.2b's 96,
h2o-danube-3-4b's 120) runs at :func:`kernel_head_dim` (D), the next
compiled one: :func:`pad_head_dim` zero-pads q and the caches, the scale
stays 1/sqrt(D), and the output is sliced back to D.  Zero columns add
nothing to q K^T and give zero output columns, so this is the same
function.  Padding copies the cache, at every decode step.  Past 128 the
kernel raises.

``flash_decode`` takes the kernels for CUDA tensors and the plain version
for CPU tensors; a CUDA tensor never falls back to the plain version.
``flash_decode.launches`` counts calls that launched the kernels (each
launches ``decode_split`` and ``decode_combine`` once).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.flash_attention import NEG_INF, _apply_softcap

HEAD_DIMS = (16, 64, 128)  # head dims the kernel is compiled for
MAX_REP = 8                # query heads per KV head the kernel takes
TILE_K = 64                # keys per tile of the kernel's walk
MAX_SPLITS = 1024          # splits the combine kernel takes

# bf16 inputs, kernel vs plain version.  Both compute in fp32 from the same
# bf16 inputs and round the output to bf16 once, so an element differs by at
# most one bf16 ulp of the output (2**-7 of it) plus the fp32 summation-order
# error.  The element bound scales the sum of the terms' magnitudes,
# sum(p |v|) / l (the plain version run on |v|), which bounds |out|.  A row
# is 128 outputs of like magnitude, whose roundings flip independently: at
# the served Jamba shape the kernel's worst row reads 6.3e-4 (H100), and the
# row bound sits 6x above that.  The whole-output bound catches what stays
# under them: a key dropped from every row moves the whole output by about
# p x |v - o|, and reads 2.6e-2 there.  tests/test_torch_bf16_bound.py holds
# both sides on the CPU, chip_smoke.py on the card.
BF16_ATOL, BF16_RTOL = 1e-5, 1e-2     # every element, against its magnitude
BF16_REL_RMS = 4e-4                   # the whole output
BF16_ROW_REL_RMS = 4e-3               # every row of head_dim values


def decode_splits(B: int, Hkv: int, L: int, n_sm: int) -> int:
    """The kernel's split count for a (B, Hkv, L) cache on a card of
    ``n_sm`` SMs: the smallest that puts a CTA on every SM, at most one
    split per tile of the cache.  A pure function of host-known shapes, so
    the host never reads ``valid_len``."""
    fill = -(-n_sm // (B * Hkv))
    return max(1, min(fill, -(-L // TILE_K)))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_splits(q: torch.Tensor, k_cache: torch.Tensor) -> int:
    """The split count the kernel takes for these CUDA tensors."""
    B, Hkv, L = k_cache.shape[:3]
    return decode_splits(B, Hkv, L, _sm_count(q.device.index or 0))


def kernel_head_dim(head_dim: int) -> int:
    """The head_dim the kernel runs a call at: the smallest compiled one
    that holds it."""
    for d in HEAD_DIMS:
        if head_dim <= d:
            return d
    raise ValueError(f"head_dim {head_dim} unsupported by the flash_decode kernel "
                     f"(at most {HEAD_DIMS[-1]})")


def pad_head_dim(q, k_cache, v_cache, scale: Optional[float]):
    """``(q, k_cache, v_cache, scale)`` at :func:`kernel_head_dim`: the head
    dim zero-padded, the scale 1/sqrt(D) of the original D unless given."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    pad = kernel_head_dim(D) - D
    if pad:
        q, k_cache, v_cache = (torch.nn.functional.pad(t, (0, pad))
                               for t in (q, k_cache, v_cache))
    return q, k_cache, v_cache, scale


def flash_decode_plain(
    q: torch.Tensor,               # (B, Hq, D)
    k_cache: torch.Tensor,         # (B, Hkv, L, D)
    v_cache: torch.Tensor,         # (B, Hkv, L, D)
    valid_len: torch.Tensor,       # (B,) int32
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    splits: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version: the kernel's walk, every sequence at once.
    Each of ``splits`` splits walks its share of a sequence's live tiles of
    ``TILE_K`` keys (ceil(live / splits) consecutive tiles, as the kernel
    does) with the online softmax of ``_decode_body``; the splits are then
    combined, M = max m_s, out = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s.
    One split is the TPU kernel's walk; its block size does not change the
    function, since a block past ``valid_len`` adds exactly nothing.  A
    ``valid_len`` past L counts as L, as in ``decode_reference`` (the TPU
    kernel would attend its zero pad)."""
    if splits < 1:
        raise ValueError(f"splits must be positive, got {splits}")
    B, Hq, D = q.shape
    _, Hkv, L, _ = k_cache.shape
    rep = Hq // Hkv
    scale_ = scale if scale is not None else 1.0 / (D ** 0.5)
    bk = min(TILE_K, L)
    pad = (-L) % bk
    if pad:
        k_cache = torch.nn.functional.pad(k_cache, (0, 0, 0, pad))
        v_cache = torch.nn.functional.pad(v_cache, (0, 0, 0, pad))
    nk = (L + pad) // bk
    dev = q.device
    valid = valid_len.to(device=dev, dtype=torch.int64).clamp(max=L)
    live = -(-valid // bk)                                       # (B,) live tiles
    per = -(-live // splits)                                     # tiles per split
    qf = q.reshape(B, Hkv, rep, D).float()
    rows = torch.arange(B, device=dev)[:, None]
    parts = []
    for sp in range(splits):
        lo = sp * per
        hi = torch.minimum(live, lo + per)
        acc = torch.zeros((B, Hkv, rep, D), dtype=torch.float32, device=dev)
        m = torch.full((B, Hkv, rep), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, rep), dtype=torch.float32, device=dev)
        for j in range(int(per.max())):
            t = lo + j                                           # (B,) tile of each row
            kpos = t.clamp(max=nk - 1)[:, None] * bk + torch.arange(bk, device=dev)
            kj = k_cache[rows, :, kpos].transpose(1, 2).float()  # (B, Hkv, bk, D)
            vj = v_cache[rows, :, kpos].transpose(1, 2).float()
            s = (qf @ kj.transpose(-1, -2)) * scale_             # (B, Hkv, rep, bk)
            s = _apply_softcap(s, softcap)
            ok = kpos < valid[:, None]                           # (B, bk)
            s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            run = (t < hi)[:, None, None]                        # (B, 1, 1)
            acc = torch.where(run[..., None], acc * alpha[..., None] + p @ vj, acc)
            l = torch.where(run, l * alpha + p.sum(dim=-1), l)
            m = torch.where(run, m_new, m)
        parts.append((m, l, acc))
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        num = num + w[..., None] * acc
        den = den + w * l
    out = num / torch.clamp_min(den, 1e-30)[..., None]
    return out.to(q.dtype).reshape(B, Hq, D)


def bf16_agreement(out: torch.Tensor, plain: torch.Tensor,
                   magnitude: torch.Tensor) -> dict:
    """How far a bf16 output lies from the plain version's, in the terms of
    the bounds above.  ``magnitude`` is the plain version on ``|v|``."""
    return _fa.bf16_agreement(out, plain, magnitude, atol=BF16_ATOL, rtol=BF16_RTOL)


def bf16_agrees(stats: dict) -> bool:
    return _fa.bf16_agrees(stats, rel_rms=BF16_REL_RMS, row_rel_rms=BF16_ROW_REL_RMS)


def _check_inputs(q, k_cache, v_cache, valid_len):
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("q must be (B, Hq, D) and the caches (B, Hkv, L, D)")
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} and v_cache "
                         f"{tuple(v_cache.shape)} differ")
    B, Hq, D = q.shape
    if (k_cache.shape[0] != B or k_cache.shape[3] != D
            or Hq % k_cache.shape[1] != 0):
        raise ValueError(f"q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k_cache.shape)}")
    if valid_len.shape != (B,):
        raise ValueError(f"valid_len must be ({B},), got {tuple(valid_len.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"q and the caches must share dtype float32 or "
                        f"bfloat16, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device == valid_len.device):
        raise ValueError("q, the caches and valid_len must lie on one device")


@functools.cache
def _kernel():
    """The library's C entry point, built at first use and typed once."""
    from repro_torch.kernels import _build
    fn = _build.load("flash_decode.cu").avo_flash_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return fn


def _launch(q, k_cache, v_cache, valid_len, *, softcap, scale, splits):
    D0 = q.shape[-1]
    q, k_cache, v_cache, scale = pad_head_dim(q, k_cache, v_cache, scale)
    B, Hq, D = q.shape
    _, Hkv, L, _ = k_cache.shape
    rep = Hq // Hkv
    if rep > MAX_REP:
        raise ValueError(f"{rep} query heads per KV head; the flash_decode "
                         f"kernel takes at most {MAX_REP}")
    if valid_len.dtype != torch.int32:
        raise TypeError(f"valid_len must be int32, got {valid_len.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("valid_len", valid_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    splits = kernel_splits(q, k_cache) if splits is None else int(splits)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must lie in [1, {MAX_SPLITS}], got {splits}")
    o = torch.empty_like(q)
    # the splits' partial m, l (B, Hkv, splits, rep) and acc (..., D), fp32
    n = B * Hkv * splits * rep
    scratch = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    part = scratch.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    valid_len.data_ptr(), part, part + 4 * n, part + 8 * n, o.data_ptr(),
                    int(q.dtype == torch.bfloat16), B, Hkv, rep, L, D, splits,
                    float(softcap or 0.0), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    flash_decode.launches += 1
    return o if D == D0 else o[..., :D0].contiguous()


def flash_decode(
    q: torch.Tensor,               # (B, Hq, D)
    k_cache: torch.Tensor,         # (B, Hkv, L, D)
    v_cache: torch.Tensor,         # (B, Hkv, L, D)
    valid_len: torch.Tensor,       # (B,) int32
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    splits: Optional[int] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """One query token per sequence against its cache.  CUDA tensors launch
    the sm_90a kernels with ``splits`` splits (None: :func:`kernel_splits`);
    CPU tensors take :func:`flash_decode_plain` (None: one split).
    ``impl="kernel"`` demands the kernels and raises on CPU tensors."""
    _check_inputs(q, k_cache, v_cache, valid_len)
    if impl not in (None, "kernel"):
        raise ValueError(f"impl={impl!r}; expected None or 'kernel'")
    if q.device.type == "cuda":
        return _launch(q, k_cache, v_cache, valid_len, softcap=softcap, scale=scale,
                       splits=splits)
    if impl == "kernel":
        raise ValueError(f"the flash_decode kernel runs on CUDA tensors; "
                         f"got tensors on {q.device}")
    return flash_decode_plain(q, k_cache, v_cache, valid_len, softcap=softcap,
                              scale=scale, splits=splits or 1)


flash_decode.launches = 0
