"""Single-token decode attention over a KV cache: the hand-written sm_90a
kernels, their plain PyTorch version, and the wrapper that picks between
them by device.

Source note.
  Replaces  the Pallas TPU kernel ``repro/kernels/flash_decode.py::
            flash_decode`` (body ``_decode_body``).
  Kernel    ``csrc/flash_decode.cu``, CUDA C++ for ``sm_90a``, built by
            ``_build.py`` with ``nvcc`` and bound with ``ctypes``.  Split-K
            (flash-decoding): a grid of (splits, Hkv, B) CTAs; each reads
            ``valid_len[b]`` on the device and walks its share of the live
            64-key tiles, the ``rep`` query heads of its KV head sharing
            every tile (the TPU kernel's GQA packing).  Two bodies, routed
            by dtype and head_dim alone (:func:`decode_body`):
            ``wgmma`` (bf16, head_dim 17-128 and a multiple of 8): one
            launch a call.  A producer warp keeps a 96 KB ring of K/V tiles
            in flight with TMA; one consumer warpgroup computes S^T = K q^T
            and O^T += V^T P on tensor cores (wgmma m64n8k16, the query
            heads as N, P carried as two bf16 terms); the last split CTA of
            each (b, KV head) to finish merges the splits, in split order,
            through fp32 scratch and a counter this wrapper keeps per
            (device, stream).  TMA zero-fills the columns past D, so 96 and
            120 run with no copy.
            ``simt`` (fp32, and bf16 at other head dims or when asked):
            ``decode_split`` double-buffers the tiles with ``cp.async`` and
            computes in IEEE fp32 FFMA, ``decode_combine`` (a second launch)
            merges the splits; instances at ``HEAD_DIMS``, other head dims
            zero-padded (:func:`pad_head_dim`, a copy of the cache).
  Bound     bytes.  One call reads the live K/V rows once: 2 x valid_len x
            D x 2 bytes per (b, KV head), against 4 x rep x valid_len x D
            operations: one operation per byte, far below the H100's
            ~295 operations per byte of bf16 tensor-core balance.  The
            ring keeps up to 192 KB of K/V requested on each SM, the tensor
            cores take the products off the path of the tiles, and the
            in-launch merge saves a launch.  On the card's own time, L2
            flushed (``chip_smoke.py``, NVIDIA H100 80GB HBM3, 700.00 W;
            PERF.md): the served Jamba shape (valid_len 1908, 8 splits)
            0.0219 ms against simt's 0.0316, SDPA's 0.0423 and a 0.0094
            bound; the seamless cross cache (4 splits) 0.0184 ms against
            simt's 0.0208, SDPA's 0.0183 and a 0.0073 bound.  What is left
            besides the stream from DRAM: the first tile's latency, and the
            merge's tail (partials, fence, atomic, one load round trip) on
            the path of the last CTA.
  Partial   ``partial=True``: both bodies also return each query row's
            merged statistics M and l (fp32, (B, Hq)) and the output in
            fp32, so that a decode over a cache whose length is sharded
            over ranks merges the ranks' results (:func:`merge_partials`,
            ``distributed.spmd.merge_over``) from no bf16 rounding.  A
            shard with no live key gives o = 0, M = -1e30, l = 0.
  Later     fp8 K/V; a persistent grid; a cluster merge; CUDA graphs over
            the host-bound decode step.

``flash_decode`` takes a kernel body for CUDA tensors and the plain version
for CPU tensors; a CUDA tensor never falls back to the plain version.
``flash_decode.launches`` counts calls that launched a body,
``flash_decode.launches_by_body`` splits them by body.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.flash_attention import NEG_INF, _apply_softcap
from repro_torch.kernels.guard import refuse_autograd, refuse_dtensor

HEAD_DIMS = (16, 64, 128)  # head dims the simt body is compiled for
MAX_REP = 8                # query heads per KV head the kernels take
TILE_K = 64                # keys per tile of the kernels' walk
MAX_SPLITS = 1024          # splits the merges take
BODIES = ("wgmma", "simt")
# The split rule's view of the wgmma body (csrc/flash_decode.cu): two CTAs
# of 101 KB of shared memory fit an SM, and the 96 KB ring holds 3 tiles at
# head_dim 128 (6 at 64).  chip_smoke.py checks CTAS_PER_SM against the
# card's occupancy calculator.
CTAS_PER_SM = 2
RING_DEPTH = 3

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
# Partial mode's statistics, kernel vs plain version: M (the row's maximum
# score) within 1e-4 of max(1, |M|), l (the sum of e^(s - M)) within 1e-4 of
# itself.  Both sides sum the same fp32 products of bf16 inputs in another
# order: a score moves by a few fp32 ulps of the row's largest terms, and l
# by as much relative, far under 1e-4.
STAT_REL = 1e-4


def decode_splits(B: int, Hkv: int, L: int, n_sm: int) -> int:
    """The kernels' split count for a (B, Hkv, L) cache on a card of
    ``n_sm`` SMs: as many splits as fit B x Hkv x splits CTAs into one wave
    of the card's CTA slots (``n_sm`` x ``CTAS_PER_SM``), but no more than
    give each split ``RING_DEPTH`` tiles of the cache, and at least one.  A
    pure function of host-known shapes, so the host never reads
    ``valid_len``."""
    fill = (n_sm * CTAS_PER_SM) // (B * Hkv)
    deep = -(-L // TILE_K) // RING_DEPTH
    return max(1, min(fill, deep))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_splits(q: torch.Tensor, k_cache: torch.Tensor) -> int:
    """The split count the kernel takes for these CUDA tensors."""
    B, Hkv, L = k_cache.shape[:3]
    return decode_splits(B, Hkv, L, _sm_count(q.device.index or 0))


def decode_body(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel body a call takes: fixed by dtype and head_dim alone.
    bf16 at head_dim 17-128 takes ``wgmma`` where TMA can describe the rows
    (D x 2 bytes a multiple of 16: every registry head dim); fp32, and bf16
    at the rest, take ``simt``."""
    if dtype == torch.bfloat16 and 16 < head_dim <= 128 and head_dim % 8 == 0:
        return "wgmma"
    if dtype in (torch.float32, torch.bfloat16):
        return "simt"
    raise TypeError(f"no flash_decode body for dtype {dtype}")


def _resolve_body(body: Optional[str], dtype: torch.dtype, head_dim: int) -> str:
    """``body`` if it can take the call (None: :func:`decode_body`'s
    choice); ``simt`` takes every bf16 call too, for A/B timing."""
    routed = decode_body(dtype, head_dim)
    if body is None:
        return routed
    if body not in BODIES:
        raise ValueError(f"body={body!r}; expected None or one of {BODIES}")
    if body == "wgmma" and routed != "wgmma":
        raise ValueError(f"body='wgmma' cannot take a {dtype} call at head_dim "
                         f"{head_dim}; it routes to {routed!r}")
    return body


def kernel_head_dim(head_dim: int) -> int:
    """The head_dim the simt body runs a call at: the smallest compiled one
    that holds it."""
    for d in HEAD_DIMS:
        if head_dim <= d:
            return d
    raise ValueError(f"head_dim {head_dim} unsupported by the flash_decode kernel "
                     f"(at most {HEAD_DIMS[-1]})")


def pad_head_dim(q, k_cache, v_cache, scale: Optional[float]):
    """``(q, k_cache, v_cache, scale)`` at :func:`kernel_head_dim`: the head
    dim zero-padded (a copy of the cache), the scale 1/sqrt(D) of the
    original D unless given.  The simt body's way to other head dims; zero
    columns add nothing to q K^T and give zero output columns."""
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
    partial: bool = False,
):
    """The plain PyTorch version: the kernel's walk, every sequence and
    every split at once.  Each of ``splits`` splits walks its share of a
    sequence's live tiles of ``TILE_K`` keys (ceil(live / splits)
    consecutive tiles, as the kernel does) with the online softmax of
    ``_decode_body``; the splits are then combined in split order, M = max
    m_s, out = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s.
    One split is the TPU kernel's walk; its block size does not change the
    function, since a block past ``valid_len`` adds exactly nothing.  A
    ``valid_len`` past L counts as L, as in ``decode_reference`` (the TPU
    kernel would attend its zero pad).  With ``partial``: ``(out, M, l)``,
    the output in fp32 and each query row's merged statistics (B, Hq), as
    the kernels' partial mode writes them (:func:`merge_partials` merges
    such triples); a sequence with no live key gives out = 0, M = -1e30,
    l = 0."""
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
    # every split's walk at once, the splits as dim 1: split sp of row b
    # walks tiles [lo, hi) of that row
    lo = torch.arange(splits, device=dev)[None, :] * per[:, None]   # (B, S)
    hi = torch.minimum(live[:, None], lo + per[:, None])
    qf = q.reshape(B, 1, Hkv, rep, D).float()
    rows = torch.arange(B, device=dev)[:, None, None]
    acc = torch.zeros((B, splits, Hkv, rep, D), dtype=torch.float32, device=dev)
    m = torch.full((B, splits, Hkv, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, splits, Hkv, rep), dtype=torch.float32, device=dev)
    for j in range(int(per.max())):
        t = lo + j                                               # (B, S) tile of each split
        kpos = t.clamp(max=nk - 1)[..., None] * bk + torch.arange(bk, device=dev)
        kj = k_cache[rows, :, kpos].permute(0, 1, 3, 2, 4).float()   # (B, S, Hkv, bk, D)
        vj = v_cache[rows, :, kpos].permute(0, 1, 3, 2, 4).float()
        s = (qf @ kj.transpose(-1, -2)) * scale_                 # (B, S, Hkv, rep, bk)
        s = _apply_softcap(s, softcap)
        ok = kpos < valid[:, None, None]                         # (B, S, bk)
        s = torch.where(ok[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        run = (t < hi)[..., None, None]                          # (B, S, 1, 1)
        acc = torch.where(run[..., None], acc * alpha[..., None] + p @ vj, acc)
        l = torch.where(run, l * alpha + p.sum(dim=-1), l)
        m = torch.where(run, m_new, m)
    # the merge, in split order
    M = m.amax(dim=1)
    num = torch.zeros_like(acc[:, 0])
    den = torch.zeros_like(l[:, 0])
    for sp in range(splits):
        w = torch.exp(m[:, sp] - M)
        num = num + w[..., None] * acc[:, sp]
        den = den + w * l[:, sp]
    out = num / torch.clamp_min(den, 1e-30)[..., None]
    if partial:
        return out.reshape(B, Hq, D), M.reshape(B, Hq), den.reshape(B, Hq)
    return out.to(q.dtype).reshape(B, Hq, D)


def merge_partials(o: torch.Tensor, M: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """One output from R partial decodes over disjoint shards of a cache,
    stacked in shard order: ``o`` (R, B, Hq, D), ``M`` and ``l`` (R, B, Hq),
    fp32, as the partial mode returns them.  out = sum_r w_r o_r / sum_r w_r
    with w_r = e^(M_r - M*) l_r and M* = max_r M_r, the split merge across
    shards.  A shard with no live key (l = 0) weighs exactly 0; with no
    live key anywhere the output is 0.  Its input is R x B x Hq x (D + 2)
    floats, so no kernel: every rank reduces the same stacked tensor and
    holds the same result."""
    w = torch.exp(M - M.amax(dim=0)) * l                          # (R, B, Hq)
    num = (w[..., None] * o).sum(dim=0)
    return num / torch.clamp_min(w.sum(dim=0), 1e-30)[..., None]


def bf16_agreement(out: torch.Tensor, plain: torch.Tensor,
                   magnitude: torch.Tensor) -> dict:
    """How far a bf16 output lies from the plain version's, in the terms of
    the bounds above.  ``magnitude`` is the plain version on ``|v|``."""
    return _fa.bf16_agreement(out, plain, magnitude, atol=BF16_ATOL, rtol=BF16_RTOL)


def bf16_agrees(stats: dict) -> bool:
    """Within the bf16 bounds; a partial-mode reading
    (:func:`partial_agreement`) also holds its statistics to
    ``STAT_REL``."""
    ok = _fa.bf16_agrees(stats, rel_rms=BF16_REL_RMS, row_rel_rms=BF16_ROW_REL_RMS)
    if "stat_m_err" in stats:
        ok = ok and stats["stat_m_err"] <= STAT_REL and stats["stat_l_rel"] <= STAT_REL
    return ok


def partial_agreement(out: tuple, plain: tuple, magnitude: torch.Tensor) -> dict:
    """A partial-mode call ``(o, M, l)`` against the plain version's:
    :func:`bf16_agreement` of the outputs, and the statistics' worst
    errors, M's relative to max(1, |M|) and l's relative to l, over the
    rows with a live key (the others must read M = -1e30, l = 0 on both
    sides)."""
    (o, M, l), (po, pM, pl) = out, plain
    st = bf16_agreement(o, po, magnitude)
    live = pl > 0
    empty_ok = bool((M[~live] == NEG_INF).all() and (l[~live] == 0).all())
    dm = ((M - pM).abs() / pM.abs().clamp_min(1.0))[live]
    dl = ((l - pl).abs() / pl.clamp_min(1e-30))[live]
    st.update(stat_m_err=float(dm.max()) if dm.numel() else 0.0,
              stat_l_rel=float(dl.max()) if dl.numel() else 0.0,
              finite=st["finite"] and bool(torch.isfinite(M).all() and torch.isfinite(l).all())
              and empty_ok)
    return st


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
def _kernel(body: str):
    """The library's C entry point of ``body``, built at first use and typed
    once."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_decode.cu")
    if body == "simt":
        fn = lib.avo_flash_decode
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    else:
        fn = lib.avo_flash_decode_wgmma
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def wgmma_ctas_per_sm(head_dim: int) -> int:
    """How many wgmma CTAs fit an SM of the current card at ``head_dim``,
    from the CUDA occupancy calculator (the split rule assumes
    ``CTAS_PER_SM``)."""
    from repro_torch.kernels import _build
    fn = _build.load("flash_decode.cu").avo_flash_decode_wgmma_ctas_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(head_dim, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"flash_decode occupancy query failed: CUDA error {err}")
    return n.value


# The wgmma body's split counters: one int32 per (sequence, KV head) for
# every (device, stream), zeroed once when allocated; the last split CTA of
# each call resets its counter to 0, so a buffer is ready for the next call
# on its stream, and a CUDA graph that replays the call finds it so too.
# Two streams never share one.
_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _launch(q, k_cache, v_cache, valid_len, *, softcap, scale, splits, body,
            partial=False):
    if valid_len.dtype != torch.int32:
        raise TypeError(f"valid_len must be int32, got {valid_len.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("valid_len", valid_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    D0 = q.shape[-1]
    body = _resolve_body(body, q.dtype, D0)
    if body == "simt":
        q, k_cache, v_cache, scale = pad_head_dim(q, k_cache, v_cache, scale)
    scale = scale if scale is not None else 1.0 / (D0 ** 0.5)
    B, Hq, D = q.shape
    _, Hkv, L, _ = k_cache.shape
    rep = Hq // Hkv
    if rep > MAX_REP:
        raise ValueError(f"{rep} query heads per KV head; the flash_decode "
                         f"kernel takes at most {MAX_REP}")
    splits = kernel_splits(q, k_cache) if splits is None else int(splits)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must lie in [1, {MAX_SPLITS}], got {splits}")
    # partial mode: the output in fp32, and M, l of every query row
    o = torch.empty_like(q, dtype=torch.float32 if partial else q.dtype)
    stats = torch.empty((2, B, Hq), dtype=torch.float32, device=q.device) if partial else None
    stat_m, stat_l = (stats[0].data_ptr(), stats[1].data_ptr()) if partial else (0, 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the splits' partial m, l (B, Hkv, splits, rep) and acc (..., D), fp32:
    # simt's m, l, acc; wgmma's acc first (its merge loads it 16 bytes at a
    # time), none with one split
    n = B * Hkv * splits * rep
    m = l = acc = 0
    if body == "simt" or splits > 1:
        scratch = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
        part = scratch.data_ptr()
        m, l, acc = ((part, part + 4 * n, part + 8 * n) if body == "simt" else
                     (part + 4 * n * D, part + 4 * n * (D + 1), part))
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_len.data_ptr(),
            m, l, acc)
    tail = (B, Hkv, rep, L, D, splits, float(softcap or 0.0), float(scale), stream)
    if body == "simt":
        err = _kernel(body)(*ptrs, o.data_ptr(), stat_m, stat_l,
                            int(q.dtype == torch.bfloat16), *tail)
    else:
        counters = _counters(q.device, stream, B * Hkv)
        err = _kernel(body)(*ptrs, counters.data_ptr(), o.data_ptr(), stat_m, stat_l, *tail)
    if err != 0:
        raise RuntimeError(f"flash_decode {body} launch failed (q {tuple(q.shape)}, cache "
                           f"{tuple(k_cache.shape)}, {splits} splits): CUDA error {err}")
    flash_decode.launches += 1
    flash_decode.launches_by_body[body] += 1
    o = o if D == D0 else o[..., :D0].contiguous()
    return (o, stats[0], stats[1]) if partial else o


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
    body: Optional[str] = None,
    partial: bool = False,
):
    """One query token per sequence against its cache.  CUDA tensors launch
    a kernel body (``body`` None: :func:`decode_body`'s choice; "simt"
    forces the simt body on a bf16 call, for A/B timing; a body that cannot
    take the call raises) with ``splits`` splits (None:
    :func:`kernel_splits`); CPU tensors take :func:`flash_decode_plain`
    (None: one split).  ``impl="kernel"`` demands a kernel and raises on CPU
    tensors.  With ``partial`` it returns ``(out, M, l)``: the output in
    fp32 and each query row's merged statistics (B, Hq) in fp32, for a
    merge across shards of the cache (:func:`merge_partials`)."""
    refuse_dtensor("flash_decode", q, k_cache, v_cache, valid_len)
    _check_inputs(q, k_cache, v_cache, valid_len)
    if impl not in (None, "kernel"):
        raise ValueError(f"impl={impl!r}; expected None or 'kernel'")
    _resolve_body(body, q.dtype, q.shape[-1])
    if q.device.type == "cuda":
        refuse_autograd("flash_decode", q, k_cache, v_cache)
        return _launch(q, k_cache, v_cache, valid_len, softcap=softcap, scale=scale,
                       splits=splits, body=body, partial=partial)
    if impl == "kernel":
        raise ValueError(f"the flash_decode kernel runs on CUDA tensors; "
                         f"got tensors on {q.device}")
    return flash_decode_plain(q, k_cache, v_cache, valid_len, softcap=softcap,
                              scale=scale, splits=splits or 1, partial=partial)


flash_decode.launches = 0
flash_decode.launches_by_body = dict.fromkeys(BODIES, 0)
