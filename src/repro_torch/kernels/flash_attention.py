"""Genome-parameterized flash attention: the hand-written sm_90a kernel, its
plain PyTorch version, and the wrapper that picks between them by device.

Source note.
  Replaces  the Pallas TPU kernel ``repro/kernels/flash_attention.py::
            flash_attention`` (bodies ``_fa_body_grid`` for kv_in_grid=True and
            ``_fa_body_loop`` for kv_in_grid=False).
  Kernel    ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``, built by
            ``_build.py`` with ``nvcc`` and bound with ``ctypes``.  Three
            bodies, routed by dtype and head_dim alone (``attention_body``):
            ``wgmma`` for bf16 at head_dim 64 or 128 (the measured rung and
            the served prefill): a warp-specialised CTA of 128 query rows,
            one producer warp issuing TMA loads of 128-key K/V chunks, two
            consumer warpgroups running ``wgmma`` with fp32 accumulators;
            ``mma_sync`` for bf16 at other head dims: ``mma.sync`` m16n8k16
            on a 64 x 64 tile with ``cp.async`` staging; ``fp32`` for the
            correctness gate: IEEE fp32 FFMA, never TF32.  The genome's
            block_q / block_k are logical blocks in every body: they set the
            block classification, the block_skip bounds and the
            bf16-accumulator rounding points.  kv_in_grid=True pipelines the
            K/V loads (a 2-stage TMA ring, or cp.async double buffering);
            kv_in_grid=False loads them in a single stage with no overlap.
            The ``.cu`` header says how every genome axis maps.
  Bound     compute.  At every ``mha_suite`` shape the useful FLOPs over the
            H100's 989e12 bf16 FLOP/s exceed the bytes of q, k, v and o over
            its 3.35e12 B/s by two orders of magnitude.  The ``mma_sync``
            body reaches 15-18 % of that peak with the pipelined genome:
            synchronous products, softmax in series with them, loads
            addressed by every thread.  The ``wgmma`` body issues
            asynchronous full-rate products, lets one consumer's softmax
            overlap the other's products, and moves every byte by TMA:
            43-56 % of the peak, 1.18-1.40x cuDNN's time (NVIDIA H100 80GB
            HBM3 at 700.00 W, ``chip_smoke.py``; PERF.md).
  Later     ping-pong of the two consumers, softmax overlapped with the next
            Q K^T, persistent CTAs with causal load balance, fp8.

Head dims.  The kernel runs at a multiple of 16, at most 128.  A launch at
another head_dim D <= 128 (h2o-danube-3-4b's 120) runs at
:func:`kernel_head_dim` (D): :func:`pad_head_dim` zero-pads q, k and v, the
scale stays 1/sqrt(D), and the output is sliced back to D.  Zero columns
add nothing to Q K^T and give zero output columns, so this is the same
function; 120 runs at 128 on the wgmma body.  Past 128 the kernel raises.

``flash_attention`` takes the kernel for CUDA tensors and the plain version
for CPU tensors; a CUDA tensor never falls back to the plain version.
``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_by_body`` splits them by body and
``flash_attention.launches_by_rep`` by the call's query heads per KV head.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 128              # the kernel's widest head_dim
WGMMA_HEAD_DIMS = (64, 128)     # bf16 head dims of the wgmma body
BODIES = ("wgmma", "mma_sync", "fp32")

# bf16 inputs, kernel vs plain version.  Both round an fp32 result to bf16,
# and the kernel also rounds each P term to bf16 for the P V product; each
# rounding errs by at most 2**-8 of its value.  So an output element differs
# by at most 3 * 2**-8 of the sum of its terms' magnitudes, sum(p |v|) / l:
# the plain version run on |v|.  That sum, not the output, scales the element
# bound, since short rows whose terms cancel have small outputs and full-size
# errors.  The RMS bounds catch what stays under it: a bf16 accumulator
# rounded every 64 keys, or keys dropped from the longer rows.
# tests/test_torch_bf16_bound.py holds both sides on the CPU, chip_smoke.py
# on the card.  The three bounds:
BF16_ATOL, BF16_RTOL = 1e-5, 1.6e-2   # every element, against its magnitude
BF16_REL_RMS = 3.5e-3                 # the whole output
BF16_ROW_REL_RMS = 8e-3               # every row of head_dim values


def bf16_agreement(out: torch.Tensor, plain: torch.Tensor,
                   magnitude: torch.Tensor, *, atol: float = BF16_ATOL,
                   rtol: float = BF16_RTOL) -> dict:
    """How far a bf16 output lies from the plain version's, in the terms
    of the bounds above (another kernel passes its own element bound).
    ``magnitude`` is the plain version on ``|v|``; ``tol_ratio`` is the
    largest element's share of its bound."""
    o, p = out.float(), plain.float()
    d = (o - p).abs()
    row = d.norm(dim=-1) / p.norm(dim=-1).clamp_min(1e-30)
    bound = atol + rtol * magnitude.float()
    return {"max_abs_err": float(d.max()),
            "tol_ratio": float((d / bound).max()),
            "rel_rms": float(d.norm() / p.norm().clamp_min(1e-30)),
            "max_row_rel_rms": float(row.max()),
            "finite": bool(torch.isfinite(o).all())}


def bf16_agrees(stats: dict, *, rel_rms: float = BF16_REL_RMS,
                row_rel_rms: float = BF16_ROW_REL_RMS) -> bool:
    return (stats["finite"] and stats["tol_ratio"] <= 1.0
            and stats["rel_rms"] <= rel_rms
            and stats["max_row_rel_rms"] <= row_rel_rms)


def _apply_softcap(s, softcap):
    return softcap * torch.tanh(s / softcap) if softcap else s


def _mask_value(qpos, kpos, *, causal, window, k_limit):
    ok = kpos < k_limit
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return ok


def _block_classify(i, j, *, bq, bk, causal, window, k_limit, seq_mod=None):
    """(fully_masked, fully_unmasked) for K-block j against Q-block i.

    Under GQA packing (seq_mod set) the q rows of a tile wrap around the true
    sequence, so a tile that spans a wrap boundary covers [0, seq_mod) and is
    treated as never fully masked / never fully unmasked."""
    q_lo, q_hi = i * bq, i * bq + bq - 1
    if seq_mod is not None:
        if (q_hi // seq_mod) != (q_lo // seq_mod):
            q_lo, q_hi = 0, seq_mod - 1
        else:
            q_lo, q_hi = q_lo % seq_mod, q_hi % seq_mod
    k_lo, k_hi = j * bk, j * bk + bk - 1
    fully_masked = False
    fully_unmasked = k_hi < k_limit
    if causal:
        fully_masked |= k_lo > q_hi
        fully_unmasked &= k_hi <= q_lo
    if window is not None:
        fully_masked |= k_hi <= q_lo - window
        fully_unmasked &= k_lo > q_hi - window
    return fully_masked, fully_unmasked


def _grid_rows(qi, k, v, i, *, scale, causal, window, softcap, bq, bk, nk,
               k_limit, rescale_mode, mask_mode, div_mode, seq_mod, adt):
    """One q-block of ``_fa_body_grid``: the K-loop of the grid, every
    (batch, head) at once.  The branched rescale is taken per (batch, head),
    as the reference's ``pl.when`` is per grid program."""
    B, H = qi.shape[:2]
    dev = qi.device
    acc = torch.zeros((B, H, bq, qi.shape[-1]), dtype=adt, device=dev)
    m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
    qpos = i * bq + torch.arange(bq, device=dev)[:, None]
    if seq_mod is not None:
        qpos = qpos % seq_mod
    for j in range(nk):
        fully_masked, fully_unmasked = _block_classify(
            i, j, bq=bq, bk=bk, causal=causal, window=window, k_limit=k_limit,
            seq_mod=seq_mod)
        if mask_mode == "block_skip" and fully_masked:
            continue
        kj = k[:, :, j * bk:(j + 1) * bk].float()
        vj = v[:, :, j * bk:(j + 1) * bk].float()
        s = (qi @ kj.transpose(-1, -2)) * scale
        s = _apply_softcap(s, softcap)
        kpos = j * bk + torch.arange(bk, device=dev)[None, :]
        ok = _mask_value(qpos, kpos, causal=causal, window=window, k_limit=k_limit)
        if not (mask_mode == "block_skip" and fully_unmasked):
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_blk = p.sum(dim=-1)
        pv = p @ vj
        l_new = l * alpha + l_blk
        if div_mode == "deferred":
            if rescale_mode == "branchless":
                acc = (acc.float() * alpha[..., None] + pv).to(adt)
            else:
                run = (alpha < 1.0).any(dim=-1)[..., None, None]
                acc = torch.where(run, (acc.float() * alpha[..., None]).to(adt), acc)
                acc = (acc.float() + pv).to(adt)
        else:  # eager (FA1-style): accumulator kept normalized each step
            l_safe = torch.clamp_min(l_new, 1e-30)
            scale_prev = l * alpha / l_safe
            if rescale_mode == "branchless":
                acc = (acc.float() * scale_prev[..., None]
                       + pv / l_safe[..., None]).to(adt)
            else:
                run = ((scale_prev < 1.0).any(dim=-1)
                       | (scale_prev > 1.0).any(dim=-1))[..., None, None]
                acc = torch.where(
                    run, (acc.float() * scale_prev[..., None]).to(adt), acc)
                acc = (acc.float() + pv / l_safe[..., None]).to(adt)
        m, l = m_new, l_new
    acc = acc.float()
    if div_mode == "deferred":
        acc = acc / torch.clamp_min(l, 1e-30)[..., None]
    return acc


def _loop_rows(qi, k, v, i, *, scale, causal, window, softcap, bq, bk, nk,
               k_limit, mask_mode, seq_mod, adt):
    """One q-block of ``_fa_body_loop``.

    K/V staged in full; an in-kernel loop over K-blocks that always masks,
    always rescales without a branch and always divides at the end, whatever
    the genome's div/rescale modes say.  With mask_mode="block_skip" the loop
    bounds themselves shrink for causal/windowed masks (not under packing)."""
    B, H = qi.shape[:2]
    dev = qi.device
    qpos = i * bq + torch.arange(bq, device=dev)[:, None]
    if seq_mod is not None:
        qpos = qpos % seq_mod
    lo, hi = 0, nk
    if mask_mode == "block_skip" and (causal or window is not None) and seq_mod is None:
        if causal:
            hi = min(hi, (i * bq + bq + bk - 1) // bk)
        if window is not None:
            lo = max(0, (i * bq - window + 1) // bk)
    acc = torch.zeros((B, H, bq, qi.shape[-1]), dtype=adt, device=dev)
    m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
    for j in range(lo, hi):
        kj = k[:, :, j * bk:(j + 1) * bk].float()
        vj = v[:, :, j * bk:(j + 1) * bk].float()
        s = (qi @ kj.transpose(-1, -2)) * scale
        s = _apply_softcap(s, softcap)
        kpos = j * bk + torch.arange(bk, device=dev)[None, :]
        ok = _mask_value(qpos, kpos, causal=causal, window=window, k_limit=k_limit)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        pv = p @ vj
        acc = (acc.float() * alpha[..., None] + pv).to(adt)
        l = l * alpha + p.sum(dim=-1)
        m = m_new
    return acc.float() / torch.clamp_min(l, 1e-30)[..., None]


def _pack(q, k, gqa_pack):
    """The reference's GQA packing: rep q-heads that share a KV head become
    one long q axis, masks use the position modulo the true length."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    if gqa_pack and rep > 1:
        return q.reshape(B, Hkv, rep * Sq, D), 1, Sq
    return q, rep, None


def _unpack(o, seq_mod):
    if seq_mod is None:
        return o
    B, H, S, D = o.shape
    return o.reshape(B, H, S // seq_mod, seq_mod, D).reshape(
        B, H * (S // seq_mod), seq_mod, D)


def flash_attention_plain(
    q: torch.Tensor,               # (B, Hq, Sq, D)
    k: torch.Tensor,               # (B, Hkv, Sk, D)
    v: torch.Tensor,               # (B, Hkv, Sk, D)
    *,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    rescale_mode: str = "branchless",
    mask_mode: str = "block_skip",
    div_mode: str = "deferred",
    kv_in_grid: bool = True,
    gqa_pack: bool = False,
    acc_dtype: str = "f32",
) -> torch.Tensor:
    """The plain PyTorch version: a torch-eager walk over the reference's
    (q-block, k-block) loop taking every genome branch, with the same
    padding and the same bf16-accumulator rounding points."""
    B, Hq, Sq0, D = q.shape
    _, Hkv, Sk, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    scale_ = scale if scale is not None else 1.0 / (D ** 0.5)
    q, rep, seq_mod = _pack(q, k, gqa_pack)
    Hq, Sq = q.shape[1], q.shape[2]
    if rep > 1:                     # q head h reads KV head h // rep
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

    bq = min(block_q, Sq)
    bk = min(block_k, Sk)
    pad_q = (-Sq) % bq
    pad_k = (-Sk) % bk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad_k))
    nq = (Sq + pad_q) // bq
    nk = (Sk + pad_k) // bk
    adt = torch.float32 if acc_dtype == "f32" else torch.bfloat16
    kw = dict(scale=scale_, causal=causal, window=window, softcap=softcap,
              bq=bq, bk=bk, nk=nk, k_limit=Sk, mask_mode=mask_mode,
              seq_mod=seq_mod, adt=adt)
    out = torch.empty((B, Hq, Sq + pad_q, D), dtype=q.dtype, device=q.device)
    for i in range(nq):
        qi = q[:, :, i * bq:(i + 1) * bq].float()
        if kv_in_grid:
            rows = _grid_rows(qi, k, v, i, rescale_mode=rescale_mode,
                              div_mode=div_mode, **kw)
        else:
            rows = _loop_rows(qi, k, v, i, **kw)
        out[:, :, i * bq:(i + 1) * bq] = rows.to(q.dtype)
    return _unpack(out[:, :, :Sq], seq_mod)


_MODES = dict(rescale_mode=("branchless", "branched"),
              mask_mode=("dense", "block_skip"),
              div_mode=("deferred", "eager"), acc_dtype=("f32", "bf16"))


def _check_inputs(q, k, v, genome):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B, H, S, D)")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1] != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32,
                                                               torch.bfloat16):
        raise TypeError(f"q, k, v must share dtype float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    for name, choices in _MODES.items():
        if genome[name] not in choices:
            raise ValueError(f"{name}={genome[name]!r}; expected one of {choices}")
    if genome["block_q"] < 1 or genome["block_k"] < 1:
        raise ValueError("block_q and block_k must be positive")


def kernel_head_dim(head_dim: int) -> int:
    """The head_dim the kernel runs a launch at: the next multiple of 16."""
    if not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {head_dim} unsupported by the kernel "
                         f"(at most {MAX_HEAD_DIM})")
    return -(-head_dim // 16) * 16


def pad_head_dim(q, k, v, scale: Optional[float]):
    """``(q, k, v, scale)`` at :func:`kernel_head_dim`: the head dim
    zero-padded, the scale 1/sqrt(D) of the original D unless given."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    pad = kernel_head_dim(D) - D
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    return q, k, v, scale


def attention_body(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel body a launch takes: fixed by dtype and head_dim, never by
    the genome.  fp32 is the correctness gate (IEEE FFMA: TF32 wgmma would
    fail its tolerance); bf16 takes wgmma where its tiles fit the head_dim
    the kernel runs at (:func:`kernel_head_dim`)."""
    if dtype == torch.float32:
        return "fp32"
    if dtype == torch.bfloat16:
        return ("wgmma" if kernel_head_dim(head_dim) in WGMMA_HEAD_DIMS
                else "mma_sync")
    raise TypeError(f"no flash_attention body for dtype {dtype}")


@functools.cache
def _kernel():
    """The library's C entry point, built at first use and typed once."""
    from repro_torch.kernels import _build
    fn = _build.load("flash_attention.cu").avo_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _launch(q, k, v, *, causal, window, softcap, scale, block_q, block_k,
            rescale_mode, mask_mode, div_mode, kv_in_grid, gqa_pack, acc_dtype,
            body=None):
    """``body`` is for A/B timing only: ``"mma_sync"`` forces the mma.sync
    body on a bf16 launch; None takes :func:`attention_body`'s choice."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    D0 = q.shape[-1]
    q, k, v, scale = pad_head_dim(q, k, v, scale)
    B, Hq0, Sq0, D = q.shape
    Sk = k.shape[2]
    routed = attention_body(q.dtype, D)
    if body is None:
        body = routed
    elif body != routed and not (body == "mma_sync" and q.dtype == torch.bfloat16):
        raise ValueError(f"body={body!r} cannot take a {q.dtype} launch at "
                         f"head_dim {D}; it routes to {routed!r}")
    qk, rep, seq_mod = _pack(q, k, gqa_pack)
    Hq, Sq = qk.shape[1], qk.shape[2]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nk = -(-Sk // bk)
    o = torch.empty_like(qk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(qk.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             int(q.dtype == torch.bfloat16), int(acc_dtype == "bf16"),
             int(bool(kv_in_grid)), B, Hq, rep, Sq, Sk, D, seq_mod or 0,
             bq, bk, nk, int(bool(causal)), -1 if window is None else int(window),
             float(softcap or 0.0), float(scale),
             int(rescale_mode == "branched"), int(mask_mode == "block_skip"),
             int(div_mode == "eager"), int(body == "wgmma"), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({body} body): "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_body[body] += 1
    rep_of_call = Hq0 // k.shape[1]
    flash_attention.launches_by_rep[rep_of_call] = \
        flash_attention.launches_by_rep.get(rep_of_call, 0) + 1
    o = _unpack(o, seq_mod)
    return o if D == D0 else o[..., :D0].contiguous()


def flash_attention(
    q: torch.Tensor,               # (B, Hq, Sq, D)
    k: torch.Tensor,               # (B, Hkv, Sk, D)
    v: torch.Tensor,               # (B, Hkv, Sk, D)
    *,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    rescale_mode: str = "branchless",
    mask_mode: str = "block_skip",
    div_mode: str = "deferred",
    kv_in_grid: bool = True,
    gqa_pack: bool = False,
    acc_dtype: str = "f32",
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Forward attention for one genome.  CUDA tensors launch the sm_90a
    kernel; CPU tensors take :func:`flash_attention_plain`.  ``impl="kernel"``
    demands the kernel and raises on CPU tensors."""
    genome = dict(block_q=block_q, block_k=block_k, rescale_mode=rescale_mode,
                  mask_mode=mask_mode, div_mode=div_mode, kv_in_grid=kv_in_grid,
                  gqa_pack=gqa_pack, acc_dtype=acc_dtype)
    _check_inputs(q, k, v, genome)
    if impl not in (None, "kernel"):
        raise ValueError(f"impl={impl!r}; expected None or 'kernel'")
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, window=window, softcap=softcap,
                       scale=scale, **genome)
    if impl == "kernel":
        raise ValueError(f"the flash_attention kernel runs on CUDA tensors; "
                         f"got tensors on {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale, **genome)


flash_attention.launches = 0
flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
flash_attention.launches_by_rep = {}
