"""The Mamba-2 SSD chunked scan: the hand-written sm_90a kernels, their plain
PyTorch versions, and the wrapper that picks between them by device.

Source note.
  Replaces  the Pallas TPU kernel ``repro/kernels/ssd.py::ssd_chunked``
            (body ``_ssd_body``).
  Kernels   ``csrc/ssd.cu``, CUDA C++ for ``sm_90a``, built by ``_build.py``
            with ``nvcc`` and bound with ``ctypes``.  Two bodies, routed by
            dtype (:func:`ssd_body`):
            "chunked"  every bf16 launch: three kernels on the caller's
                       stream, each CTA on one (chunk, head, sequence).
                       ``ssd_chunk_state`` writes the chunk's cum, dt and
                       local state to scratch; ``ssd_state_pass`` turns the
                       local states into the states entering each chunk;
                       ``ssd_chunk_scan`` computes the chunk's y in tiles of
                       SCAN_TILE steps that carry the state R across the
                       chunk.  Every product runs on ``mma.sync`` m16n8k16
                       (x^T (u B), C B^T, w x, C R^T) with its fp32 operand
                       split into SPLIT = 3 bf16 terms that sum to it exactly.
            "serial"   every fp32 launch: one CTA per (sequence, head) walks
                       the chunks in order and carries the fp32 state in
                       shared memory, IEEE fp32 FFMA throughout.
            Any sequence length: steps past L count as x = 0, dt = 0.
  Bound     bytes at the served Jamba shape: x in and y out dominate (~250 MB
            a launch, ~76 us at 3.35 TB/s) against ~23 GFLOP of useful
            products.  The chunked body reads x twice (kernels 1 and 3).
  G         one group only (the reference's kernel asserts G == 1 too);
            ``ops.ssd`` sends G > 1 to the chunked reference, as the JAX
            package does.  ROADMAP Queue 2 item 3.

``ssd_chunked`` takes a kernel body for CUDA tensors and the plain version
for CPU tensors; a CUDA tensor never falls back to the plain version or to
the other body.  ``ssd_chunked.launches`` counts calls that launched,
``ssd_chunked.launches_by_body`` splits them by body.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.kernels.guard import refuse_autograd, refuse_dtensor

SHAPES = ((64, 16), (64, 128), (16, 16))   # (head_dim P, d_state N) compiled
MAX_CHUNK = 256

# bf16 x, B, C: kernel vs plain version.  Both compute in fp32 from the same
# bf16 inputs and round y to bf16 once, so an element of y differs by at most
# one bf16 ulp of y (2**-7 of it) plus the fp32 summation-order error.  The
# element bound scales the sum of the terms' magnitudes: the plain version run
# on |x|, |B| and |C| (dt and the decays are never negative), which bounds |y|.
# A row is only head_dim = 64 values, so one element whose rounding flips can
# dominate it and read up to 2**-7 = 7.8e-3;
# over the ~10**7 rows of a served prefill the kernel's worst row reads
# 5.9e-3 (H100), and the row bound sits at that ceiling.  The whole-output
# bound catches what stays under them: a state rounded to bf16 between chunks
# reads 5.5e-4 there.  The fp32 final state is held to STATE_REL_RMS: the
# kernel reads at most 6.6e-6 at served shapes (H100), the state-rounding
# control 1.7e-3.  tests/test_torch_bf16_bound.py holds both sides on the CPU,
# chip_smoke.py on the card.
BF16_ATOL, BF16_RTOL = 1e-5, 1e-2     # every element of y, against its magnitude
BF16_REL_RMS = 2e-4                   # the whole of y
BF16_ROW_REL_RMS = 8e-3               # every row of head_dim values of y
STATE_REL_RMS = 3e-5                  # the final state (fp32 on both sides)


def _check_groups(Bm: torch.Tensor) -> None:
    if Bm.shape[2] != 1:
        raise NotImplementedError(
            f"the SSD kernel and its plain version take one group of B/C; got "
            f"n_groups={Bm.shape[2]} (grouped SSD: ROADMAP Queue 2 item 3)")


def ssd_chunked_plain(
    x: torch.Tensor,               # (B, L, H, P)
    dt: torch.Tensor,              # (B, L, H): softplus'd step sizes
    A: torch.Tensor,               # (H,): negative decay rates
    Bm: torch.Tensor,              # (B, L, 1, N)
    Cm: torch.Tensor,              # (B, L, 1, N)
    *,
    chunk: int = 256,
) -> tuple:
    """The plain PyTorch version: ``_ssd_body`` chunk by chunk, every
    sequence and head at once.  A ragged last chunk is padded with x = 0,
    dt = 0, which neither decays nor updates the state, and y is cut back."""
    _check_groups(Bm)
    Bsz, L, H, P = x.shape
    N = Bm.shape[3]
    Q = min(chunk, L)
    pad = (-L) % Q
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm[:, :, 0].float(), Cm[:, :, 0].float()             # (B, L, N)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    Af = A.float()
    dev = x.device
    ii = torch.arange(Q, device=dev)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]       # (1, Qi, Qj, 1)
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
    ys = []
    for c in range((L + pad) // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dtc * Af, dim=1)                       # (B, Q, H)
        total = cum[:, -1]                                        # (B, H)
        cb = Cc @ Bc.transpose(-1, -2)                            # (B, Qi, Qj)
        seg = cum[:, :, None, :] - cum[:, None, :, :]             # (B, Qi, Qj, H)
        decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, NEG_INF)))
        w = cb[..., None] * decay * dtc[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xc)
        y_inter = torch.einsum("bin,bhpn->bihp", Cc, state) * torch.exp(cum)[..., None]
        ys.append((y_intra + y_inter).to(x.dtype))
        w_state = torch.exp(total[:, None, :] - cum) * dtc        # (B, Q, H)
        upd = torch.einsum("bjh,bjhp,bjn->bhpn", w_state, xc, Bc)
        state = state * torch.exp(total)[..., None, None] + upd
    return torch.cat(ys, dim=1)[:, :L], state


SPLIT = 3        # bf16 terms of an fp32 operand in the chunked body (csrc/ssd.cu)
SCAN_TILE = 64   # steps of a tile of ssd_chunk_scan's walk


def split_terms(v: torch.Tensor, terms: int = SPLIT) -> torch.Tensor:
    """An fp32 operand of a tensor-core product as the chunked body feeds it:
    the sum (in fp32) of ``terms`` bf16 terms, each the bf16 rounding of what
    the terms before it left.  Three terms hold an fp32 value exactly; one is
    plain bf16 rounding."""
    out, rest = torch.zeros_like(v), v
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out, rest = out + t, rest - t
    return out


def ssd_chunked_split_plain(
    x: torch.Tensor,               # (B, L, H, P)
    dt: torch.Tensor,              # (B, L, H)
    A: torch.Tensor,               # (H,)
    Bm: torch.Tensor,              # (B, L, 1, N)
    Cm: torch.Tensor,              # (B, L, 1, N)
    *,
    chunk: int = 256,
    terms: Optional[int] = SPLIT,
) -> tuple:
    """The chunked body's walk in plain PyTorch, for the tests, with the
    fp32 operands of the kernels' tensor-core products split into ``terms``
    bf16 terms (None: left in fp32); the other operands (x, B, C) are exact
    in bf16.  (1) Every chunk's local state from zero, x^T (u B); (2) the
    state pass, which turns them into the states entering each chunk with the
    serial body's update; (3) every chunk's y, walked in tiles of SCAN_TILE
    steps that carry R, the state at the end of the previous tile: a row
    takes the earlier steps through C R^T and its own tile's through the
    masked weights w.  y is rounded to x's type once."""
    _check_groups(Bm)
    Bsz, L, H, P = x.shape
    N = Bm.shape[3]
    Q = min(chunk, L)
    pad = (-L) % Q
    nc = (L + pad) // Q

    def pad_steps(t):             # steps past L: x = 0, dt = 0, as the kernels do
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    def split(v):
        return v if terms is None else split_terms(v, terms)
    xf = pad_steps(x.float()).view(Bsz, nc, Q, H, P)
    dtf = pad_steps(dt.float()).view(Bsz, nc, Q, H)
    Bf = pad_steps(Bm[:, :, 0].float()).view(Bsz, nc, Q, N)
    Cf = pad_steps(Cm[:, :, 0].float()).view(Bsz, nc, Q, N)
    cum = torch.cumsum(dtf * A.float(), dim=2)                    # (B, nc, Q, H)
    total = cum[:, :, -1]                                         # (B, nc, H)

    def state_product(u, xs, Bs):  # sum_j x_j (u_j B_j)^T: (B, nc, H, P, N)
        return torch.einsum("bcjhp,bcjhn->bchpn", xs, split(u[..., None] * Bs[:, :, :, None]))

    # 1. the chunk states: u_j = exp(total - cum_j) dt_j
    local = state_product(torch.exp(total[:, :, None] - cum) * dtf, xf, Bf)

    # 2. the state pass: the state entering each chunk, and the final state
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + local[:, c]

    # 3. the chunk scan, tile by tile
    R = torch.stack(entering, dim=1)                              # (B, nc, H, P, N)
    cum_r = torch.zeros_like(total)
    ys = []
    for i0 in range(0, Q, SCAN_TILE):
        sl = slice(i0, min(i0 + SCAN_TILE, Q))
        ct, dtt, xt, Bt, Ct = cum[:, :, sl], dtf[:, :, sl], xf[:, :, sl], Bf[:, :, sl], Cf[:, :, sl]
        n = ct.shape[2]
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()[:, :, None]
        seg = ct[:, :, :, None, :] - ct[:, :, None, :, :]        # (B, nc, i, j, H)
        decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, NEG_INF)))
        w = (Ct @ Bt.transpose(-1, -2))[..., None] * decay * dtt[:, :, None, :, :]
        ys.append(torch.einsum("bcin,bchpn->bcihp", Ct, split(R))
                  * torch.exp(ct - cum_r[:, :, None])[..., None]
                  + torch.einsum("bcijh,bcjhp->bcihp", split(w), xt))
        cum_e = ct[:, :, -1]
        R = (R * torch.exp(cum_e - cum_r)[..., None, None]
             + state_product(torch.exp(cum_e[:, :, None] - ct) * dtt, xt, Bt))
        cum_r = cum_e
    y = torch.cat(ys, dim=2)
    return y.reshape(Bsz, nc * Q, H, P)[:, :L].to(x.dtype), state


def bf16_agreement(y: torch.Tensor, state: torch.Tensor, plain_y: torch.Tensor,
                   plain_state: torch.Tensor, magnitude: torch.Tensor) -> dict:
    """How far a bf16 y (and its fp32 state) lie from the plain version's,
    in the terms of the bounds above.  ``magnitude`` is the plain version's
    y on ``|x|, |B|, |C|``."""
    stats = _fa.bf16_agreement(y, plain_y, magnitude, atol=BF16_ATOL, rtol=BF16_RTOL)
    stats["state_rel_rms"] = float((state - plain_state).norm()
                                   / plain_state.norm().clamp_min(1e-30))
    stats["finite"] = stats["finite"] and bool(torch.isfinite(state).all())
    return stats


def bf16_agrees(stats: dict) -> bool:
    return (_fa.bf16_agrees(stats, rel_rms=BF16_REL_RMS, row_rel_rms=BF16_ROW_REL_RMS)
            and stats["state_rel_rms"] <= STATE_REL_RMS)


def _check_inputs(x, dt, A, Bm, Cm, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("expected x (B, L, H, P), dt (B, L, H), A (H,), "
                         "B and C (B, L, G, N)")
    Bsz, L, H, P = x.shape
    if dt.shape != (Bsz, L, H) or A.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if Bm.shape != Cm.shape or Bm.shape[:2] != (Bsz, L):
        raise ValueError(f"B {tuple(Bm.shape)} / C {tuple(Cm.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in (torch.float32,
                                                                 torch.bfloat16):
        raise TypeError(f"x, B and C must share dtype float32 or bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("x, dt, A, B and C must lie on one device")
    if chunk < 1:
        raise ValueError("chunk must be positive")


BODIES = ("serial", "chunked")


def ssd_body(x: torch.Tensor) -> str:
    """The body a launch takes: "chunked" (tensor cores) for bf16, "serial"
    (IEEE fp32 FFMA) for fp32."""
    return "chunked" if x.dtype == torch.bfloat16 else "serial"


@functools.cache
def _kernel(body: str):
    """The library's C entry point of ``body``, built at first use and typed
    once."""
    from repro_torch.kernels import _build
    lib = _build.load("ssd.cu")
    if body == "serial":
        fn = lib.avo_ssd_chunked
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    else:
        fn = lib.avo_ssd_chunk_parallel
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, dt, A, Bm, Cm, *, chunk, body):
    Bsz, L, H, P = x.shape
    N = Bm.shape[3]
    Q = min(chunk, L)
    if (P, N) not in SHAPES:
        raise ValueError(f"(head_dim, d_state) = {(P, N)} unsupported by the SSD "
                         f"kernel (supported: {SHAPES})")
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk {Q} exceeds the SSD kernel's {MAX_CHUNK}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", Bm), ("C", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in (x, dt, A, Bm, Cm, y, state)]
    if body == "serial":
        err = _kernel(body)(*ptrs, int(x.dtype == torch.bfloat16),
                            Bsz, L, H, P, N, Q, stream)
    else:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the chunked SSD body takes bf16 x, B, C; got {x.dtype}")
        if any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
            raise ValueError("the chunked SSD body loads x, B and C 16 bytes at a "
                             "time: their data must be 16-byte aligned")
        nc = -(-L // Q)
        cum = torch.empty((Bsz, H, nc, 2, Q), dtype=torch.float32, device=x.device)
        states = torch.empty((Bsz, H, nc, P, N), dtype=torch.float32, device=x.device)
        err = _kernel(body)(*ptrs, cum.data_ptr(), states.data_ptr(),
                            Bsz, L, H, P, N, Q, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunked {body} launch failed: CUDA error {err}")
    ssd_chunked.launches += 1
    ssd_chunked.launches_by_body[body] += 1
    return y, state


def ssd_chunked(
    x: torch.Tensor,               # (B, L, H, P)
    dt: torch.Tensor,              # (B, L, H)
    A: torch.Tensor,               # (H,)
    Bm: torch.Tensor,              # (B, L, 1, N)
    Cm: torch.Tensor,              # (B, L, 1, N)
    *,
    chunk: int = 256,
    impl: Optional[str] = None,
    body: Optional[str] = None,
) -> tuple:
    """Returns (y: (B, L, H, P), final_state: (B, H, P, N) fp32).  CUDA
    tensors launch a kernel body (``body`` None: :func:`ssd_body`'s choice;
    "serial" forces the serial body on bf16, for A/B timing); CPU tensors
    take :func:`ssd_chunked_plain`.  ``impl="kernel"`` demands a kernel and
    raises on CPU tensors.  Any L: the last chunk may be short."""
    refuse_dtensor("ssd_chunked", x, dt, A, Bm, Cm)
    _check_inputs(x, dt, A, Bm, Cm, chunk)
    _check_groups(Bm)
    if impl not in (None, "kernel"):
        raise ValueError(f"impl={impl!r}; expected None or 'kernel'")
    if body not in (None, *BODIES):
        raise ValueError(f"body={body!r}; expected None or one of {BODIES}")
    if x.device.type == "cuda":
        refuse_autograd("ssd_chunked", x, dt, A, Bm, Cm)
        return _launch(x, dt, A, Bm, Cm, chunk=chunk, body=body or ssd_body(x))
    if impl == "kernel":
        raise ValueError(f"the ssd_chunked kernel runs on CUDA tensors; got "
                         f"tensors on {x.device}")
    return ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk)


ssd_chunked.launches = 0
ssd_chunked.launches_by_body = dict.fromkeys(BODIES, 0)
