"""Rung 0 for the card: an analytic model of the port's own flash-attention
kernel (``kernels/csrc/flash_attention.cu``) on an NVIDIA H100 SXM5.

The TPU v5e model (``core/perfmodel.py``) stays the reference's, verbatim,
for lineage parity with the JAX package.  This module models the kernel the
measured rung actually times, following the genome mapping of the ``.cu``
header:

- **Bodies.**  A bf16 launch at head_dim 64 or 128 (after the wrapper pads
  the head dim to a multiple of 16) takes the ``wgmma`` body: a CTA owns 128
  query rows, one producer warpgroup issues TMA loads, two consumer
  warpgroups of 64 rows each run Q·Kᵀ and P·V on the tensor cores, and K/V
  stream in chunks of 128 keys.  Other head dims take the ``mma_sync`` body:
  64 rows a CTA, chunks of 64 keys, products in series with the softmax,
  three CTAs an SM.  Only the ``wgmma`` body is on ``mha_suite``,
  ``gqa_suite`` and ``decode_suite``.
- **Logical blocks.**  ``block_q`` / ``block_k`` set the block
  classification, the ``block_skip`` bounds and the bf16-accumulator
  rounding points; the physical tile is fixed.  A larger logical block only
  adds masked diagonal chunks.
- **kv_in_grid.**  ``True``: a 2-stage TMA ring, loads overlap the products,
  the two consumers interleave.  ``False``: one stage, loaded only after the
  consumers release it; it always masks, rescales without a branch and
  divides at the end, and its ``block_skip`` bounds apply only without
  ``gqa_pack``'s ``seq_mod``.
- **rescale_mode="branched"** (ring only): a warp vote per chunk, which
  skips the accumulator rescale where no row of the warp raised its max.
- **div_mode="eager"** (ring only): P scaled by 1/l before P·V on the CUDA
  cores, no division at the end.
- **gqa_pack**: rows = S·rep on one KV head, positions taken modulo S.

Times.  Each term is charged on its unit: the products on the tensor cores
at the dense bf16 rate; the exp on the special-function units (MUFU); the
rest of the softmax, the mask, the rescale and the divisions on the FP32
cores.  The op counts per score are read off ``softmax_chunk`` and the
consumer loop.  Within a consumer the softmax runs in series with its own
products; on the ring the two consumers overlap each other, so a chunk takes
max(both consumers' products, one consumer's products + its softmax).  With
one stage both consumers wait for the same load and run in lockstep.

K/V bytes count reuse in L2: the ceil(S/128) CTAs of one head run together
and share its K/V, so while the heads in flight fit the 50 MB L2, K/V cross
HBM once per KV head.  CTAs: one a SM (wgmma: the register budget of 384
threads after ``setmaxnreg``, and 160 KB of shared memory at D = 128), in
launch order (row blocks heaviest first within a head); the makespan is
Graham's list-scheduling estimate, sum / SMs plus the last wave's mean.

:class:`perfmodel.Profile` and its field names are kept, so ``ScoreVector``,
``PerfModelCalibration`` and the agent work unchanged.  On the card the
fields mean:

- ``t_mxu``: tensor-core time;
- ``t_vpu_exposed``: softmax time on the FP32 cores and MUFU not hidden
  under the other consumer's products;
- ``t_dma_exposed``: load time the consumers wait for (the single stage's
  chunk loads, and HBM time beyond the compute);
- ``t_overhead``: the wave tail and each CTA's prologue (Q, the ring's first
  K chunk) and epilogue (the division, the O store).  The kernel launch
  itself is not modelled: it is the same for every genome;
- ``t_bubble``: the branched rescale's warp vote;
- ``vmem_bytes``: shared memory per CTA.

Every term is card time summed over CTAs and divided by the SM count, so
the terms add up to ``total_s``.  Feasibility is shared memory against
227 KB a block and head_dim against the kernel's 128; every genome of the
search space is feasible at every suite config (the logical blocks reach
2048 on a fixed physical tile).

The model is a pure function of (genome, config): the same constants serve
on the CPU, and ``chip_smoke.py`` holds the SM count, L2 size and shared
memory per block against ``torch.cuda.get_device_properties``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.perfmodel import (EXPERT_GENOME, FA_REFERENCE_GENOME,
                                        BatchEstimate, BenchConfig, Profile,
                                        useful_flops)
from repro_torch.core.search_space import KernelGenome
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, WGMMA_HEAD_DIMS

# ---- the card: NVIDIA H100 SXM5 80GB ---------------------------------------
N_SM = 132                   # SMs (H100 SXM5 data sheet; Hopper tuning guide)
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s (data sheet, no sparsity)
HBM_BW = 3.35e12             # HBM3 bytes/s (data sheet)
L2_BYTES = 50 * 2**20        # L2 cache (data sheet: 50 MB)
SMEM_PER_BLOCK = 227 * 1024  # sharedMemPerBlockOptin (Hopper tuning guide: 227 KB)
FP32_FLOPS = 67e12           # FP32 outside the tensor cores (data sheet; an FMA is 2)
FP32_OPS = FP32_FLOPS / 2    # FP32-core operations/s: one per lane per clock
MUFU_OPS = 3.9e12            # special-function ops/s (FlashAttention-3,
                             # arXiv:2407.08608 §3: 989 TFLOP/s of matmul
                             # against 3.9 TFLOP/s of special functions)
BF16_BYTES = 2

# per-SM shares of the chip-wide rates
_PEAK_SM = PEAK_FLOPS / N_SM
_FP32_SM = FP32_OPS / N_SM
_MUFU_SM = MUFU_OPS / N_SM
_HBM_SM = HBM_BW / N_SM

# ---- op counts, read off flash_attention.cu ---------------------------------
SOFTMAX_OPS = 6.5     # per score (softmax_chunk): scale, running max, subtract
                      # the max, exp2f's two range fix-ups (no fast math), row
                      # sum, half a bf16 pack for P
EXP_OPS = 1.0         # per score: ex2 on MUFU
MASK_OPS = 7.0        # per score of a masked chunk: the logical-block test and
                      # select, the key index, the padding, causal and window
                      # compares, their combination and the select
EAGER_OPS = 1.0       # per score under div_mode="eager": P *= 1/l
DIV_OPS = 5.0         # one IEEE fp32 division (reciprocal, refinement, check)
ROW_THREADS = 4       # threads holding one row (the quad of the m16n8 layout)
RESCALE_OPS = 1.0     # per accumulator element: o *= alpha
VOTE_OPS = 2.0        # per thread a chunk: __any_sync and its branch
ROUND_OPS = 2.0       # per accumulator element at a logical block end (bf16 acc)
WARP_ROWS = 16        # rows a warp's vote covers

# ---- achieved efficiency: one constant per body ------------------------------
# The share of the FP32-core and MUFU rates the softmax reaches: each consumer
# warpgroup is one warp per SM sub-partition, so the softmax runs latency-bound.
# Each value is the one at which this model gives chip_smoke.py's `times`
# reading for the pipelined genome at mha_causal_s4096 (PERF.md §6; NVIDIA
# H100 80GB HBM3 at 700 W): 1.243 ms on the wgmma body, 3.678 ms on the
# mma_sync body.  Nothing is fitted to any other genome.
ETA_WGMMA = 0.354
ETA_MMA_SYNC = 0.0596


class _Body:
    """Geometry of one kernel body (flash_attention.cu)."""

    def __init__(self, name, rows, chunk, consumers, ctas_per_sm, eta):
        self.name = name
        self.rows = rows                  # query rows a CTA
        self.chunk = chunk                # keys a physical chunk
        self.consumers = consumers        # row groups that run concurrently
        self.ctas_per_sm = ctas_per_sm
        self.eta = eta


# wgmma: W_BQ = 128 rows, W_BK = 128 keys, two consumer warpgroups of 64 rows;
# one CTA a SM (128 x 40 + 256 x 232 registers after setmaxnreg).
WGMMA = _Body("wgmma", 128, 128, 2, 1, ETA_WGMMA)
# mma_sync: BQ = 64 rows, BK = 64 keys, 4 warps, products synchronous;
# __launch_bounds__(128, 3): three CTAs a SM.
MMA_SYNC = _Body("mma_sync", 64, 64, 1, 3, ETA_MMA_SYNC)


def kernel_head_dim(head_dim: int) -> int:
    """The head_dim a launch runs at: the next multiple of 16, as the
    wrapper's ``kernel_head_dim`` pads it, without its range check (here a
    head_dim past 128 is infeasible, not an error)."""
    return -(-head_dim // 16) * 16


def body_for(cfg: BenchConfig) -> _Body:
    """The body a bf16 launch at ``cfg`` takes: routed by head_dim alone, as
    the wrapper's ``attention_body`` routes it."""
    return WGMMA if kernel_head_dim(cfg.head_dim) in WGMMA_HEAD_DIMS else MMA_SYNC


def smem_bytes(g: KernelGenome, cfg: BenchConfig, body=None) -> int:
    """Dynamic shared memory of one CTA, as the launch code sizes it."""
    D = kernel_head_dim(cfg.head_dim)
    stages = 2 if g.kv_in_grid else 1
    if (body or body_for(cfg)) is WGMMA:
        # WLayout: 1 KB alignment, Q then K and V per stage in 64-column TMA
        # boxes of 128 rows x 128 bytes, 64 bytes of barriers, the notes
        nb = D // 64
        return 1024 + nb * (1 + 2 * stages) * 128 * 128 + 64 + 16 * (1 + stages)
    # mma_sync launch(): rows of D + 8 bf16 (the pipelined path keeps Q in
    # stage 1's buffers)
    rows = 4 * 64 if g.kv_in_grid else 64 + 2 * 64
    return rows * (D + 8) * BF16_BYTES


def _infeasible(g: KernelGenome, cfg: BenchConfig, smem: int) -> str:
    if cfg.dtype_bytes != BF16_BYTES:
        return (f"infeasible: {cfg.dtype_bytes}-byte elements; the measured "
                "rung times bf16")
    if cfg.head_dim > MAX_HEAD_DIM:
        return f"infeasible: head_dim {cfg.head_dim} > {MAX_HEAD_DIM}"
    if smem > SMEM_PER_BLOCK:
        return (f"infeasible: shared memory {smem / 1024:.1f} KB > "
                f"{SMEM_PER_BLOCK // 1024} KB a block")
    return ""


def _floordiv(a, b):
    return np.floor_divide(a, b)


def walk_counts(g: KernelGenome, cfg: BenchConfig, body: _Body):
    """Per CTA, in row-block order: (chunks visited, masked chunks, logical K
    blocks visited).  The kernel's ``Walk`` and ``classify``, vectorised over
    the CTAs of one head."""
    S = cfg.seq_len
    rep = cfg.n_heads // cfg.n_kv_heads
    packed = g.gqa_pack and rep > 1
    R = S * rep if packed else S                 # rows of one fetching head
    bq, bk = min(g.block_q, R), min(g.block_k, S)
    nk = -(-S // bk)
    cpb = -(-bk // body.chunk)                   # physical chunks a logical block
    causal, w = cfg.causal, cfg.window
    n_cta = -(-R // body.rows)
    r0 = np.arange(n_cta, dtype=np.int64) * body.rows
    r_last = np.minimum(r0 + body.rows, R) - 1
    i_first, i_last = r0 // bq, r_last // bq

    def positions(i):
        """(q_lo, q_hi) of logical q block i, as classify sees them."""
        lo, hi = i * bq, i * bq + bq - 1
        if packed:
            wraps = (hi // S) != (lo // S)
            lo, hi = np.where(wraps, 0, lo % S), np.where(wraps, S - 1, hi % S)
        return lo, hi

    if not g.kv_in_grid:
        # the loop body: always masks; bounds narrowed only without seq_mod
        j_lo = np.zeros(n_cta, dtype=np.int64)
        j_hi = np.full(n_cta, nk, dtype=np.int64)
        if g.mask_mode == "block_skip" and not packed:
            if causal:
                j_hi = np.minimum(nk, (i_last * bq + bq + bk - 1) // bk)
            if w is not None:
                j_lo = np.maximum(0, _floordiv(i_first * bq - w + 1, bk))
        blocks = np.maximum(j_hi - j_lo, 0)
        return blocks * cpb, blocks * cpb, blocks
    if g.mask_mode == "dense":
        blocks = np.full(n_cta, nk, dtype=np.int64)
        return blocks * cpb, blocks * cpb, blocks

    # the ring with block_skip: logical block j runs when some logical q
    # block of the CTA's rows does not mask it fully (a union of at most two
    # intervals: 64 <= bq and 128 rows a CTA), and is unmasked when none of
    # them masks any of it
    visit, u_lo, u_hi = [], None, None
    for i in (i_first, i_last):
        q_lo, q_hi = positions(i)
        hi = np.minimum(nk, q_hi // bk + 1) if causal else np.full(n_cta, nk)
        lo = (np.maximum(0, _floordiv(q_lo - w + 1, bk)) if w is not None
              else np.zeros(n_cta, dtype=np.int64))
        visit.append((lo, np.maximum(hi, lo)))
        # fully unmasked: k_hi < S, k_hi <= q_lo (causal), k_lo > q_hi - w
        uh = np.full(n_cta, S // bk, dtype=np.int64)
        if causal:
            uh = np.minimum(uh, (q_lo + 1) // bk)
        ul = (-_floordiv(-(q_hi - w + 1), bk) if w is not None
              else np.zeros(n_cta, dtype=np.int64))
        u_lo = ul if u_lo is None else np.maximum(u_lo, ul)
        u_hi = uh if u_hi is None else np.minimum(u_hi, uh)
    (a_lo, a_hi), (b_lo, b_hi) = visit
    overlap = np.maximum(0, np.minimum(a_hi, b_hi) - np.maximum(a_lo, b_lo))
    blocks = (a_hi - a_lo) + (b_hi - b_lo) - overlap
    unmasked = np.clip(u_hi - u_lo, 0, None)
    masked_blocks = blocks - unmasked
    # a logical block that is not a whole number of chunks ends in a partial
    # chunk, which takes the masked path
    partial = unmasked if bk % body.chunk else 0
    return blocks * cpb, masked_blocks * cpb + partial, blocks


def _skipped_rescales(chunks: np.ndarray) -> np.ndarray:
    """Expected chunks on which a warp's vote skips the rescale: after n
    chunks of iid scores a row's max rises with probability 1 / (n + 1), and
    the warp skips when none of its 16 rows' does."""
    cmax = int(chunks.max()) if chunks.size else 0
    n = np.arange(1, max(cmax, 1), dtype=np.float64)
    cum = np.concatenate(([0.0, 0.0], np.cumsum((n / (n + 1)) ** WARP_ROWS)))
    return cum[chunks]


def _hbm_seconds(cfg: BenchConfig, body: _Body) -> tuple:
    """(HBM bytes, seconds) of one launch: q and o once, K/V once per KV head
    while the heads in flight fit L2, else once per CTA."""
    S, D = cfg.seq_len, kernel_head_dim(cfg.head_dim)
    rep = cfg.n_heads // cfg.n_kv_heads
    qo = 2 * cfg.batch * cfg.n_heads * S * D * BF16_BYTES
    kv_head = 2 * S * D * BF16_BYTES
    ctas_per_qhead = -(-S // body.rows)
    qheads_in_flight = -(-N_SM * body.ctas_per_sm // ctas_per_qhead)
    kv_in_flight = max(1, -(-qheads_in_flight // rep))
    reads = 1 if kv_in_flight * kv_head <= L2_BYTES else ctas_per_qhead * rep
    nbytes = qo + cfg.batch * cfg.n_kv_heads * kv_head * reads
    return nbytes, nbytes / HBM_BW


def estimate(g: KernelGenome, cfg: BenchConfig) -> Profile:
    """The kernel's modelled time on one H100 at ``cfg``'s full shape."""
    return estimate_body(g, cfg, body_for(cfg))


def estimate_body(g: KernelGenome, cfg: BenchConfig, body: _Body) -> Profile:
    """:func:`estimate` on a given body: ``MMA_SYNC`` at head_dim 128 is
    where the ``times`` phase reads that body beside the wgmma one, and so
    where its efficiency constant comes from."""
    uf = useful_flops(cfg)
    smem = smem_bytes(g, cfg, body)
    why = _infeasible(g, cfg, smem)
    if why:
        return Profile(0.0, 0.0, 0, 0, 0, 0, 0, smem, False, why, uf / PEAK_FLOPS)
    D = kernel_head_dim(cfg.head_dim)
    rep = cfg.n_heads // cfg.n_kv_heads
    packed = g.gqa_pack and rep > 1
    ring = g.kv_in_grid
    eager = ring and g.div_mode == "eager"
    branched = ring and g.rescale_mode == "branched"
    eta = body.eta

    chunks, masked, blocks = walk_counts(g, cfg, body)
    chunks = chunks.astype(np.float64)
    masked = masked.astype(np.float64)
    unmasked = chunks - masked

    # one row group (a consumer warpgroup; the whole CTA on mma_sync)
    rows_c = body.rows // body.consumers
    threads_c = 128
    scores = rows_c * body.chunk
    acc = rows_c * D
    t_mma = 2 * 2 * rows_c * body.chunk * D / _PEAK_SM    # Q K^T and P V
    fp32 = scores * SOFTMAX_OPS
    if eager:
        fp32 += scores * EAGER_OPS + rows_c * ROW_THREADS * 2 * DIV_OPS
    exps = scores * EXP_OPS + rows_c * ROW_THREADS        # + alpha per row
    # rescales done: every chunk, or (branched, deferred) where the vote passes
    if branched and not eager:
        done = np.where(chunks > 0, 1.0 - _skipped_rescales(chunks.astype(np.int64))
                        / np.maximum(chunks, 1.0), 1.0)
    else:
        done = np.ones_like(chunks)
    t_soft = (fp32 / _FP32_SM + exps / _MUFU_SM) / eta + done * (acc * RESCALE_OPS
                                                                 / _FP32_SM / eta)
    t_mask = scores * MASK_OPS / _FP32_SM / eta
    t_vote = threads_c * VOTE_OPS / _FP32_SM / eta if branched else 0.0
    k_bytes = body.chunk * D * BF16_BYTES
    t_k = k_bytes / _HBM_SM                            # one chunk's K (or V)

    mxu = 2 * t_mma if body is WGMMA else t_mma         # both consumers' products
    if body is WGMMA:
        if ring:
            # consumers interleave: a chunk is max(tensor cores, one chain)
            def period(soft):
                return np.maximum(mxu, t_mma + soft + t_vote)
            p_u, p_m = period(t_soft), period(t_soft + t_mask)
            dma_u = dma_m = 0.0
        else:
            # one stage, lockstep: wait K, both Q K^T, softmax, wait V, both P V
            def stage(soft):
                wait = t_k + np.maximum(0.0, t_k - t_mma - soft)
                return mxu + soft + wait, wait
            p_u, dma_u = stage(t_soft)
            p_m, dma_m = stage(t_soft + t_mask)
    else:
        # mma_sync: one CTA's chain in series; three CTAs share an SM
        def chain(soft):
            wait = 0.0 if ring else 2 * t_k
            c = t_mma + soft + t_vote + wait
            return np.maximum(t_mma, c / body.ctas_per_sm), wait / body.ctas_per_sm
        p_u, dma_u = chain(t_soft)
        p_m, dma_m = chain(t_soft + t_mask)
    # split of each chunk period into its exposed terms
    exp_u = np.maximum(p_u - mxu - dma_u, 0.0)
    exp_m = np.maximum(p_m - mxu - dma_m, 0.0)
    bub_u = np.minimum(t_vote, exp_u)
    bub_m = np.minimum(t_vote, exp_m)

    # prologue: Q; on the ring also the first chunk's K (later loads overlap)
    share = 1.0 / body.ctas_per_sm
    q_bytes = body.rows * D * BF16_BYTES
    pro = (q_bytes / _HBM_SM + np.where((chunks > 0) & ring, t_k, 0.0)) * share
    # epilogue: the deferred division, the O store, bf16-accumulator rounding
    epi = (q_bytes / _HBM_SM
           + (0.0 if eager else acc * DIV_OPS / _FP32_SM / eta)) * share
    rounding = (blocks * acc * ROUND_OPS / _FP32_SM / eta * share
                if g.acc_dtype == "bf16" else 0.0)

    c_mxu = chunks * mxu
    c_vpu = unmasked * (exp_u - bub_u) + masked * (exp_m - bub_m) + rounding
    c_dma = unmasked * dma_u + masked * dma_m
    c_bub = unmasked * bub_u + masked * bub_m
    c_ovh = pro + epi
    per_cta = c_mxu + c_vpu + c_dma + c_bub + c_ovh

    # launch order: for each (batch, head) the row blocks heaviest first;
    # every head of a config has the same pattern
    heads = cfg.batch * (cfg.n_kv_heads if packed else cfg.n_heads)
    n_cta = per_cta.size
    total_ctas = heads * n_cta
    slots = N_SM
    order = per_cta[::-1]
    last = np.arange(max(total_ctas - slots, 0), total_ctas) % n_cta
    t_last = float(order[last].mean())
    busy = heads * float(per_cta.sum()) / slots
    makespan = max(float(per_cta.max()), busy + (1.0 - 1.0 / slots) * t_last)
    tail = makespan - busy

    scale = heads / slots
    t_mxu = float(c_mxu.sum()) * scale
    t_vpu = float(c_vpu.sum()) * scale
    t_dma = float(c_dma.sum()) * scale
    t_bubble = float(c_bub.sum()) * scale
    t_overhead = float(c_ovh.sum()) * scale + tail
    hbm_bytes, t_hbm = _hbm_seconds(cfg, body)
    t_dma += max(0.0, t_hbm - makespan)             # HBM past the compute
    total = t_mxu + t_vpu + t_dma + t_overhead + t_bubble
    return Profile(
        tflops=uf / total / 1e12,
        total_s=total,
        t_mxu=t_mxu,
        t_vpu_exposed=t_vpu,
        t_dma_exposed=t_dma,
        t_overhead=t_overhead,
        t_bubble=t_bubble,
        vmem_bytes=smem,
        feasible=True,
        roofline_s=max(uf / PEAK_FLOPS, hbm_bytes / HBM_BW),
    )


class H100BatchEstimate(BatchEstimate):
    """:class:`BatchEstimate` over this model: the columns, plus the scalar
    :class:`Profile` of every lane, so ``profile`` returns exactly what
    :func:`estimate` gave (this model's infeasible reason included)."""

    def __init__(self, names, profiles):
        def col(attr):
            return np.array([[getattr(p, attr) for p in row] for row in profiles],
                            dtype=np.float64).reshape(len(profiles), len(names))
        super().__init__(
            config_names=names, tflops=col("tflops"), total_s=col("total_s"),
            t_mxu=col("t_mxu"), t_vpu=col("t_vpu_exposed"),
            t_dma=col("t_dma_exposed"), t_overhead=col("t_overhead"),
            t_bubble=col("t_bubble"), vmem=col("vmem_bytes").astype(np.int64),
            feasible=col("feasible").astype(bool),
            rooflines=tuple(profiles[0][i].roofline_s for i in range(len(names)))
            if profiles else ())
        self._profiles = profiles

    def profile(self, gi: int, ci: int) -> Profile:
        return self._profiles[gi][ci]


def estimate_batch(genomes: Sequence[KernelGenome],
                   suite: Sequence[BenchConfig]) -> H100BatchEstimate:
    """:func:`estimate` over a ``(genomes x suite)`` slate: one call a lane,
    so every lane equals the scalar path exactly."""
    suite = list(suite)
    return H100BatchEstimate(tuple(c.name for c in suite),
                             [[estimate(g, c) for c in suite] for g in genomes])


def expert_reference(cfg: BenchConfig) -> float:
    """The reference's expert genome through this model (modelled TFLOP/s)."""
    return estimate(EXPERT_GENOME, cfg).tflops


def fa_reference(cfg: BenchConfig) -> float:
    """The reference's FA genome through this model (modelled TFLOP/s)."""
    return estimate(FA_REFERENCE_GENOME, cfg).tflops
