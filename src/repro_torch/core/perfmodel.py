"""Rung 0 of the scoring function: the reference's analytic TPU v5e model.

This is a verbatim copy of the part of ``repro.core.perfmodel`` that the
serial loop calls: the constants, :class:`BenchConfig`, the suites and their
registry, :func:`useful_flops`, :func:`vmem_usage`, :class:`Profile` and
:func:`estimate`.  It models a TPU v5e, NOT the H100 the port runs on, and it
stays so on purpose: rung-0 scores, and therefore the lineages the agent
builds on them, must equal the reference's bit for bit.  Its times and
TFLOP/s are a model's output for a TPU; no number it returns is a time on
any card.  The card's own numbers come from the measured rung
(``Scorer(fidelity="measured")``), which times the CUDA kernel with CUDA
events and counts FLOPs with :func:`useful_flops`.

The rest of the reference follows, also verbatim: the columnar
:func:`estimate_batch` (the scorer's batch path at rung 0), the modelled
measured timer :func:`measured_estimate` with its invented
``MEASURED_TERM_FACTORS`` and :class:`PerfModelCalibration`, and the
reference genomes behind :func:`expert_reference` / :func:`fa_reference`.
They too model the TPU v5e.  On the card the measured rung times the kernel
instead of calling :func:`measured_estimate`, and ``Scorer.baselines()``
times cuDNN and FlashAttention instead of scoring the reference genomes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.search_space import KernelGenome, genome_columns

# ---- hardware constants (TPU v5e) -----------------------------------------
PEAK_FLOPS = 197e12          # bf16 MXU peak, per chip (brief-provided)
HBM_BW = 819e9               # bytes/s (brief-provided)
ICI_BW = 50e9                # bytes/s per link (brief-provided)
VPU_FLOPS = PEAK_FLOPS / 24  # vector unit effective throughput
VMEM_BYTES = 128 * 1024 * 1024
GRID_STEP_OVERHEAD = 50e-9
BRANCH_BUBBLE = 150e-9
KERNEL_LAUNCH = 2e-6
DMA_SETUP = 0.5e-6
MXU_VPU_OVERLAP = 0.6        # fraction of VPU work hidden under MXU (grid mode)

EXP_WEIGHT = 7.0             # transcendental cost in VPU flop-equivalents
MASK_COST = 3.0              # iota-compare-select per score element
SOFTMAX_COST = 3.0 + EXP_WEIGHT  # max+sub+sum+exp per score element


@dataclass(frozen=True)
class BenchConfig:
    """One column of the paper's benchmark suite (Fig. 3/4 x-axis points)."""
    name: str
    batch: int
    n_heads: int
    n_kv_heads: int
    seq_len: int
    head_dim: int = 128
    causal: bool = True
    window: Optional[int] = None
    dtype_bytes: int = 2     # bf16


def mha_suite() -> list[BenchConfig]:
    """Paper §4.1: head_dim 128, 16 heads, BF16, total tokens fixed at 32k."""
    out = []
    for causal in (True, False):
        for s in (4096, 8192, 16384, 32768):
            b = 32768 // s
            tag = "causal" if causal else "noncausal"
            out.append(BenchConfig(f"mha_{tag}_s{s}", b, 16, 16, s, causal=causal))
    return out


def gqa_suite() -> list[BenchConfig]:
    """Paper §4.3: Qwen3-style 32q/4kv (gs=8) and 32q/8kv (gs=4)."""
    out = []
    for causal in (True, False):
        for kv in (4, 8):
            for s in (4096, 8192, 16384, 32768):
                b = 32768 // s
                tag = "causal" if causal else "noncausal"
                out.append(BenchConfig(
                    f"gqa{32 // kv}_{tag}_s{s}", b, 32, kv, s, causal=causal))
    return out


def decode_suite() -> list[BenchConfig]:
    """Chunked-decode / chunked-prefill shapes: short causal chunks at large
    batch, GQA 32q/8kv, with and without a sliding window — the serving-side
    scenario family (total tokens fixed at 32k, like the other suites)."""
    out = []
    for window in (None, 1024):
        for s in (1024, 2048, 4096):
            b = 32768 // s
            tag = "full" if window is None else f"w{window}"
            out.append(BenchConfig(f"decode_{tag}_s{s}", b, 32, 8, s,
                                   causal=True, window=window))
    return out


# ---------------------------------------------------------------------------
# scenario registry
# ---------------------------------------------------------------------------

# name -> zero-arg factory returning a list[BenchConfig].  Extend with
# register_suite(); the island engine auto-scales one specialist island per
# entry (Archipelago.from_registry), so a new scenario family needs no
# engine-code change.
SUITES: dict = {}


def register_suite(name: str, factory, *, overwrite: bool = False):
    """Register a scenario-suite factory under ``name``.

    ``name`` must be a plain identifier-ish token: '+' is the union operator
    in ``suite_by_name`` and cannot appear in a registered name.  Returns the
    factory so this can be used as a decorator.
    """
    if not name or not name.strip() or "+" in name:
        raise ValueError(f"invalid suite name {name!r}")
    if name in SUITES and not overwrite:
        raise ValueError(f"suite {name!r} already registered "
                         "(pass overwrite=True to replace)")
    SUITES[name] = factory
    return factory


def unregister_suite(name: str) -> None:
    """Remove a registered suite (primarily for tests)."""
    SUITES.pop(name, None)


def registered_suites() -> tuple:
    """The registered scenario-family names, sorted."""
    return tuple(sorted(SUITES))


register_suite("mha", mha_suite)
register_suite("gqa", gqa_suite)
register_suite("decode", decode_suite)


def suite_by_name(name: str) -> list[BenchConfig]:
    """Scenario-suite registry lookup: any registered name ('mha' | 'gqa' |
    'decode' | ...), or a '+'-joined union like 'mha+gqa+decode' (the
    generalist target)."""
    parts = [p.strip() for p in name.split("+") if p.strip()]
    unknown = [p for p in parts if p not in SUITES]
    if unknown or not parts:
        raise ValueError(f"unknown suite {name!r}; known: {sorted(SUITES)}")
    out: list[BenchConfig] = []
    for p in parts:
        out.extend(SUITES[p]())
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _mxu_eff(dim: int) -> float:
    """Systolic-array utilization of a matmul dim (pad-to-128 waste)."""
    return dim / (128 * math.ceil(dim / 128))


def _visited_blocks(i, bq, bk, nk, causal, window, S):
    """[j_lo, j_hi) K-block range intersecting the mask for q-block i."""
    q_lo, q_hi = i * bq, min(i * bq + bq, S) - 1
    j_hi = nk if not causal else min(nk, math.ceil((q_hi + 1) / bk))
    j_lo = 0 if window is None else max(0, (q_lo - window + 1) // bk)
    return j_lo, max(j_hi, j_lo)


def useful_flops(cfg: BenchConfig) -> float:
    """FA-convention 'useful' FLOPs: 4 * D * (# valid q,k pairs) per head."""
    S = cfg.seq_len
    if cfg.causal and cfg.window:
        pairs = sum(min(q + 1, cfg.window) for q in range(S))
    elif cfg.causal:
        pairs = S * (S + 1) // 2
    elif cfg.window:
        # the mask (ref.py) is k > q - window: backward side capped at the
        # window, forward side unbounded — count both
        pairs = sum(min(q + 1, cfg.window) + (S - 1 - q) for q in range(S))
    else:
        pairs = S * S
    return 4.0 * cfg.batch * cfg.n_heads * cfg.head_dim * pairs


def vmem_usage(g: KernelGenome, cfg: BenchConfig) -> int:
    """Bytes of VMEM the genome's working set claims."""
    D, dt = cfg.head_dim, cfg.dtype_bytes
    S = cfg.seq_len
    rep = cfg.n_heads // cfg.n_kv_heads
    rows = S * rep if (g.gqa_pack and rep > 1) else S
    bq = min(g.block_q, rows)
    bk = min(g.block_k, S)
    acc = bq * D * (2 if getattr(g, "acc_dtype", "f32") == "bf16" else 4)
    stats = 2 * bq * 128 * 4
    scores = bq * bk * 4
    qbuf = bq * D * dt
    if g.kv_in_grid:
        kvbuf = 2 * (2 * bk * D * dt)           # K+V, double buffered
    else:
        kvbuf = 2 * (S * D * dt)                # full K/V staged
    return acc + stats + scores + qbuf + kvbuf


@dataclass
class Profile:
    """The 'profiler output' the agent sees for one benchmark config."""
    tflops: float
    total_s: float
    t_mxu: float
    t_vpu_exposed: float
    t_dma_exposed: float
    t_overhead: float
    t_bubble: float
    vmem_bytes: int
    feasible: bool
    infeasible_reason: str = ""
    roofline_s: float = 0.0

    @property
    def fraction_of_roofline(self) -> float:
        return 0.0 if self.total_s == 0 else self.roofline_s / self.total_s

    def bottleneck(self) -> str:
        terms = {
            "mxu": self.t_mxu,
            "vpu": self.t_vpu_exposed,
            "dma": self.t_dma_exposed,
            "overhead": self.t_overhead,
            "bubble": self.t_bubble,
        }
        return max(terms, key=terms.get)

    def breakdown(self) -> dict:
        return {
            "tflops": self.tflops, "total_s": self.total_s, "t_mxu": self.t_mxu,
            "t_vpu_exposed": self.t_vpu_exposed, "t_dma_exposed": self.t_dma_exposed,
            "t_overhead": self.t_overhead, "t_bubble": self.t_bubble,
            "vmem_bytes": self.vmem_bytes, "bottleneck": self.bottleneck(),
            "fraction_of_roofline": self.fraction_of_roofline,
        }


def estimate(g: KernelGenome, cfg: BenchConfig) -> Profile:
    """Model the kernel's execution time on one v5e core."""
    D, dt, S = cfg.head_dim, cfg.dtype_bytes, cfg.seq_len
    rep = cfg.n_heads // cfg.n_kv_heads
    packed = g.gqa_pack and rep > 1

    vmem = vmem_usage(g, cfg)
    uf = useful_flops(cfg)
    roofline_s = uf / PEAK_FLOPS
    if vmem > VMEM_BYTES:
        return Profile(0.0, 0.0, 0, 0, 0, 0, 0, vmem, False,
                       f"VMEM overflow: {vmem / 2**20:.1f} MiB > 128 MiB",
                       roofline_s)

    rows = S * rep if packed else S             # q rows per fetching head
    n_fetch_heads = cfg.n_kv_heads if packed else cfg.n_heads
    seq_mod = S if packed else None

    bq = min(g.block_q, rows)
    bk = min(g.block_k, S)
    nq = math.ceil(rows / bq)
    nk = math.ceil(S / bk)

    u_q, u_k = _mxu_eff(min(bq, rows)), _mxu_eff(min(bk, S))

    t_mxu = t_vpu = t_dma = t_overhead = t_bubble = 0.0
    # iterate q-blocks of ONE fetching head; scale by batch * n_fetch_heads
    for i in range(nq):
        if seq_mod is not None:
            # packed tiles spanning a sequence wrap cover every position
            lo_pos = (i * bq) % seq_mod
            hi_pos = lo_pos + bq - 1
            if hi_pos >= seq_mod:
                q_lo_m, q_hi_m = 0, seq_mod - 1
            else:
                q_lo_m, q_hi_m = lo_pos, hi_pos
            j_hi = nk if not cfg.causal else min(nk, math.ceil((q_hi_m + 1) / bk))
            j_lo = (0 if cfg.window is None
                    else max(0, (q_lo_m - cfg.window + 1) // bk))
            j_hi = max(j_hi, j_lo)
        else:
            j_lo, j_hi = _visited_blocks(i, bq, bk, nk, cfg.causal, cfg.window, S)

        if g.mask_mode == "block_skip":
            n_run = j_hi - j_lo
            n_boundary = min(n_run, max(1, math.ceil(bq / bk) + 1))
        else:
            n_run, n_boundary = nk, nk          # dense: visit & mask everything

        per_blk_mxu = 4.0 * bq * bk * D / (PEAK_FLOPS * u_q * u_k)
        softmax_vpu = SOFTMAX_COST * bq * bk
        rescale_vpu = 2.0 * bq * D              # acc *= alpha (+select)
        eager_vpu = (2.0 * bq * D + bq) if g.div_mode == "eager" else 0.0
        mask_vpu = MASK_COST * bq * bk

        blk_times = []
        for j in range(n_run):
            vpu_ops = softmax_vpu + eager_vpu
            if g.mask_mode == "dense" or j >= n_run - n_boundary:
                vpu_ops += mask_vpu
            bubble = 0.0
            if g.rescale_mode == "branchless":
                vpu_ops += rescale_vpu
            else:
                bubble = BRANCH_BUBBLE
                p_trigger = 1.0 / (j + 1)       # P(block max beats running max)
                vpu_ops += p_trigger * rescale_vpu + bq  # + warp-wide check
            t_v = vpu_ops / VPU_FLOPS
            kv_bytes = 2 * bk * D * dt
            t_d = kv_bytes / HBM_BW
            if g.kv_in_grid:
                compute = per_blk_mxu + (1 - MXU_VPU_OVERLAP) * t_v
                total = max(compute, t_d)
                exposed_dma = max(0.0, t_d - compute)
                exposed_vpu = (1 - MXU_VPU_OVERLAP) * t_v
            else:
                total = per_blk_mxu + t_v       # DMA accounted once below
                exposed_dma = 0.0
                exposed_vpu = t_v
            blk_times.append((total, per_blk_mxu, exposed_vpu, exposed_dma, bubble))

        t_mxu += sum(b[1] for b in blk_times)
        t_vpu += sum(b[2] for b in blk_times)
        t_dma += sum(b[3] for b in blk_times)
        t_bubble += sum(b[4] for b in blk_times)
        t_overhead += GRID_STEP_OVERHEAD * (n_run if g.kv_in_grid else 1)
        # epilogue normalization (deferred) runs once per q-block on the VPU
        if g.div_mode == "deferred":
            t_vpu += (bq * D) / VPU_FLOPS
        # q/o traffic + (loop mode) full K/V staging
        qo_bytes = bq * D * dt * 2
        if g.kv_in_grid:
            t_dma += max(0.0, qo_bytes / HBM_BW - GRID_STEP_OVERHEAD)
        else:
            stage_bytes = 2 * S * D * dt
            t_dma += qo_bytes / HBM_BW + stage_bytes / HBM_BW + DMA_SETUP

    per_head = (t_mxu + t_vpu + t_dma + t_overhead + t_bubble)
    # re-derive blockwise max() effects: the loop above already folded
    # max(compute, dma) into components by exposing only the uncovered parts.
    total = KERNEL_LAUNCH + cfg.batch * n_fetch_heads * per_head
    scale = cfg.batch * n_fetch_heads
    prof = Profile(
        tflops=uf / total / 1e12,
        total_s=total,
        t_mxu=t_mxu * scale,
        t_vpu_exposed=t_vpu * scale,
        t_dma_exposed=t_dma * scale,
        t_overhead=t_overhead * scale,
        t_bubble=t_bubble * scale,
        vmem_bytes=vmem,
        feasible=True,
        roofline_s=roofline_s,
    )
    return prof


# ---------------------------------------------------------------------------
# columnar (struct-of-arrays) batch evaluation of the same model
# ---------------------------------------------------------------------------


@dataclass
class BatchEstimate:
    """Columnar result of :func:`estimate_batch`: one float64 column per
    :class:`Profile` term, shaped ``(n_genomes, n_configs)``.  ``profile``
    materializes the scalar :class:`Profile` for one lane on demand —
    bit-identical to what :func:`estimate` returns for that (genome, config)
    pair, including the infeasible zero-profile and its reason string."""
    config_names: tuple
    tflops: np.ndarray
    total_s: np.ndarray
    t_mxu: np.ndarray
    t_vpu: np.ndarray
    t_dma: np.ndarray
    t_overhead: np.ndarray
    t_bubble: np.ndarray
    vmem: np.ndarray
    feasible: np.ndarray
    rooflines: tuple = field(default_factory=tuple)   # per config

    def __len__(self) -> int:
        return self.tflops.shape[0]

    def profile(self, gi: int, ci: int) -> Profile:
        vmem = int(self.vmem[gi, ci])
        if not self.feasible[gi, ci]:
            return Profile(0.0, 0.0, 0, 0, 0, 0, 0, vmem, False,
                           f"VMEM overflow: {vmem / 2**20:.1f} MiB > 128 MiB",
                           self.rooflines[ci])
        return Profile(
            tflops=float(self.tflops[gi, ci]),
            total_s=float(self.total_s[gi, ci]),
            t_mxu=float(self.t_mxu[gi, ci]),
            t_vpu_exposed=float(self.t_vpu[gi, ci]),
            t_dma_exposed=float(self.t_dma[gi, ci]),
            t_overhead=float(self.t_overhead[gi, ci]),
            t_bubble=float(self.t_bubble[gi, ci]),
            vmem_bytes=vmem,
            feasible=True,
            roofline_s=self.rooflines[ci],
        )

    def profiles(self, gi: int) -> dict:
        """``{config name: Profile}`` for one genome (the scorer's shape)."""
        return {name: self.profile(gi, ci)
                for ci, name in enumerate(self.config_names)}


def estimate_batch(genomes: Sequence[KernelGenome],
                   suite: Sequence[BenchConfig]) -> BatchEstimate:
    """Vectorized :func:`estimate` over a ``(genomes x suite)`` slate.

    The genome list is decomposed into struct-of-arrays columns over the
    ``_GENOME_DEFAULTS`` field table and the whole model runs as element-wise
    float64 NumPy ops over *lanes* (one lane per (genome, config) pair,
    genome-major).  Every arithmetic expression below replicates the scalar
    code's operation order and associativity exactly — float64 NumPy ufuncs
    round identically to CPython float ops — so results are **bit-identical**
    to the scalar path (gated by tests and the `--slate-smoke` bench).

    The two data-dependent trip counts become masked loops: the q-block walk
    runs to ``max(nq)`` emitting one *row* per active (lane, i), and the
    K-block walk runs to ``max(n_run)`` accumulating per-row subtotals in
    ascending-j order — the same sequential fold as the scalar
    ``sum(...)`` over ``blk_times``.  Row subtotals then fold into per-lane
    totals in ascending-i order, matching the scalar outer loop."""
    genomes, suite = list(genomes), list(suite)
    N, C = len(genomes), len(suite)
    names = tuple(c.name for c in suite)
    rooflines = tuple(useful_flops(c) / PEAK_FLOPS for c in suite)
    if N == 0 or C == 0:
        z = np.zeros((N, C))
        return BatchEstimate(names, z, z.copy(), z.copy(), z.copy(), z.copy(),
                             z.copy(), z.copy(), z.astype(np.int64),
                             np.ones((N, C), dtype=bool), rooflines)
    L = N * C

    # -- per-genome columns, repeated genome-major over lanes ----------------
    cols = genome_columns(genomes)
    rep_g = lambda vals, dt_: np.repeat(np.asarray(vals, dtype=dt_), C)
    block_q = rep_g(cols["block_q"], np.int64)
    block_k = rep_g(cols["block_k"], np.int64)
    branchless = rep_g([m == "branchless" for m in cols["rescale_mode"]], bool)
    dense = rep_g([m == "dense" for m in cols["mask_mode"]], bool)
    eager = rep_g([m == "eager" for m in cols["div_mode"]], bool)
    deferred = rep_g([m == "deferred" for m in cols["div_mode"]], bool)
    kv_in_grid = rep_g(cols["kv_in_grid"], bool)
    gqa_pack = rep_g(cols["gqa_pack"], bool)
    bf16_acc = rep_g([a == "bf16" for a in cols["acc_dtype"]], bool)

    # -- per-config columns, tiled over lanes --------------------------------
    tile_c = lambda vals, dt_: np.tile(np.asarray(vals, dtype=dt_), N)
    D = tile_c([c.head_dim for c in suite], np.int64)
    dt = tile_c([c.dtype_bytes for c in suite], np.int64)
    S = tile_c([c.seq_len for c in suite], np.int64)
    batch = tile_c([c.batch for c in suite], np.int64)
    n_heads = tile_c([c.n_heads for c in suite], np.int64)
    n_kv = tile_c([c.n_kv_heads for c in suite], np.int64)
    causal = tile_c([c.causal for c in suite], bool)
    has_win = tile_c([c.window is not None for c in suite], bool)
    window = tile_c([(0 if c.window is None else c.window) for c in suite],
                    np.int64)
    uf = tile_c([useful_flops(c) for c in suite], np.float64)

    rep = n_heads // n_kv
    packed = gqa_pack & (rep > 1)

    # -- vmem_usage, element-wise (all-integer, same ops) --------------------
    rows_ = np.where(packed, S * rep, S)
    bq = np.minimum(block_q, rows_)
    bk = np.minimum(block_k, S)
    acc = bq * D * np.where(bf16_acc, 2, 4)
    stats = 2 * bq * 128 * 4
    scores = bq * bk * 4
    qbuf = bq * D * dt
    kvbuf = np.where(kv_in_grid, 2 * (2 * bk * D * dt), 2 * (S * D * dt))
    vmem = acc + stats + scores + qbuf + kvbuf
    feasible = vmem <= VMEM_BYTES

    n_fetch = np.where(packed, n_kv, n_heads)
    nq = np.ceil(rows_ / bq).astype(np.int64)
    nk = np.ceil(S / bk).astype(np.int64)
    # _mxu_eff: int / (128 * ceil(int/128)) — int/int true division
    u_q = bq / (128 * np.ceil(bq / 128).astype(np.int64))
    u_k = bk / (128 * np.ceil(bk / 128).astype(np.int64))

    # -- per-lane i/j-invariant terms (scalar op order preserved) ------------
    per_blk_mxu = 4.0 * bq * bk * D / (PEAK_FLOPS * u_q * u_k)
    softmax_vpu = SOFTMAX_COST * bq * bk
    rescale_vpu = 2.0 * bq * D
    eager_vpu = np.where(eager, 2.0 * bq * D + bq, 0.0)
    mask_vpu = MASK_COST * bq * bk
    t_d = (2 * bk * D * dt) / HBM_BW
    c04 = 1 - MXU_VPU_OVERLAP
    nb_cap = np.maximum(1, np.ceil(bq / bk).astype(np.int64) + 1)
    # vpu_ops accumulates left-to-right: ((softmax+eager)[+mask])+rescale
    base_v = softmax_vpu + eager_vpu
    sel_m = base_v + mask_vpu
    tv_bl_nm = (base_v + rescale_vpu) / VPU_FLOPS
    tv_bl_m = (sel_m + rescale_vpu) / VPU_FLOPS

    # -- phase A: q-block walk -> one row per active (lane, i) ---------------
    lane_ids = np.arange(L)
    act_lane = feasible
    max_nq = int(nq[act_lane].max()) if act_lane.any() else 0
    lane_parts, nrun_parts, nb_parts = [], [], []
    group_bounds = []
    total_rows = 0
    for i in range(max_nq):
        m = act_lane & (i < nq)
        if not m.any():
            break
        lanes_i = lane_ids[m]
        bq_i, bk_i, S_i, nk_i = bq[m], bk[m], S[m], nk[m]
        # packed tiles wrap around the sequence; plain tiles clamp at S
        lo_pos = (i * bq_i) % S_i
        hi_pos = lo_pos + bq_i - 1
        wrap = hi_pos >= S_i
        q_lo = np.where(packed[m], np.where(wrap, 0, lo_pos), i * bq_i)
        q_hi = np.where(packed[m], np.where(wrap, S_i - 1, hi_pos),
                        np.minimum(i * bq_i + bq_i, S_i) - 1)
        j_hi = np.where(causal[m],
                        np.minimum(nk_i,
                                   np.ceil((q_hi + 1) / bk_i).astype(np.int64)),
                        nk_i)
        j_lo = np.where(has_win[m],
                        np.maximum(0, (q_lo - window[m] + 1) // bk_i), 0)
        j_hi = np.maximum(j_hi, j_lo)
        n_run = np.where(dense[m], nk_i, j_hi - j_lo)
        n_b = np.where(dense[m], nk_i, np.minimum(j_hi - j_lo, nb_cap[m]))
        lane_parts.append(lanes_i)
        nrun_parts.append(n_run)
        nb_parts.append(n_b)
        group_bounds.append((total_rows, total_rows + len(lanes_i)))
        total_rows += len(lanes_i)

    R = total_rows
    row_lane = (np.concatenate(lane_parts) if R else
                np.zeros(0, dtype=np.int64))
    row_nrun = (np.concatenate(nrun_parts) if R else
                np.zeros(0, dtype=np.int64))
    row_nb = np.concatenate(nb_parts) if R else np.zeros(0, dtype=np.int64)

    # -- phase B: K-block walk, per-row subtotals in ascending-j order -------
    # sort rows ascending by trip count so the active set at step j is a
    # contiguous suffix (views, no boolean-mask temporaries); per-row
    # accumulation order is j-ascending regardless of row permutation, which
    # is exactly the scalar `sum(...)` fold over blk_times.
    order = np.argsort(row_nrun, kind="stable")
    s_nrun = row_nrun[order]
    s_mask_from = s_nrun - row_nb[order]        # mask applies at j >= this
    rl = row_lane[order]
    s_pb, s_td = per_blk_mxu[rl], t_d[rl]
    s_bl, s_grid = branchless[rl], kv_in_grid[rl]
    s_tvblnm, s_tvblm = tv_bl_nm[rl], tv_bl_m[rl]
    s_selnm, s_selm = base_v[rl], sel_m[rl]
    s_resc, s_bq = rescale_vpu[rl], bq[rl]
    s_mxu = np.zeros(R)
    s_vpu = np.zeros(R)
    s_dma = np.zeros(R)
    s_bub = np.zeros(R)
    max_j = int(s_nrun[-1]) if R else 0
    for j in range(max_j):
        k = int(np.searchsorted(s_nrun, j, side="right"))
        sl = slice(k, R)
        masked = j >= s_mask_from[sl]
        p_j = 1.0 / (j + 1)                     # P(block max beats running max)
        sel = np.where(masked, s_selm[sl], s_selnm[sl])
        tv_br = (sel + (p_j * s_resc[sl] + s_bq[sl])) / VPU_FLOPS
        tv_bl = np.where(masked, s_tvblm[sl], s_tvblnm[sl])
        t_v = np.where(s_bl[sl], tv_bl, tv_br)
        compute = s_pb[sl] + c04 * t_v
        s_mxu[sl] += s_pb[sl]
        s_vpu[sl] += np.where(s_grid[sl], c04 * t_v, t_v)
        s_dma[sl] += np.where(s_grid[sl],
                              np.maximum(0.0, s_td[sl] - compute), 0.0)
        s_bub[sl] += np.where(s_bl[sl], 0.0, BRANCH_BUBBLE)
    # unsort back to (i-major) row order
    u_mxu = np.empty(R); u_mxu[order] = s_mxu
    u_vpu = np.empty(R); u_vpu[order] = s_vpu
    u_dma = np.empty(R); u_dma[order] = s_dma
    u_bub = np.empty(R); u_bub[order] = s_bub

    # -- phase C: fold rows into per-lane totals in ascending-i order --------
    T_mxu = np.zeros(L)
    T_vpu = np.zeros(L)
    T_dma = np.zeros(L)
    T_ovh = np.zeros(L)
    T_bub = np.zeros(L)
    defer_add = np.where(deferred, (bq * D) / VPU_FLOPS, 0.0)
    qo_bytes = bq * D * dt * 2
    stage_bytes = 2 * S * D * dt
    qo_add = np.where(kv_in_grid,
                      np.maximum(0.0, qo_bytes / HBM_BW - GRID_STEP_OVERHEAD),
                      qo_bytes / HBM_BW + stage_bytes / HBM_BW + DMA_SETUP)
    for a, b in group_bounds:
        lanes_i = row_lane[a:b]                 # each lane at most once per i
        T_mxu[lanes_i] += u_mxu[a:b]
        T_vpu[lanes_i] += u_vpu[a:b]
        T_dma[lanes_i] += u_dma[a:b]
        T_bub[lanes_i] += u_bub[a:b]
        T_ovh[lanes_i] += GRID_STEP_OVERHEAD * np.where(kv_in_grid[lanes_i],
                                                        row_nrun[a:b], 1)
        T_vpu[lanes_i] += defer_add[lanes_i]    # += 0.0 where eager: exact
        T_dma[lanes_i] += qo_add[lanes_i]

    per_head = (T_mxu + T_vpu + T_dma + T_ovh + T_bub)
    scale = batch * n_fetch
    total = KERNEL_LAUNCH + scale * per_head
    tflops = uf / total / 1e12

    def _col(v):
        return np.where(feasible, v, 0.0).reshape(N, C)

    return BatchEstimate(
        config_names=names,
        tflops=_col(tflops),
        total_s=_col(total),
        t_mxu=_col(T_mxu * scale),
        t_vpu=_col(T_vpu * scale),
        t_dma=_col(T_dma * scale),
        t_overhead=_col(T_ovh * scale),
        t_bubble=_col(T_bub * scale),
        vmem=vmem.reshape(N, C),
        feasible=feasible.reshape(N, C),
        rooflines=rooflines,
    )


# ---------------------------------------------------------------------------
# the measured rung's modelled timer + residual-driven calibration
# ---------------------------------------------------------------------------

# Per-term scale factors applied by the *modelled* measured timer
# (``measured_estimate``), the deterministic stand-in for compile-and-time
# where no accelerator exists.  They encode the systematic ways the analytic
# model flatters real silicon — vector work, DMA setup, sequencer overhead
# and branch bubbles all cost more on hardware than the clean per-op charges
# above — so rung-2 scores diverge from rung-0 in a *bottleneck-dependent*
# way.  That is exactly the structure the calibration loop can learn: the
# measured/predicted residual clusters by bottleneck class, and a per-class
# EMA correction genuinely shrinks the cheap rung's ranking error.
MEASURED_TERM_FACTORS = {
    "mxu": 1.0,          # matmul throughput is what the model is best at
    "vpu": 1.45,         # transcendental + select cost is underestimated
    "dma": 1.25,         # real DMA never hits peak HBM bandwidth
    "overhead": 1.9,     # sequencer + launch overheads compound
    "bubble": 2.4,       # predicated-region bubbles serialize worse than 150ns
}


def measured_estimate(g: KernelGenome, cfg: BenchConfig) -> Profile:
    """The deterministic 'modelled timer' for the cascade's measured rung:
    :func:`estimate` with each exposed term scaled by its
    :data:`MEASURED_TERM_FACTORS` entry.  Stands in for compile-and-time on
    hosts without an accelerator — deterministic (so backends stay
    bit-identical and kill/resume replays) while still disagreeing with
    rung 0 systematically per bottleneck class."""
    p = estimate(g, cfg)
    if not p.feasible:
        return p
    t_mxu = p.t_mxu * MEASURED_TERM_FACTORS["mxu"]
    t_vpu = p.t_vpu_exposed * MEASURED_TERM_FACTORS["vpu"]
    t_dma = p.t_dma_exposed * MEASURED_TERM_FACTORS["dma"]
    t_overhead = p.t_overhead * MEASURED_TERM_FACTORS["overhead"]
    t_bubble = p.t_bubble * MEASURED_TERM_FACTORS["bubble"]
    total = KERNEL_LAUNCH + t_mxu + t_vpu + t_dma + t_overhead + t_bubble
    return Profile(
        tflops=useful_flops(cfg) / total / 1e12,
        total_s=total,
        t_mxu=t_mxu, t_vpu_exposed=t_vpu, t_dma_exposed=t_dma,
        t_overhead=t_overhead, t_bubble=t_bubble,
        vmem_bytes=p.vmem_bytes, feasible=True,
        roofline_s=p.roofline_s)


class PerfModelCalibration:
    """Residual-driven correction of the cheap rung, per bottleneck class.

    The evaluation cascade records, for every genome that reaches the
    measured rung, the ratio of its measured geomean to its rung-0 perfmodel
    geomean, bucketed by the rung-0 :meth:`ScoreVector.dominant_bottleneck`
    class.  Each class keeps an EMA of that ratio; :meth:`corrected` then
    rescales a rung-0 score by its class's factor when *ranking* candidates
    for promotion.  Raw scorer values are never touched — lineages stay
    bit-identical with calibration on or off; only which candidates pay for
    expensive rungs changes.  ``state``/``load_state`` round-trip through the
    archipelago payload so a killed/resumed run replays identical promotion
    and correction decisions.
    """

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.factors: dict[str, float] = {}    # bottleneck class -> EMA ratio
        self.observations = 0

    def observe(self, bottleneck: str, predicted: float,
                measured: float) -> None:
        """Fold one measured-vs-predicted residual into the class's EMA."""
        if predicted <= 0.0 or measured <= 0.0:
            return               # failed/infeasible at either rung: no signal
        ratio = measured / predicted
        prev = self.factors.get(bottleneck)
        self.factors[bottleneck] = ratio if prev is None else \
            (1.0 - self.alpha) * prev + self.alpha * ratio
        self.observations += 1

    def correction(self, bottleneck: str) -> float:
        return self.factors.get(bottleneck, 1.0)

    def corrected(self, bottleneck: str, predicted: float) -> float:
        """A rung-0 score rescaled into measured-rung units — the cascade's
        promotion-ranking score."""
        return predicted * self.correction(bottleneck)

    # -- persistence (rides in the archipelago payload) -------------------------
    def state(self) -> dict:
        return {"alpha": self.alpha,
                "observations": self.observations,
                "factors": {k: self.factors[k] for k in sorted(self.factors)}}

    def load_state(self, state: dict) -> None:
        self.alpha = state.get("alpha", self.alpha)
        self.observations = state.get("observations", 0)
        self.factors = dict(state.get("factors", {}))


# ---------------------------------------------------------------------------
# expert reference implementations (the cuDNN / FA4 analogues on TPU)
# ---------------------------------------------------------------------------

# A strong, hand-chosen static configuration — the "vendor library" baseline.
EXPERT_GENOME = KernelGenome(
    block_q=512, block_k=1024, rescale_mode="branchless",
    mask_mode="block_skip", div_mode="deferred", kv_in_grid=True,
    gqa_pack=False)

# The open-source reference kernel defaults (jax pallas TPU flash-attention
# ships 256/512 tiles) — the FA analogue.
FA_REFERENCE_GENOME = KernelGenome(
    block_q=256, block_k=512, rescale_mode="branchless",
    mask_mode="block_skip", div_mode="deferred", kv_in_grid=True,
    gqa_pack=False)


def expert_reference(cfg: BenchConfig) -> float:
    return estimate(EXPERT_GENOME, cfg).tflops


def fa_reference(cfg: BenchConfig) -> float:
    return estimate(FA_REFERENCE_GENOME, cfg).tflops
