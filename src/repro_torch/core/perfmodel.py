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

The columnar ``estimate_batch``, the modelled measured timer and its
calibration, and the reference genomes are not copied: the serial inline
loop never calls them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.search_space import KernelGenome

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
