"""The domain-specific knowledge base K (paper §3.1).

In the paper, K contains CUDA programming guides, PTX ISA documentation,
Blackwell specifications, and the FA4 source.  Here K is a structured set of
TPU-v5e facts, each carrying (a) the documentation text the agent "reads" and
(b) an *actionable interpretation*: given the current genome and profiler
feedback, what concrete edits does this fact suggest, and what gain does
napkin math predict?  The agent's competence comes from consulting these
facts against feedback — the facts themselves are straight out of public TPU
performance documentation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.perfmodel import (BRANCH_BUBBLE, GRID_STEP_OVERHEAD, HBM_BW,
                                  PEAK_FLOPS, VMEM_BYTES, VPU_FLOPS,
                                  BenchConfig, vmem_usage)
from repro_torch.core.search_space import (BLOCK_K_CHOICES, BLOCK_Q_CHOICES,
                                     KernelGenome)


@dataclass
class Suggestion:
    edit: dict                    # kwargs for genome.with_()
    rationale: str                # the napkin math, in words
    predicted_gain: float         # predicted fractional improvement (geomean)
    fact_id: str = ""


@dataclass
class Fact:
    id: str
    tags: frozenset               # bottleneck names this fact addresses
    text: str                     # the "documentation" the agent reads
    suggest: Callable             # (genome, score_vector, suite) -> [Suggestion]


def suggestion_sort_key(s: "Suggestion"):
    """Descending predicted gain with a *stable* secondary key on the edit
    repr — equal-gain suggestions must rank identically everywhere (agent
    candidate walk, speculative proposals, prefetch), never in
    dict-insertion-luck order."""
    return (-s.predicted_gain, repr(sorted(s.edit.items())))


def _mean_seq(suite) -> float:
    return sum(c.seq_len for c in suite) / max(len(suite), 1)


def _nearest(choices, value):
    return min(choices, key=lambda c: abs(c - value))


# ---------------------------------------------------------------------------
# fact constructors
# ---------------------------------------------------------------------------


def _f_dma_overlap(g: KernelGenome, sv, suite):
    if g.kv_in_grid:
        return []
    return [Suggestion(
        {"kv_in_grid": True, "div_mode": g.div_mode, },
        "K/V streamed as the innermost grid dimension lets Mosaic double-buffer "
        "the HBM->VMEM DMA against the MXU; the serial staged loop exposes the "
        "full K/V transfer time.",
        0.5, "dma-overlap")]


def _f_block_skip(g: KernelGenome, sv, suite):
    if g.mask_mode == "block_skip":
        return []
    causal_frac = sum(1 for c in suite if c.causal) / max(len(suite), 1)
    return [Suggestion(
        {"mask_mode": "block_skip"},
        "Fully-masked K blocks of a causal/windowed pattern need not be "
        "computed at all; skipping them halves causal compute (the paper's v8 "
        "bitmask-masking analogue).",
        0.5 * causal_frac, "block-skip")]


def _f_branchless(g: KernelGenome, sv, suite):
    if g.rescale_mode == "branchless":
        return []
    # bubble fraction from the profiles
    tb = sum(p.t_bubble for p in sv.profiles.values() if p.feasible)
    tt = sum(p.total_s for p in sv.profiles.values() if p.feasible) or 1.0
    return [Suggestion(
        {"rescale_mode": "branchless"},
        "A predicated region per K-iteration costs a scalar-unit bubble "
        f"(~{BRANCH_BUBBLE * 1e9:.0f} ns) every block; an unconditional "
        "multiply with a select of 1.0 is pure VPU work and removes the bubble "
        "(paper §5.1: branchless accumulator rescaling).",
        tb / tt, "branchless-rescale")]


def _f_deferred_div(g: KernelGenome, sv, suite):
    if g.div_mode == "deferred":
        return []
    return [Suggestion(
        {"div_mode": "deferred"},
        "Keeping the accumulator unnormalized and dividing once in the "
        "epilogue removes ~2*bq*D VPU ops from every K-iteration (FA2-style "
        "deferred normalization).",
        0.05, "deferred-div")]


def _f_block_sizing(g: KernelGenome, sv, suite):
    out = []
    causal = [c for c in suite if c.causal]
    if causal and g.mask_mode == "block_skip":
        s_min = min(c.seq_len for c in causal)
        # causal overshoot fraction ~ (bq+bk)/S; propose the block pair that
        # minimizes overshoot while keeping MXU-aligned 128 multiples
        cur = (g.block_q + g.block_k) / s_min
        for bq in (128, 256, 512):
            for bk in (128, 256, 512):
                if (bq, bk) == (g.block_q, g.block_k):
                    continue
                new = (bq + bk) / s_min
                if new < cur:
                    out.append(Suggestion(
                        {"block_q": bq, "block_k": bk},
                        f"Causal masking wastes ~(bq+bk)/S = {cur:.0%} of MXU "
                        f"work at S={s_min}; ({bq},{bk}) tiles cut the "
                        f"diagonal overshoot to {new:.0%}.",
                        (cur - new) / (2 + cur), "block-sizing-causal"))
    # KV re-streaming: traffic scales with n_q_blocks; bigger bq amortizes
    if g.block_q < 1024:
        nxt = _nearest(BLOCK_Q_CHOICES, g.block_q * 2)
        if nxt != g.block_q:
            out.append(Suggestion(
                {"block_q": nxt},
                "K/V are re-streamed once per q-tile (TPU has no L2); doubling "
                "the q-tile halves KV HBM traffic and per-tile epilogues.",
                0.03, "block-sizing-traffic"))
    if g.block_k < 1024:
        nxt = _nearest(BLOCK_K_CHOICES, g.block_k * 2)
        if nxt != g.block_k:
            out.append(Suggestion(
                {"block_k": nxt},
                "Fewer, larger K blocks reduce per-block softmax-stat updates "
                "and sequencer overhead per pair.",
                0.02, "block-sizing-traffic"))
    return out


def _f_mxu_alignment(g: KernelGenome, sv, suite):
    out = []
    for name, val in (("block_q", g.block_q), ("block_k", g.block_k)):
        if val % 128:
            aligned = _nearest(BLOCK_Q_CHOICES if name == "block_q" else BLOCK_K_CHOICES,
                               128 * max(1, round(val / 128)))
            out.append(Suggestion(
                {name: aligned},
                f"The MXU is a 128x128 systolic array; {name}={val} pads to "
                f"{128 * math.ceil(val / 128)} and wastes "
                f"{1 - val / (128 * math.ceil(val / 128)):.0%} of issue slots.",
                0.1, "mxu-alignment"))
    return out


def _f_vmem_budget(g: KernelGenome, sv, suite):
    worst = max(suite, key=lambda c: vmem_usage(g, c))
    usage = vmem_usage(g, worst)
    out = []
    if usage > VMEM_BYTES:
        if not g.kv_in_grid:
            out.append(Suggestion(
                {"kv_in_grid": True},
                "Staging full K/V in VMEM exceeds the 128 MiB budget at long "
                "sequence; streaming K/V blockwise shrinks the working set to "
                "two double-buffered tiles.",
                0.9, "vmem-budget"))
        for name, choices in (("block_q", BLOCK_Q_CHOICES), ("block_k", BLOCK_K_CHOICES)):
            cur = getattr(g, name)
            smaller = [c for c in choices if c < cur]
            if smaller:
                out.append(Suggestion(
                    {name: smaller[-1]},
                    f"VMEM working set {usage / 2**20:.0f} MiB > 128 MiB; "
                    f"shrink {name} to {smaller[-1]}.",
                    0.9, "vmem-budget"))
    return out


def _f_gqa_pack(g: KernelGenome, sv, suite):
    rep = max((c.n_heads // c.n_kv_heads for c in suite), default=1)
    if rep <= 1 or g.gqa_pack:
        return []
    return [Suggestion(
        {"gqa_pack": True},
        f"{rep} query heads share each KV head; packing them into one q axis "
        "fetches K/V once per group instead of once per q head and feeds the "
        "MXU full tiles (the paper's GQA adaptation, §4.3).",
        0.02 * math.log2(rep), "gqa-pack")]


def _f_unpack_gqa(g: KernelGenome, sv, suite):
    """Packing hurts causal short-seq (wrap-spanning tiles mask conservatively)."""
    rep = max((c.n_heads // c.n_kv_heads for c in suite), default=1)
    if not g.gqa_pack or rep <= 1:
        return []
    s_min = min(c.seq_len for c in suite)
    if g.block_q <= s_min:
        return []
    return [Suggestion(
        {"gqa_pack": False},
        "q-tiles larger than the true sequence span wrap boundaries under "
        "packing and fall back to dense masking; unpack or shrink block_q.",
        0.05, "gqa-unpack")]


def _f_acc_dtype(g: KernelGenome, sv, suite):
    out = []
    if g.acc_dtype == "f32":
        worst = max(suite, key=lambda c: vmem_usage(g, c))
        usage = vmem_usage(g, worst)
        if usage > 0.5 * VMEM_BYTES:
            out.append(Suggestion(
                {"acc_dtype": "bf16"},
                "A bf16 output accumulator halves the acc VMEM tile, freeing "
                "budget for larger K/V double-buffers.  (On paper; the online "
                "softmax accumulates hundreds of partial products — watch the "
                "correctness gate.)",
                0.02, "acc-dtype"))
    else:
        out.append(Suggestion(
            {"acc_dtype": "f32"},
            "bf16 accumulation loses ~16 mantissa bits across the K loop; "
            "restore f32 if correctness fails.",
            0.0, "acc-dtype"))
    return out


FACTS: list[Fact] = [
    Fact("acc-dtype", frozenset({"vmem", "dma"}),
         "Accumulator precision trades VMEM footprint against rounding error "
         "accumulated once per K block.", _f_acc_dtype),
    Fact("dma-overlap", frozenset({"dma"}),
         "TPU DMA engines run asynchronously; Pallas grid dimensions marked "
         "'arbitrary' are executed sequentially with automatic double-buffered "
         "block DMA, overlapping HBM transfers with compute.", _f_dma_overlap),
    Fact("block-skip", frozenset({"mxu"}),
         "For causal or sliding-window masks, K blocks wholly outside the mask "
         "contribute nothing; the block index range intersecting the mask can "
         "be computed from the tile coordinates.", _f_block_skip),
    Fact("branchless-rescale", frozenset({"bubble", "vpu"}),
         "TPU is a vector machine: data-dependent branches serialize through "
         "the scalar unit. Predicated selects (jnp.where) keep the VPU "
         "pipeline full; an unconditional multiply-by-one is ~free.", _f_branchless),
    Fact("deferred-div", frozenset({"vpu"}),
         "The online-softmax accumulator may stay unnormalized across "
         "K iterations; a single epilogue division replaces per-iteration "
         "normalization.", _f_deferred_div),
    Fact("block-sizing", frozenset({"mxu", "dma", "overhead"}),
         "Tile shape trades VMEM footprint against HBM re-streaming, diagonal "
         "mask overshoot ((bq+bk)/S of causal compute), and sequencer "
         "overhead per grid step.", _f_block_sizing),
    Fact("mxu-alignment", frozenset({"mxu"}),
         "MXU matmul tiles pad every dimension to multiples of 128; unaligned "
         "block shapes waste issue slots proportionally.", _f_mxu_alignment),
    Fact("vmem-budget", frozenset({"vmem"}),
         "VMEM is 128 MiB per core; a kernel whose blocks+scratch exceed it "
         "fails to compile.", _f_vmem_budget),
    Fact("gqa-pack", frozenset({"dma", "mxu", "overhead"}),
         "Grouped-query attention shares each KV head across G query heads; "
         "processing the group's queries against one KV stream amortizes "
         "traffic and fills MXU rows.", _f_gqa_pack),
    Fact("gqa-unpack", frozenset({"mxu"}),
         "Packed q axes wrap sequence boundaries; tiles spanning a wrap must "
         "mask conservatively.", _f_unpack_gqa),
]


class KnowledgeBase:
    def __init__(self, facts=None):
        self.facts = list(facts) if facts is not None else list(FACTS)
        self.n_consults = 0

    def consult(self, *tags: str, count: bool = True) -> list[Fact]:
        """Facts relevant to the given bottleneck tags (paper: the agent
        'consults documentation to understand the relevant constraints').
        ``count=False`` is the speculative path (proposal/prefetch sizing):
        same facts, no accounting — speculation must not inflate the agent's
        consult statistics."""
        if count:
            self.n_consults += 1
        tagset = set(tags)
        hits = [f for f in self.facts if f.tags & tagset]
        return hits if hits else list(self.facts)

    def suggestions(self, genome: KernelGenome, sv, suite, *tags,
                    count: bool = True) -> list:
        out = []
        for fact in self.consult(*tags, count=count):
            for s in fact.suggest(genome, sv, suite):
                s.fact_id = s.fact_id or fact.id
                out.append(s)
        # deduplicate identical edits, keep max predicted gain.  NOTE: ties
        # on predicted_gain keep fact-registration order (the facts list is
        # deterministic, and e.g. the repair path relies on vmem-budget
        # emitting kv_in_grid first) — use ``suggestion_sort_key`` only where
        # ordering is pure speculation (prefetch).
        seen = {}
        for s in out:
            k = tuple(sorted(s.edit.items()))
            if k not in seen or s.predicted_gain > seen[k].predicted_gain:
                seen[k] = s
        return sorted(seen.values(), key=lambda s: -s.predicted_gain)

    def gain_profile(self, genome: KernelGenome, sv, suite, *tags) -> list:
        """Descending predicted-gain distribution of the current suggestions
        (uncounted).  This is the signal the speculative-prefetch budget
        allocator sizes per-island batches from: a front-loaded profile means
        the top candidate will likely commit (shallow speculation suffices),
        a flat/low one means the agent will walk deep."""
        return [s.predicted_gain
                for s in self.suggestions(genome, sv, suite, *tags,
                                          count=False)]
