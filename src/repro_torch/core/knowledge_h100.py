"""The knowledge base K for the card: Hopper facts about the port's own
flash-attention kernel (``kernels/csrc/flash_attention.cu``).

``core/knowledge.py`` keeps the reference's TPU facts verbatim, for lineage
parity with the JAX package.  :data:`HOPPER_FACTS` has one counterpart for
each of them, with the same ids, the same :class:`Fact` / :class:`Suggestion`
types and the tags :meth:`ScoreVector.dominant_bottleneck` returns (``vmem``
for the repair path).  Each fact's text speaks of the H100 and of this
kernel; the readings it cites are ``chip_smoke.py``'s ``evolve`` and ``gqa``
lines on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).

A suggestion's ``predicted_gain`` is the H100 model's own napkin math
(``core/perfmodel_h100.py``): the geomean over the suite of the edited
genome's modelled TFLOP/s over the current genome's, minus 1.  A fact
suggests an edit only where it changes what the card runs and the model
sees it change the time; an edit the model predicts to lose is still
suggested, ranked below the rest.

The facts reach the agent through ``KnowledgeBase(facts=HOPPER_FACTS)``;
:func:`knowledge_for` picks the facts of the machine the scorer plans from.
"""
from __future__ import annotations

import functools
import math

from repro_torch.core import perfmodel_h100
from repro_torch.core.knowledge import Fact, KnowledgeBase, Suggestion
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.core.search_space import KernelGenome

# the tile of the wgmma body: 128 query rows (two warpgroups of 64), chunks
# of 128 keys
TILE = perfmodel_h100.WGMMA.rows


@functools.lru_cache(maxsize=8192)
def _tflops(g: KernelGenome, cfg: BenchConfig) -> float:
    p = perfmodel_h100.estimate(g, cfg)
    return p.tflops if p.feasible else 0.0


def _geomean(g: KernelGenome, suite) -> float:
    vals = [_tflops(g, c) for c in suite]
    if not vals or any(v <= 0 for v in vals):
        return 0.0
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def model_gain(g: KernelGenome, edit: dict, suite) -> float:
    """The H100 model's predicted fractional gain of ``edit`` on ``suite``:
    geomean ratio of the edited genome to ``g``, minus 1.  From an
    infeasible ``g`` any feasible edit counts as +100 %."""
    cur, new = _geomean(g, suite), _geomean(g.with_(**edit), suite)
    if cur <= 0:
        return 1.0 if new > 0 else 0.0
    return new / cur - 1.0


def _suggest(g, suite, edit, rationale, fact_id) -> list:
    """``[Suggestion]`` with the model's gain, or ``[]`` where the edit is a
    no-op or the model sees no change."""
    if g.with_(**edit) == g:
        return []
    gain = model_gain(g, edit, suite)
    if gain == 0.0:
        return []
    return [Suggestion(edit, rationale, gain, fact_id)]


def _rep(suite) -> int:
    return max((c.n_heads // c.n_kv_heads for c in suite), default=1)


# ---------------------------------------------------------------------------
# fact constructors
# ---------------------------------------------------------------------------


def _f_acc_dtype(g: KernelGenome, sv, suite):
    if g.acc_dtype == "f32":
        return []        # a bf16 accumulator saves nothing and fails the gate
    return _suggest(g, suite, {"acc_dtype": "f32"},
                    "The accumulator lives in the consumers' registers either "
                    "way; f32 passes the gate and drops the bf16 rounding at "
                    "every logical block end.", "acc-dtype")


def _f_dma_overlap(g: KernelGenome, sv, suite):
    if g.kv_in_grid:
        return []
    return _suggest(g, suite, {"kv_in_grid": True, "div_mode": "deferred"},
                    "The single stage waits for every K/V chunk and runs both "
                    "consumer warpgroups in lockstep; the 2-stage TMA ring "
                    "loads the next chunk under the products and lets one "
                    "consumer's softmax run under the other's wgmma.  The "
                    "division stays at the end, as the loop body has it.",
                    "dma-overlap")


def _f_block_skip(g: KernelGenome, sv, suite):
    if g.mask_mode == "block_skip":
        return []
    return _suggest(g, suite, {"mask_mode": "block_skip"},
                    "Dense masking visits every K chunk and masks every score; "
                    "block_skip visits only chunks the causal or window mask "
                    "touches and drops the mask arithmetic on the FP32 cores "
                    "off every fully visible chunk.", "block-skip")


def _f_branchless(g: KernelGenome, sv, suite):
    if g.rescale_mode == "branchless" or not g.kv_in_grid:
        return []        # the loop body rescales without a branch anyway
    return _suggest(g, suite, {"rescale_mode": "branchless"},
                    "The branched rescale is one warp vote a chunk; it skips "
                    "the accumulator multiply only when no row of the warp "
                    "raised its max.  Branchless always multiplies.",
                    "branchless-rescale")


def _f_deferred_div(g: KernelGenome, sv, suite):
    if g.div_mode == "deferred" or not g.kv_in_grid:
        return []        # the loop body divides at the end anyway
    return _suggest(g, suite, {"div_mode": "deferred"},
                    "Eager division scales P by 1/l every chunk on the FP32 "
                    "cores, in series with the consumer's wgmma; deferred "
                    "divides the accumulator once at the end.", "deferred-div")


def _f_block_sizing(g: KernelGenome, sv, suite):
    out = []
    edits = [{"block_q": TILE}, {"block_k": TILE},
             {"block_q": TILE, "block_k": TILE}]
    for edit in edits:
        if all(getattr(g, k) > v for k, v in edit.items()):
            out += _suggest(g, suite, edit,
                            "Logical blocks run on a fixed 128x128 tile; one "
                            "larger than 128 only widens the diagonal band "
                            "of masked chunks under causal or window masks.  "
                            "K/V stay in the 50 MB L2, so larger blocks save "
                            "no HBM traffic.", "block-sizing")
    return out


def _f_mxu_alignment(g: KernelGenome, sv, suite):
    if g.block_q % TILE == 0:
        return []
    return _suggest(g, suite, {"block_q": TILE},
                    f"block_q={g.block_q} puts two logical blocks in one CTA "
                    "of 128 rows (two 64-row wgmma warpgroups); the CTA walks "
                    "the union of their chunks and masks where either needs "
                    "it.", "mxu-alignment")


def _f_vmem_budget(g: KernelGenome, sv, suite):
    worst = max(suite, key=lambda c: perfmodel_h100.smem_bytes(g, c))
    usage = perfmodel_h100.smem_bytes(g, worst)
    if usage <= perfmodel_h100.SMEM_PER_BLOCK or not g.kv_in_grid:
        return []
    return _suggest(g, suite, {"kv_in_grid": False},
                    f"Shared memory {usage / 1024:.0f} KB exceeds the 227 KB "
                    "a block may opt into; one K/V stage instead of two "
                    "frees one stage's tiles.", "vmem-budget")


def _f_gqa_pack(g: KernelGenome, sv, suite):
    if _rep(suite) <= 1 or g.gqa_pack:
        return []
    return _suggest(g, suite, {"gqa_pack": True},
                    f"{_rep(suite)} query heads share each KV head, and the "
                    "heads of a group run together, so L2 already serves "
                    "their K/V once from HBM; packing changes the tiling and "
                    "the wrap masks, not the HBM bytes.", "gqa-pack")


def _f_unpack_gqa(g: KernelGenome, sv, suite):
    if not g.gqa_pack or _rep(suite) <= 1:
        return []
    return _suggest(g, suite, {"gqa_pack": False},
                    "Packed rows take positions modulo S: the loop body then "
                    "drops its block_skip bounds, and a logical block that "
                    "spans a wrap masks every chunk.", "gqa-unpack")


HOPPER_FACTS: list[Fact] = [
    Fact("acc-dtype", frozenset({"vmem"}),
         "The fp32 accumulator lives in the consumer warpgroups' registers "
         "(232 each after setmaxnreg), not in shared memory: a bf16 "
         "accumulator frees no shared memory and fails the gate.",
         _f_acc_dtype),
    Fact("dma-overlap", frozenset({"dma", "vpu"}),
         "With kv_in_grid the producer warpgroup keeps a 2-stage TMA ring "
         "one chunk ahead of the consumers; the single stage reloads only "
         "after both consumers release it, so each chunk waits for its load "
         "and the consumers run in lockstep (measured: +31.5 to +35.5 % "
         "geomean on mha_suite).", _f_dma_overlap),
    Fact("block-skip", frozenset({"mxu", "vpu"}),
         "block_skip walks only the K chunks a causal or window mask "
         "touches and masks only the diagonal ones; dense masking costs "
         "FP32-core work on every score (measured: +104 % geomean with "
         "branchless rescaling).", _f_block_skip),
    Fact("branchless-rescale", frozenset({"bubble", "vpu"}),
         "The branched rescale is a warp-uniform vote a chunk (__any_sync), "
         "with no divergence; the loop body ignores it.  Its only effect is "
         "the skipped multiply (measured: -0.98 % and +1.83 %, within the "
         "noise).", _f_branchless),
    Fact("deferred-div", frozenset({"vpu"}),
         "Eager division scales P by 1/l every chunk, in series with the "
         "consumer's wgmma on the same warps; deferred divides once at the "
         "end (measured: +13.0 to +13.9 % geomean).", _f_deferred_div),
    Fact("block-sizing", frozenset({"mxu", "vpu", "overhead"}),
         "block_q and block_k are logical: the physical tile is fixed at "
         "128 rows by 128 keys, so a larger logical block only adds masked "
         "diagonal chunks.  The 50 MB L2 holds each head's K/V while its "
         "CTAs run, so larger blocks re-stream nothing less (measured: "
         "block_q 256 -2.59 to -6.13 %, block_k 256 -0.74 to -4.51 %).",
         _f_block_sizing),
    Fact("mxu-alignment", frozenset({"mxu"}),
         "wgmma issues m64n128k16 per warpgroup; a CTA holds two 64-row "
         "warpgroups, so block_q below 128 splits the CTA between two "
         "logical blocks without changing the tile.", _f_mxu_alignment),
    Fact("vmem-budget", frozenset({"vmem"}),
         "A CTA may opt into 227 KB of shared memory on the H100; the wgmma "
         "body takes Q (32 KB) plus 64 KB per K/V stage at head_dim 128, so "
         "every genome fits.", _f_vmem_budget),
    Fact("gqa-pack", frozenset({"dma", "mxu", "overhead"}),
         "Under GQA the rep query heads of a KV head run in neighbouring "
         "CTAs and read its K/V through L2; packing them into one row axis "
         "changes the tiling and the wrap masks, not the HBM bytes (measured: "
         "-2.50 % and -3.08 %).", _f_gqa_pack),
    Fact("gqa-unpack", frozenset({"mxu", "overhead"}),
         "Packed rows use positions modulo S: a logical block across a wrap "
         "masks all of it, and the loop body's block_skip bounds need an "
         "unpacked axis.", _f_unpack_gqa),
]


def knowledge_for(machine: str) -> KnowledgeBase:
    """A fresh knowledge base of ``machine``'s facts: Hopper facts for
    ``"h100"``, the reference's TPU facts for ``"tpu_v5e"``."""
    if machine == "h100":
        return KnowledgeBase(facts=HOPPER_FACTS)
    if machine == "tpu_v5e":
        return KnowledgeBase()
    raise ValueError(f"unknown machine {machine!r}; known: tpu_v5e, h100")
