"""Variation operators.

``AgenticVariationOperator`` — the paper's contribution: the whole of
Sample+Generate+evaluation subsumed by one autonomous agent run (Eq. 4).

Baselines (Fig. 1 left, for the operator-comparison benchmark):
  ``SingleShotMutation``      FunSearch/AlphaEvolve-style: framework samples a
                              parent (score-weighted), the "LLM" emits ONE
                              candidate, no feedback loop, no repair.
  ``PlanExecuteSummarize``    LoongFlow-style fixed pipeline: one plan (read a
                              profile), one execute (apply the top suggestion),
                              one summarize (record the outcome) — rigid
                              three-phase workflow, no iterative repair.
"""
from __future__ import annotations

import math
import random
from typing import Optional

from repro_torch.core.agent import AgentPolicy, Directive, ScriptedAgent, VariationResult
from repro_torch.core.search_space import KernelGenome, seed_genome
from repro_torch.core.toolbelt import Toolbelt


class AgenticVariationOperator:
    """Vary(P_t) = Agent(P_t, K, f)."""

    name = "AVO"

    def __init__(self, policy: Optional[AgentPolicy] = None):
        self.policy = policy or ScriptedAgent()

    def vary(self, tools: Toolbelt, directive: Directive = Directive()
             ) -> VariationResult:
        return self.policy.run_variation(tools, directive)

    def propose(self, tools: Toolbelt, directive: Directive = Directive()
                ) -> list:
        """Speculative proposal surface for the pipelined engine: the genomes
        the next :meth:`vary` call is likely to evaluate, in walk order.
        Pure — never mutates search state (see ScriptedAgent.propose_candidates)."""
        proposer = getattr(self.policy, "propose_candidates", None)
        return proposer(tools, directive) if proposer is not None else []


class SingleShotMutation:
    """Vary(P_t) = Generate(Sample(P_t)) with a single-turn generator."""

    name = "single-shot"

    def __init__(self, temperature: float = 20.0, seed: int = 0):
        self.temperature = temperature
        self.rng = random.Random(seed)

    def _sample_parent(self, tools: Toolbelt) -> KernelGenome:
        commits = tools.lineage.commits
        if not commits:
            return seed_genome()
        ws = [math.exp(c.geomean / self.temperature) for c in commits]
        return self.rng.choices(commits, weights=ws, k=1)[0].genome

    def vary(self, tools: Toolbelt, directive: Directive = Directive()
             ) -> VariationResult:
        parent = self._sample_parent(tools)
        if not tools.lineage.commits:
            sv = tools.evaluate(parent)
            ok = sv.correct and sv.geomean > 0
            return VariationResult(parent, sv, ok, "seed", 1,
                                   [("single-shot", "seed")])
        cand = self.rng.choice(list(parent.neighbors()))
        sv = tools.evaluate(cand)
        best = tools.best_commit()
        committed = sv.correct and sv.geomean > best.geomean
        return VariationResult(
            cand, sv, committed,
            f"random single-field mutation {parent.diff(cand)}", 1,
            [("single-shot", str(parent.diff(cand)))])

    def propose(self, tools: Toolbelt, directive: Directive = Directive()
                ) -> list:
        """No speculation: the candidate depends on this operator's private
        RNG, and peeking would advance it (changing the search)."""
        return []


class PlanExecuteSummarize:
    """Fixed three-phase pipeline: the LLM-ish step is confined to each phase."""

    name = "plan-execute-summarize"

    def __init__(self):
        self.summaries: list[str] = []

    def vary(self, tools: Toolbelt, directive: Directive = Directive()
             ) -> VariationResult:
        trace = []
        best = tools.best_commit()
        if best is None:
            g0 = seed_genome()
            sv = tools.evaluate(g0)
            ok = sv.correct and sv.geomean > 0
            return VariationResult(g0, sv, ok, "seed", 1, [("pes", "seed")])
        # PLAN: one profile read, one bottleneck
        sv0 = tools.evaluate(best.genome)
        bn = sv0.dominant_bottleneck()
        trace.append(("plan", bn))
        # EXECUTE: apply the single top suggestion — no retry, no repair
        sugg = tools.consult_kb(best.genome, sv0, bn)
        sugg = [s for s in sugg if not tools.is_refuted(best.genome, s.edit)]
        if not sugg:
            return VariationResult(None, None, False, "plan found no edit", 1, trace)
        cand = best.genome.with_(**sugg[0].edit)
        sv = tools.evaluate(cand)
        committed = sv.correct and sv.geomean > best.geomean
        # SUMMARIZE
        outcome = "improved" if committed else "failed"
        self.summaries.append(f"{sugg[0].fact_id}: {sugg[0].edit} -> {outcome}")
        if not committed:
            tools.remember_refuted(best.genome, sugg[0].edit, outcome)
        trace.append(("summarize", self.summaries[-1]))
        return VariationResult(cand, sv, committed,
                               f"PES {sugg[0].fact_id}: {sugg[0].edit}", 1, trace)

    def propose(self, tools: Toolbelt, directive: Directive = Directive()
                ) -> list:
        """Mirror the pipeline's single execute step: the top unrefuted
        suggestion for the current dominant bottleneck (pure speculation)."""
        best = tools.lineage.best()
        if best is None:
            return [seed_genome()]
        sv = tools.scorer(best.genome)       # cached since its commit
        if not sv.correct:
            return []
        sugg = tools.kb.suggestions(best.genome, sv, tools.scorer.suite,
                                    sv.dominant_bottleneck(), count=False)
        sugg = [s for s in sugg if not tools.is_refuted(best.genome, s.edit)]
        return [best.genome.with_(**sugg[0].edit)] if sugg else []


def make_operator(spec="avo", seed: int = 0, agent_kwargs: Optional[dict] = None):
    """Operator registry: build a variation operator from a spec string
    ('avo' | 'single-shot' | 'pes') or pass an instance through unchanged.
    Used by the island engine to mix operators across islands."""
    if not isinstance(spec, str):
        return spec
    name = spec.lower().replace("_", "-")
    if name in ("avo", "agentic"):
        return AgenticVariationOperator(ScriptedAgent(**(agent_kwargs or {})))
    if name in ("single-shot", "singleshot"):
        return SingleShotMutation(seed=seed)
    if name in ("pes", "plan-execute-summarize"):
        return PlanExecuteSummarize()
    raise ValueError(f"unknown operator spec {spec!r}; "
                     "known: avo, single-shot, pes")
