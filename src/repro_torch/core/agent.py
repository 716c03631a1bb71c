"""The AVO agent: ``Vary(P_t) = Agent(P_t, K, f)`` (paper Eq. 4).

``AgentPolicy`` is the pluggable seam: the paper uses a frontier-LLM coding
agent; this container has no LLM, so ``ScriptedAgent`` implements the same
autonomous loop deterministically — plan from profiler feedback, consult the
knowledge base, implement an edit, evaluate, diagnose failures, repair, and
commit only on improvement.  An LLM-backed policy would subclass AgentPolicy
and reuse the identical Toolbelt.

A single variation step (paper §3.2) may involve many internal actions; the
trace of every action is returned for auditability.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.evals import ScoreVector
from repro_torch.core.search_space import KernelGenome, seed_genome
from repro_torch.core.toolbelt import Toolbelt


@dataclass
class Directive:
    """Supervisor steering injected into a variation step (paper §3.3)."""
    kind: str = "none"            # none | explore | refocus
    note: str = ""
    focus_tags: tuple = ()
    exploration_depth: int = 0


@dataclass
class VariationResult:
    genome: Optional[KernelGenome]
    score: Optional[ScoreVector]
    committed: bool
    note: str
    internal_attempts: int
    trace: list = field(default_factory=list)


class AgentPolicy:
    """Interface of the variation operator's policy."""

    def run_variation(self, tools: Toolbelt, directive: Directive) -> VariationResult:
        raise NotImplementedError


class ScriptedAgent(AgentPolicy):
    """Deterministic agentic loop: plan -> consult -> edit -> evaluate ->
    diagnose -> (repair | commit)."""

    def __init__(self, max_inner_steps: int = 12, max_repairs: int = 3,
                 min_rel_improvement: float = 1e-4,
                 seed: Optional[KernelGenome] = None):
        self.max_inner_steps = max_inner_steps
        self.max_repairs = max_repairs
        self.min_rel = min_rel_improvement
        self.seed = seed          # adaptation starting point (e.g. GQA transfer)

    # -- helpers -----------------------------------------------------------------
    def _plan(self, tools: Toolbelt, directive: Directive, trace):
        """Examine the lineage + profile, decide what to attack."""
        best = tools.best_commit()
        if best is None:
            g0 = self.seed if self.seed is not None else seed_genome()
            trace.append(("plan", "no lineage; start from seed genome"))
            return g0, tools.evaluate(g0), ("mxu", "dma", "bubble")
        sv = tools.evaluate(best.genome)     # cached
        prof = tools.profile(sv)
        bn = sv.dominant_bottleneck()
        trace.append(("plan", f"best v{best.version} geomean={best.geomean:.1f} "
                              f"TFLOPS; dominant bottleneck: {bn}"))
        tags = directive.focus_tags if directive.kind == "refocus" else (bn,)
        return best.genome, sv, tags

    def _ranked_suggestions(self, consult, is_refuted, genome, sv, tags,
                            directive):
        """The single source of candidate ordering, shared by the authoritative
        variation walk and the speculative proposal phase.  ``consult`` is the
        suggestion source (the Toolbelt's counted call in a real step, the
        KB's uncounted one when speculating); everything downstream is pure."""
        from repro_torch.core.knowledge import Suggestion
        sugg = consult(genome, sv, *tags)
        if directive.kind in ("explore", "refocus"):
            # widen: pull suggestions for every bottleneck
            extra = consult(genome, sv, "mxu", "vpu", "dma",
                            "overhead", "bubble", "vmem")
            seen = {tuple(sorted(s.edit.items())) for s in sugg}
            sugg += [s for s in extra if tuple(sorted(s.edit.items())) not in seen]
            # fresh perspective: compose compound edits from suggestion pairs
            singles = sugg[:6]
            for a in range(len(singles)):
                for b in range(a + 1, len(singles)):
                    ed = dict(singles[a].edit)
                    if any(k in ed for k in singles[b].edit):
                        continue
                    ed.update(singles[b].edit)
                    sugg.append(Suggestion(
                        ed, f"compound: {singles[a].fact_id}+{singles[b].fact_id}",
                        0.5 * (singles[a].predicted_gain + singles[b].predicted_gain),
                        "compound"))
        if directive.kind == "explore":
            # re-examine previously refuted edits with fresh eyes — the search
            # context (profile shape) has moved since they were recorded
            filtered = sugg
        else:
            filtered = [s for s in sugg if not is_refuted(genome, s.edit)]
        # ties keep KB order (fact-registration order): the authoritative
        # walk and its speculative preview share this exact ranking
        return sorted(filtered, key=lambda s: -s.predicted_gain)

    def _candidates(self, tools: Toolbelt, genome, sv, tags, directive, trace):
        if directive.kind in ("explore", "refocus"):
            trace.append(("explore", directive.note))
        filtered = self._ranked_suggestions(tools.consult_kb, tools.is_refuted,
                                            genome, sv, tags, directive)
        trace.append(("consult", f"{len(filtered)} candidate edits after memory filter"))
        return filtered

    # -- the speculative proposal phase (pipelined engine) ------------------------
    def propose_candidates(self, tools: Toolbelt,
                           directive: Directive = Directive()
                           ) -> list[KernelGenome]:
        """The genomes the next :meth:`run_variation` call is likely to
        evaluate, in its exact walk order — what the pipelined engine's
        proposal phase submits to the evaluation backend ahead of the harvest.

        Pure speculation: no trace, no tool-call accounting, no memory writes
        — mis-speculation (e.g. a migrant landing between propose and harvest)
        can only waste evaluations, never change the search."""
        best = tools.lineage.best()
        if best is None:
            return [self.seed if self.seed is not None else seed_genome()]
        sv = tools.scorer(best.genome)       # cached since its commit
        if not sv.correct:
            return []
        tags = (directive.focus_tags if directive.kind == "refocus"
                else (sv.dominant_bottleneck(),))

        def consult(genome, s, *t):
            return tools.kb.suggestions(genome, s, tools.scorer.suite, *t,
                                        count=False)

        ranked = self._ranked_suggestions(consult, tools.is_refuted,
                                          best.genome, sv, tags, directive)
        return [best.genome.with_(**s.edit)
                for s in ranked[:self.max_inner_steps]]

    def _repair(self, tools: Toolbelt, genome, failure, trace):
        """Diagnose an infeasible/incorrect candidate and fix it."""
        g = genome
        for _ in range(self.max_repairs):
            if "VMEM" in failure or "infeasible" in failure:
                sugg = tools.consult_kb(g, tools.evaluate(g), "vmem")
                if not sugg:
                    return None
                g = g.with_(**sugg[0].edit)
                trace.append(("repair", f"VMEM repair: {sugg[0].edit}"))
            else:
                trace.append(("diagnose", f"unrepairable failure: {failure[:80]}"))
                return None
            sv = tools.evaluate(g)
            if sv.correct and sv.geomean > 0:
                return g
            failure = sv.failure
        return None

    def _gain(self, tools: Toolbelt, parent: KernelGenome, parent_sv: ScoreVector,
              cand: KernelGenome, sv: ScoreVector) -> float:
        """The gain the commit decision reads: the candidate's geomean over
        the incumbent's, minus 1."""
        return sv.geomean / parent_sv.geomean - 1.0

    # -- the variation step --------------------------------------------------------
    def run_variation(self, tools: Toolbelt, directive: Directive = Directive()
                      ) -> VariationResult:
        trace: list = []
        parent, parent_sv, tags = self._plan(tools, directive, trace)
        if tools.best_commit() is None:
            # bootstrap: commit the seed (v0) if it is correct
            if parent_sv.correct and parent_sv.geomean > 0:
                return VariationResult(parent, parent_sv, True,
                                       "seed genome x0 (naive but correct)",
                                       1, trace)
            return VariationResult(None, parent_sv, False,
                                   f"seed failed: {parent_sv.failure}", 1, trace)

        best_geo = parent_sv.geomean
        candidates = self._candidates(tools, parent, parent_sv, tags,
                                      directive, trace)
        attempts = 0
        best_attempt: Optional[tuple] = None

        for s in candidates:
            if attempts >= self.max_inner_steps:
                break
            attempts += 1
            cand = parent.with_(**s.edit)
            trace.append(("edit", f"{s.fact_id}: {s.edit} "
                                  f"(predicted {s.predicted_gain:+.1%}) — {s.rationale[:100]}"))
            sv = tools.evaluate(cand)
            if not sv.correct:
                trace.append(("eval", f"correctness FAILED: {sv.failure[:90]}"))
                repaired = self._repair(tools, cand, sv.failure, trace)
                tools.remember_refuted(parent, s.edit, sv.failure[:60])
                if repaired is None:
                    continue
                cand, sv = repaired, tools.evaluate(repaired)
                attempts += 1
            if sv.geomean <= 0:
                repaired = self._repair(tools, cand, sv.failure, trace)
                tools.remember_refuted(parent, s.edit, "infeasible")
                if repaired is None:
                    continue
                cand, sv = repaired, tools.evaluate(repaired)
                attempts += 1
            unpaired = sv.geomean / best_geo - 1.0
            gain = self._gain(tools, parent, parent_sv, cand, sv)
            # a policy that decides on another gain shows both
            shown = (f"{gain:+.2%}" if gain == unpaired else
                     f"paired {gain:+.2%}, unpaired {unpaired:+.2%}")
            trace.append(("eval", f"geomean {sv.geomean:.1f} TFLOPS ({shown}); "
                                  f"predicted {s.predicted_gain:+.1%} -> "
                                  f"{'CONFIRMED' if gain > 0 else 'REFUTED'}"))
            if gain > self.min_rel:
                note = f"{s.fact_id}: {s.edit} ({gain:+.2%} geomean)"
                return VariationResult(cand, sv, True, note, attempts, trace)
            tools.remember_refuted(parent, s.edit,
                                   f"regressed/flat ({gain:+.2%})")
            if best_attempt is None or sv.geomean > best_attempt[1].geomean:
                best_attempt = (cand, sv)

        # exhausted budget without improvement
        if best_attempt is not None:
            g, sv = best_attempt
            return VariationResult(g, sv, False,
                                   "no improving edit found this step",
                                   attempts, trace)
        return VariationResult(None, None, False,
                               "no viable candidates", attempts, trace)
