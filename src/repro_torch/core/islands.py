"""One island of the evolution: a lineage with its operator, supervisor and
toolbelt (the subset of ``repro.core.islands`` that the serial loop runs).

``ContinuousEvolution`` (evolution.py) drives exactly one :class:`Island`.
The archipelago, migration, the prefetch allocator and the evaluation
cascade come with later slices.  Candidate evaluation goes through the
scorer the island is given; determinism holds as in the reference: the
operator is seeded and the scorer is a deterministic function of the genome
at rung 0.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.core import obs
from repro_torch.core.knowledge import KnowledgeBase, suggestion_sort_key
from repro_torch.core.population import Commit, Lineage
from repro_torch.core.supervisor import Supervisor
from repro_torch.core.toolbelt import Toolbelt
from repro_torch.core.variation import make_operator

@dataclass
class EvolutionReport:
    commits: int
    steps: int
    internal_attempts: int
    interventions: int
    tool_stats: dict
    best_geomean: float
    wall_seconds: float
    traces: list = field(default_factory=list)



class Island:
    """One lineage + its operator, supervisor, and toolbelt.

    ``ContinuousEvolution`` wraps exactly one of these.
    """

    def __init__(self, name: str, scorer, operator=None,
                 supervisor: Optional[Supervisor] = None,
                 lineage: Optional[Lineage] = None,
                 kb: Optional[KnowledgeBase] = None,
                 memory=None,
                 persist_path: Optional[str] = None,
                 on_commit: Optional[Callable] = None,
                 prefetch_k: int = 0,
                 pipeline: bool = False):
        self.name = name
        self.scorer = scorer
        self.lineage = lineage if lineage is not None else Lineage()
        self.kb = kb or KnowledgeBase()
        self.tools = Toolbelt(scorer, self.kb, self.lineage, memory=memory)
        self.operator = operator or make_operator("avo")
        self.supervisor = supervisor or Supervisor()
        self.persist_path = persist_path
        self.on_commit = on_commit
        self.prefetch_k = prefetch_k
        # allocator-assigned speculation cap: None = no budget configured
        # (propose the full walk); 0 is a real allocation meaning "none" —
        # distinct from prefetch_k, whose 0 means "feature off"
        self.prefetch_cap: Optional[int] = None
        self.pipeline = pipeline
        self.steps = 0
        self.internal_attempts = 0
        self.migrants_accepted = 0
        self.proposed = 0             # speculative submissions (pipelined)
        self.traces: list[dict] = []
        # eval-lifecycle trace: minted at propose, consumed by the next
        # harvest so the speculative batch and the authoritative walk stitch
        # under one id (None while obs is disabled — zero-cost)
        self._last_trace = None
        # per-operator acceptance credit (the ROADMAP self-tuning-variation
        # item's demand signal): registry instruments, shared across engines
        # by (island, operator) label
        op = getattr(self.operator, "name", type(self.operator).__name__)
        self._m_steps = obs.REGISTRY.counter(
            "island_steps", island=name, operator=op)
        self._m_commits = obs.REGISTRY.counter(
            "operator_commits", island=name, operator=op)
        self._m_rejects = obs.REGISTRY.counter(
            "operator_rejects", island=name, operator=op)

    # -- the proposal phase (pipelined stepping) ----------------------------------
    def _prefetch_candidates(self) -> None:
        """Speculatively warm the shared scorer cache with the KB's top edit
        candidates for the current best — pure cache warming on the batch
        executor, so search behaviour (and determinism) is untouched."""
        best = self.lineage.best()
        if best is None or not hasattr(self.scorer, "prefetch"):
            return
        sv = self.scorer(best.genome)                 # cached
        sugg = self.kb.suggestions(best.genome, sv, self.scorer.suite,
                                   sv.dominant_bottleneck(), count=False)
        # stable secondary key: equal-gain suggestions must prefetch in a
        # deterministic order, not dict-insertion-luck order
        sugg = sorted(sugg, key=suggestion_sort_key)[:self.prefetch_k]
        self.scorer.prefetch([best.genome.with_(**s.edit) for s in sugg])

    def propose(self) -> int:
        """Proposal phase: submit the evaluations the next :meth:`harvest` is
        likely to walk onto the backend's async surface, so workers score the
        whole candidate batch concurrently while the harvest walks it in
        order.  Pure speculation — never mutates search state, so calling it
        is always safe (and calling it twice, e.g. once before the epoch
        barrier and again at step start after a migrant landed, just re-syncs
        the speculation to the new lineage; duplicates collapse in the
        backend).  Returns the number of submissions actually enqueued."""
        proposer = getattr(self.operator, "propose", None)
        if proposer is None or not getattr(self.scorer, "overlapping", False):
            return 0
        cap = self.prefetch_cap       # allocator budget; an allocated 0 MEANS 0
        if cap is None and self.prefetch_k:
            cap = self.prefetch_k     # static prefetch constant caps us too
        if cap == 0:
            return 0
        directive = self.supervisor.peek(self.lineage)
        genomes = proposer(self.tools, directive)
        if cap is not None:
            genomes = genomes[:cap]
        if obs.enabled():
            # mint the eval-lifecycle trace here: the speculative submits
            # inherit it thread-locally, and the next harvest reuses it so
            # propose -> submit -> dispatch -> worker -> harvest stitch
            tr = self._last_trace = obs.new_trace()
            with obs.use_trace(tr):
                n = self.tools.submit_evaluations(genomes)
            obs.span("propose", tr, island=self.name, n=n)
        else:
            n = self.tools.submit_evaluations(genomes)
        self.proposed += n
        return n

    # -- the harvest phase ---------------------------------------------------------
    def harvest(self):
        """Harvest phase: the authoritative variation walk.  Runs the seeded
        serial operator, whose evaluations collapse onto whatever
        :meth:`propose` already has in flight — commit decisions land in the
        operator's deterministic order no matter which futures finished
        first.  Commits on improvement."""
        directive = self.supervisor.check(self.lineage)
        if obs.enabled():
            # reuse the propose-minted trace (pipelined) or mint one for the
            # barrier path, so every authoritative walk has a lifecycle id
            tr, self._last_trace = (self._last_trace or obs.new_trace()), None
            t0 = time.perf_counter()
            with obs.use_trace(tr):
                result = self.operator.vary(self.tools, directive)
            obs.span("harvest", tr, island=self.name,
                     dur_s=time.perf_counter() - t0,
                     committed=result.committed,
                     attempts=result.internal_attempts)
        else:
            result = self.operator.vary(self.tools, directive)
        self.steps += 1
        self._m_steps.inc()
        (self._m_commits if result.committed else self._m_rejects).inc()
        self.internal_attempts += result.internal_attempts
        self.traces.append({
            "step": self.steps - 1, "directive": directive.note,
            "committed": result.committed, "note": result.note,
            "attempts": result.internal_attempts,
            "trace": [list(t) for t in result.trace]})
        if result.committed:
            self.lineage.update(result.genome, result.score, result.note,
                                result.internal_attempts)
            if self.persist_path:
                self.lineage.save(self.persist_path)
            if self.on_commit:
                self.on_commit(self)
        self.supervisor.observe(result.committed)
        return result

    def step(self):
        """One supervised variation step; commits on improvement.

        Pipelined: propose (async submit of the candidate batch) then
        harvest.  Barrier mode: optional KB-top-k prefetch then harvest —
        the historical step-blocking behaviour, bit for bit."""
        if self.pipeline:
            self.propose()
        elif self.prefetch_k:
            self._prefetch_candidates()
        return self.harvest()

    # -- migration ---------------------------------------------------------------
    def accept_migrant(self, commit: Commit, donor: str) -> bool:
        """Re-score a donor's best genome on THIS island's suite; adopt it only
        on strict improvement (migration can never lose the local best).  The
        single-commit case of :meth:`accept_migrants` — same evaluation, same
        threshold, same commit bookkeeping."""
        return self.accept_migrants((commit,), donor)

    def accept_migrants(self, commits: Sequence[Commit], donor: str) -> bool:
        """Top-k migrant policy: re-score EVERY donated commit on THIS
        island's suite and adopt the best survivor, on strict improvement.
        The donor's best-on-its-own-suite is not always the best transfer
        candidate (the paper's §4.3 cross-scenario adaptation): a runner-up
        tuned differently may re-score higher here.  Deterministic: donated
        order is deterministic and ties keep the earliest (strict >)."""
        best_c, best_sv = None, None
        for c in commits:
            sv = self.tools.evaluate(c.genome)
            if not sv.correct:
                continue
            if best_sv is None or sv.geomean > best_sv.geomean:
                best_c, best_sv = c, sv
        local = self.lineage.best()
        if best_sv is not None and \
                best_sv.geomean > (local.geomean if local else 0.0):
            self.lineage.update(
                best_c.genome, best_sv,
                f"migrant from {donor}: {best_c.note[:80]}", 0)
            self.migrants_accepted += 1
            if self.persist_path:
                self.lineage.save(self.persist_path)
            if self.on_commit:
                self.on_commit(self)
            return True
        return False

    # -- accounting ---------------------------------------------------------------
    def best_geomean(self) -> float:
        b = self.lineage.best()
        return b.geomean if b else 0.0

    def gain_profile(self) -> list:
        """Descending predicted-gain distribution of the KB's current
        suggestions for this island's best genome — what the shared
        speculative-prefetch budget allocator sizes batches from.  Uncounted
        and peek-only: allocation must never pay an evaluation, so an
        uncached best (e.g. right after resume) yields an empty profile."""
        best = self.lineage.best()
        if best is None:
            return []
        cache = getattr(self.scorer, "cache", None)
        sv = (cache.peek(self.scorer.score_key(best.genome))
              if cache is not None else None)
        if sv is None or not sv.correct:
            return []
        return self.kb.gain_profile(best.genome, sv, self.scorer.suite,
                                    sv.dominant_bottleneck())

    def report(self, wall_seconds: float = 0.0) -> EvolutionReport:
        return EvolutionReport(
            commits=len(self.lineage), steps=self.steps,
            internal_attempts=self.internal_attempts,
            interventions=self.supervisor.interventions,
            tool_stats=self.tools.stats(),
            best_geomean=self.best_geomean(),
            wall_seconds=wall_seconds, traces=self.traces)

