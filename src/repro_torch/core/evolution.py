"""Continuous evolution (paper §3.3): a loop that periodically produces new
committed versions without human intervention, with supervisor interventions
on stagnation and commit-per-version persistence.

``ContinuousEvolution`` drives one :class:`Island` serially, scoring through
the evaluation backend named by ``eval_backend`` (``inline``, ``thread``,
``process`` or ``service``; ``core/evals/backends.py``) on the card
(``device=None``) or on the CPU (``device="cpu"``, the plain PyTorch kernel
path).  Its default operator
commits at the scorer's rung's floor (:func:`default_agent`), and its
knowledge base holds the facts of the machine the scorer plans from
(:func:`knowledge_for`): Hopper facts at the measured rung and at rung 0
under ``machine="h100"``, the reference's TPU facts at rung 0 under
``"tpu_v5e"`` (the default, for lineage parity with the JAX package).
"""
from __future__ import annotations

import os
import time
from typing import Optional, Union

import torch

from repro_torch.core import obs
from repro_torch.core.agent import ScriptedAgent
from repro_torch.core.evals import (MEASURED, MEASURED_CALL_SPREAD,
                                    MEASURED_MIN_REL, PERFMODEL, Scorer,
                                    make_backend)
from repro_torch.core.islands import EvolutionReport, Island
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.knowledge_h100 import knowledge_for
from repro_torch.core.perfmodel import suite_by_name
from repro_torch.core.population import Lineage
from repro_torch.core.search_space import KernelGenome
from repro_torch.core.supervisor import Supervisor
from repro_torch.core.variation import AgenticVariationOperator

__all__ = ["ContinuousEvolution", "EvolutionReport", "PairedAgent",
           "default_agent"]


class PairedAgent(ScriptedAgent):
    """The measured rung's agent: it commits on the paired gain
    (:meth:`Scorer.paired_gain`: candidate and incumbent timed in turns in
    one locked section), not on the ratio of two geomeans scored apart.  A
    candidate whose unpaired gain is at or below ``-MEASURED_CALL_SPREAD``
    is refuted on that alone, without pairing: the unpaired reading errs by
    less than that, so such a candidate is slower.  A pooled backend
    (process, service) has no ``paired_gain``: the agent then times on a
    measured :class:`Scorer` of its own, on the backend's suite, device and
    seed, built once; the card lock keeps its sections apart from the
    workers'.

    ``decisions`` records every decision: the candidate's genome key, the
    paired and the unpaired gain, the seconds the pairing took (None:
    refuted unpaired), whether it committed, and each config's ratio."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.decisions: list[dict] = []
        self._timer: Optional[Scorer] = None

    def _timer_for(self, scorer) -> Scorer:
        if hasattr(scorer, "paired_gain"):
            return scorer
        if self._timer is None:
            spec = scorer.spec
            self._timer = Scorer(suite=spec.suite, check_correctness=False,
                                 rng_seed=spec.rng_seed, fidelity=MEASURED,
                                 device=spec.device)
        return self._timer

    def _gain(self, tools, parent, parent_sv, cand, sv) -> float:
        unpaired = super()._gain(tools, parent, parent_sv, cand, sv)
        row = {"genome": cand.key(), "unpaired": unpaired, "paired": None,
               "seconds": None, "ratios": None}
        gain = unpaired
        if unpaired > -MEASURED_CALL_SPREAD:
            pg = self._timer_for(tools.scorer).paired_gain(parent, cand)
            gain = pg.gain
            row.update(paired=pg.gain, seconds=pg.seconds, ratios=pg.ratios)
        row["committed"] = gain > self.min_rel
        self.decisions.append(row)
        return gain


def default_agent(fidelity: str, seed: Optional[KernelGenome] = None
                  ) -> ScriptedAgent:
    """The scripted agent at ``fidelity``'s commit floor: at the measured
    rung, whose scores are timings, a :class:`PairedAgent` committing above
    ``MEASURED_MIN_REL``; the agent's own 1e-4 at rung 0, so its lineages
    equal the JAX package's.  ``seed`` starts an adaptation (the GQA
    transfer)."""
    if fidelity == MEASURED:
        return PairedAgent(min_rel_improvement=MEASURED_MIN_REL, seed=seed)
    return ScriptedAgent(seed=seed)


class ContinuousEvolution:
    def __init__(self, scorer: Optional[Scorer] = None,
                 operator=None, supervisor: Optional[Supervisor] = None,
                 lineage: Optional[Lineage] = None,
                 persist_path: Optional[str] = None,
                 target_suite: Optional[str] = None,
                 fidelity: str = PERFMODEL,
                 device: Optional[Union[str, torch.device]] = None,
                 machine: Optional[str] = None,
                 kb: Optional[KnowledgeBase] = None,
                 eval_backend: str = "inline",
                 workers: Optional[int] = None):
        """``target_suite`` names a scenario suite from the perfmodel registry
        ('mha', 'gqa', 'decode', or a '+'-union; default mha); ``fidelity``,
        ``device`` and ``machine`` (rung 0's model) configure the scorer;
        ``eval_backend`` selects the evaluation service ('inline' |
        'thread' | 'process' | 'service') and ``workers`` its width (the
        backend's default when None; 'service' starts that many local
        workers).  All six are ignored when an explicit ``scorer`` is given.
        Without an ``operator`` the agent commits at the scorer's rung's
        floor (:func:`default_agent`); without a ``kb`` the facts are those
        of the scorer's ``plan_machine``.  An explicit operator or kb is
        used as given."""
        if scorer is None:
            suite = suite_by_name(target_suite) if target_suite else None
            kw = {}
            if workers is not None:
                if eval_backend == "inline":
                    raise ValueError("workers= needs a pooled eval_backend "
                                     "('thread', 'process' or 'service')")
                kw["workers" if eval_backend == "service"
                   else "max_workers"] = workers
            scorer = make_backend(eval_backend, suite=suite, fidelity=fidelity,
                                  device=device, machine=machine, **kw)
        if operator is None:
            operator = AgenticVariationOperator(default_agent(scorer.fidelity))
        if kb is None:
            kb = knowledge_for(scorer.plan_machine)
        self.island = Island(
            name="main", scorer=scorer, kb=kb,
            operator=operator,
            supervisor=supervisor or Supervisor(),
            lineage=lineage, persist_path=persist_path)
        self.persist_path = persist_path

    # -- single-island aliases ---------------------------------------------------
    @property
    def scorer(self):
        return self.island.scorer

    @property
    def kb(self):
        return self.island.kb

    @property
    def lineage(self):
        return self.island.lineage

    @property
    def tools(self):
        return self.island.tools

    @property
    def operator(self):
        return self.island.operator

    @property
    def supervisor(self):
        return self.island.supervisor

    @classmethod
    def resume(cls, persist_path: str, **kw) -> "ContinuousEvolution":
        lineage = Lineage.load(persist_path) if os.path.exists(persist_path) else None
        return cls(lineage=lineage, persist_path=persist_path, **kw)

    def close(self) -> None:
        """Release backend resources (worker pools for thread/process, the
        owned coordinator and its workers for service)."""
        closer = getattr(self.island.scorer, "close", None)
        if closer is not None:
            closer()

    def run(self, max_steps: int = 60, target_commits: Optional[int] = None,
            wall_budget_s: Optional[float] = None, verbose: bool = False
            ) -> EvolutionReport:
        t0 = time.time()
        obs.ensure_journal()      # no-op unless REPRO_OBS is on
        isl = self.island
        start_commits = len(isl.lineage)
        start_steps = isl.steps
        start_attempts = isl.internal_attempts
        for _ in range(max_steps):
            if target_commits is not None and \
                    len(isl.lineage) - start_commits >= target_commits:
                break
            if wall_budget_s is not None and time.time() - t0 > wall_budget_s:
                break
            result = isl.step()
            if verbose:
                head = isl.lineage.best()
                obs.narrate(
                    f"[step {isl.steps - start_steps - 1:3d}] "
                    f"committed={result.committed} "
                    f"best={head.geomean if head else 0:.1f} TFLOPS "
                    f"attempts={result.internal_attempts}  {result.note[:80]}",
                    step=isl.steps - start_steps - 1,
                    committed=result.committed,
                    best=head.geomean if head else 0.0)
        best = isl.lineage.best()
        return EvolutionReport(
            commits=len(isl.lineage) - start_commits,
            steps=isl.steps - start_steps,
            internal_attempts=isl.internal_attempts - start_attempts,
            interventions=isl.supervisor.interventions,
            tool_stats=isl.tools.stats(),
            best_geomean=best.geomean if best else 0.0,
            wall_seconds=time.time() - t0,
            traces=isl.traces[start_steps:])
