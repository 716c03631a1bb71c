"""Continuous evolution (paper §3.3): a loop that periodically produces new
committed versions without human intervention, with supervisor interventions
on stagnation and commit-per-version persistence.

``ContinuousEvolution`` drives one :class:`Island` serially, scoring through
the inline backend on the card (``device=None``) or on the CPU
(``device="cpu"``, the plain PyTorch kernel path).  Its default operator
commits at the scorer's rung's floor (:func:`default_agent`).
"""
from __future__ import annotations

import os
import time
from typing import Optional, Union

import torch

from repro_torch.core import obs
from repro_torch.core.agent import ScriptedAgent
from repro_torch.core.evals import (MEASURED, MEASURED_MIN_REL, PERFMODEL,
                                    InlineBackend, Scorer)
from repro_torch.core.islands import EvolutionReport, Island
from repro_torch.core.perfmodel import suite_by_name
from repro_torch.core.population import Lineage
from repro_torch.core.search_space import KernelGenome
from repro_torch.core.supervisor import Supervisor
from repro_torch.core.variation import AgenticVariationOperator

__all__ = ["ContinuousEvolution", "EvolutionReport", "default_agent"]


def default_agent(fidelity: str, seed: Optional[KernelGenome] = None
                  ) -> ScriptedAgent:
    """The scripted agent at ``fidelity``'s commit floor: ``MEASURED_MIN_REL``
    at the measured rung, whose scores are timings; the agent's own 1e-4 at
    rung 0, so its lineages equal the JAX package's.  ``seed`` starts an
    adaptation (the GQA transfer)."""
    if fidelity == MEASURED:
        return ScriptedAgent(min_rel_improvement=MEASURED_MIN_REL, seed=seed)
    return ScriptedAgent(seed=seed)


class ContinuousEvolution:
    def __init__(self, scorer: Optional[Scorer] = None,
                 operator=None, supervisor: Optional[Supervisor] = None,
                 lineage: Optional[Lineage] = None,
                 persist_path: Optional[str] = None,
                 target_suite: Optional[str] = None,
                 fidelity: str = PERFMODEL,
                 device: Optional[Union[str, torch.device]] = None):
        """``target_suite`` names a scenario suite from the perfmodel registry
        ('mha', 'gqa', 'decode', or a '+'-union; default mha); ``fidelity``
        and ``device`` configure the inline scorer.  All three are ignored
        when an explicit ``scorer`` is given.  Without an ``operator`` the
        agent commits at the scorer's rung's floor (:func:`default_agent`);
        an explicit one is used as given."""
        if scorer is None:
            suite = suite_by_name(target_suite) if target_suite else None
            scorer = InlineBackend(suite=suite, fidelity=fidelity, device=device)
        if operator is None:
            operator = AgenticVariationOperator(default_agent(scorer.fidelity))
        self.island = Island(
            name="main", scorer=scorer,
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
        """Release backend resources."""
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
