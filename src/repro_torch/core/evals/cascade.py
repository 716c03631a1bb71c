"""Successive-halving evaluation cascade over the fidelity ladder.

The search loop is throughput-bound on evaluation, and before the cascade
every genome paid the same flat rung-0 (``perfmodel``) cost while the repo's
higher-fidelity signals — HLO/roofline analysis, real kernel timing — sat
unused.  :class:`CascadeBackend` spends them where they buy lineage gain:
score the whole candidate slate at rung 0, promote the top ``1/eta`` slice
to rung 1 (``hlo``), the top slice of that to rung 2 (``measured``), so the
expensive rungs run on ~``1/eta²`` of candidates instead of zero or all.

Rung 0 IS the wrapped island backend: cascade rung-0 evaluations go through
the exact same backend+cache the island's own stepping uses, so the cascade
is pure cache warming from the lineage's point of view — with promotion
disabled (``eta=None``/no higher rungs) lineages are bit-identical to a
cascade-free run, and calibration only ever reorders *promotion*, never the
scores the engine commits on.

Calibration closes the loop (K-Search's world-model recipe): every genome
that reaches the measured rung records its measured/predicted residual into
a per-bottleneck-class EMA (:class:`perfmodel.PerfModelCalibration`), and
rung-0 scores are rescaled by their class's factor when *ranking* candidates
for promotion — the cheap prefilter's ranking error shrinks over the run.

Determinism: promotion is ranked on ``(-score, genome key)`` and calibration
observes genomes in promotion order, so a killed/resumed run (factors ride
in the archipelago payload) replays identical promotion and correction
decisions.

The port (a copy of ``repro.core.evals.cascade`` with the imports re-pointed
and the factory's ladder set by the card): rung 1 counts the launch rung
2 times in the kernel's physical walk, rung 2 the kernel timed on the card
(``scorer.py``), and rung 2 plans from the card's model
(:func:`rung_spec`).  A cascade whose spec scores on the CPU runs rungs 0-1
only (:func:`ladder`): the measured rung refuses the CPU, and no modelled
timer is filed under a device's name.  Rung 2 is a timing, so on the card
a resumed run's promotions can differ from an uninterrupted run's once the
calibration has seen rung-2 residuals.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Optional, Sequence

from repro_torch.core import obs
from repro_torch.core.evals.backends import make_backend, register_backend
from repro_torch.core.evals.cache import (FIDELITIES, HLO, MEASURED,
                                          PERFMODEL, ScoreCache)
from repro_torch.core.evals.vector import ScoreVector
from repro_torch.core.evals.worker import EvalSpec
from repro_torch.core.perfmodel import PerfModelCalibration
from repro_torch.core.search_space import KernelGenome

DEFAULT_ETA = 3


def _geomean_or_zero(sv: Optional[ScoreVector]) -> float:
    if sv is None or not sv.correct:
        return 0.0
    try:
        return sv.geomean
    except Exception:
        return 0.0


class CascadeBackend:
    """An :class:`EvalBackend` that wraps one backend per fidelity rung and
    runs successive-halving promotion across them.

    ``rungs`` is ``[rung0, rung1, rung2]`` (any suffix may be omitted —
    a one-rung cascade degenerates to the wrapped backend).  All rungs
    should share one :class:`ScoreCache`; fidelity-prefixed keys keep them
    from aliasing.  The full EvalBackend surface delegates to rung 0, so a
    CascadeBackend can stand anywhere a plain backend does — the island
    engine keeps calling ``submit``/``map``/``prefetch`` for its normal
    stepping and additionally calls :meth:`run_cascade` once per epoch.
    """

    def __init__(self, rungs: Sequence, *, eta: int = DEFAULT_ETA,
                 calibration: Optional[PerfModelCalibration] = None):
        if not rungs:
            raise ValueError("CascadeBackend needs at least a rung-0 backend")
        if len(rungs) > len(FIDELITIES):
            raise ValueError(f"at most {len(FIDELITIES)} rungs "
                             f"({' -> '.join(FIDELITIES)}), got {len(rungs)}")
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        self.rungs = list(rungs)
        self.eta = eta
        self.calibration = calibration if calibration is not None \
            else PerfModelCalibration()
        self.last_run: dict = {}

    # -- EvalBackend surface: rung 0 verbatim -----------------------------------
    @property
    def base(self):
        return self.rungs[0]

    @property
    def suite(self):
        return self.base.suite

    @property
    def overlapping(self) -> bool:
        return self.base.overlapping

    @property
    def cache(self):
        return self.base.cache

    @property
    def cache_hits(self) -> int:
        return self.base.cache_hits

    def score_key(self, genome: KernelGenome) -> str:
        return self.base.score_key(genome)

    @property
    def n_evaluations(self) -> int:
        return self.base.n_evaluations

    @property
    def max_workers(self):
        return getattr(self.base, "max_workers", 1)

    def __call__(self, genome: KernelGenome) -> ScoreVector:
        return self.base(genome)

    def submit(self, genome: KernelGenome) -> concurrent.futures.Future:
        return self.base.submit(genome)

    def map(self, genomes: Sequence[KernelGenome]) -> list:
        return self.base.map(genomes)

    def prefetch(self, genomes: Sequence[KernelGenome]) -> None:
        self.base.prefetch(genomes)

    def baselines(self) -> dict:
        return self.base.baselines()

    def close(self) -> None:
        """Close every rung (rung backends are owned by the cascade's
        creator in the engine, which passes shared executors — each rung's
        own close stays idempotent)."""
        for rung in self.rungs:
            rung.close()

    # -- the cascade itself -----------------------------------------------------
    def promote_count(self, n: int) -> int:
        """Successive-halving survivor count: ``max(1, n // eta)`` — never
        zero, so a non-empty slate always carries one genome to the top."""
        return max(1, n // self.eta)

    def _ranked(self, scored: list, *, calibrated: bool) -> list:
        """Sort ``(genome, sv)`` pairs best-first, deterministically: score
        descending, genome key ascending as the tie-break.  ``calibrated``
        applies the per-bottleneck-class correction (rung-0 ranking only)."""
        def sort_key(pair):
            g, sv = pair
            score = _geomean_or_zero(sv)
            if calibrated and sv is not None:
                score = self.calibration.corrected(
                    sv.dominant_bottleneck(), score)
            return (-score, g.key())
        return sorted(scored, key=sort_key)

    def run_cascade(self, genomes: Sequence[KernelGenome],
                    promote: bool = True) -> dict:
        """One successive-halving pass over a candidate slate.

        Scores every (deduped) genome at rung 0 through the wrapped backend
        — pure cache warming for the island engine — then, when ``promote``
        and higher rungs exist, promotes the calibrated-rank top ``1/eta``
        to rung 1 and the raw-rank top ``1/eta`` of *that* to rung 2, and
        feeds rung-2-vs-rung-0 residuals into the calibration.  Returns the
        promotion log (counts, promoted genome keys, calibration factors) —
        the engine persists it so a resumed run replays identically."""
        unique: dict[str, KernelGenome] = {}
        for g in genomes:
            unique.setdefault(g.key(), g)
        slate = list(unique.values())
        log: dict = {"slate": len(slate), "eta": self.eta,
                     "evals": {PERFMODEL: len(slate), HLO: 0, MEASURED: 0},
                     "promoted": {HLO: [], MEASURED: []},
                     "calibration": {}}
        if not slate:
            self.last_run = log
            return log

        svs0 = self.base.map(slate)
        scored0 = list(zip(slate, svs0))
        if not promote or len(self.rungs) < 2:
            log["calibration"] = self.calibration.state()
            self.last_run = log
            return log

        # rung 0 -> rung 1: calibrated ranking picks who pays for HLO tracing
        n1 = self.promote_count(len(scored0))
        promoted1 = [g for g, _ in self._ranked(scored0, calibrated=True)[:n1]]
        log["evals"][HLO] = len(promoted1)
        log["promoted"][HLO] = [g.key() for g in promoted1]
        svs1 = self.rungs[1].map(promoted1)

        if len(self.rungs) >= 3 and promoted1:
            # rung 1 -> rung 2: raw HLO/roofline ranking (already a real
            # structural measurement; calibration corrects rung 0 only)
            scored1 = list(zip(promoted1, svs1))
            n2 = self.promote_count(len(scored1))
            promoted2 = [g for g, _ in
                         self._ranked(scored1, calibrated=False)[:n2]]
            log["evals"][MEASURED] = len(promoted2)
            log["promoted"][MEASURED] = [g.key() for g in promoted2]
            svs2 = self.rungs[2].map(promoted2)

            # close the loop: measured-vs-predicted residuals per bottleneck
            # class, observed in deterministic promotion order
            sv0_by_key = {g.key(): sv for g, sv in scored0}
            for g, sv2 in zip(promoted2, svs2):
                sv0 = sv0_by_key[g.key()]
                if sv0 is None or sv2 is None:
                    continue
                self.calibration.observe(sv0.dominant_bottleneck(),
                                         _geomean_or_zero(sv0),
                                         _geomean_or_zero(sv2))
        log["calibration"] = self.calibration.state()
        self.last_run = log
        if obs.enabled():
            # one promotion event per pass: slate size and the per-rung paid
            # evaluation counts — the journal's view of where cascade budget
            # went (promotion decisions themselves ride the engine payload)
            obs.publish("cascade_promote", trace=obs.current_trace(),
                        slate=log["slate"],
                        evals={k: v for k, v in log["evals"].items() if v})
        return log


def ladder(spec: EvalSpec) -> tuple:
    """The rungs a cascade over ``spec`` runs: all three on the card, rungs
    0-1 on the CPU, where the measured rung has nothing to time."""
    return FIDELITIES if spec.on_card else FIDELITIES[:2]


def rung_spec(spec: EvalSpec, fidelity: str) -> EvalSpec:
    """``spec`` at another rung of the ladder; the measured rung plans from
    the card's model (``machine="h100"``), whatever rung 0 models."""
    out = spec.with_fidelity(fidelity)
    return dataclasses.replace(out, machine="h100") if fidelity == MEASURED else out


def _cascade_factory(spec: EvalSpec, cache: Optional[ScoreCache] = None, *,
                     rungs: Optional[Sequence] = None, base: str = "thread",
                     fidelities: Optional[Sequence[str]] = None,
                     eta: int = DEFAULT_ETA,
                     calibration: Optional[PerfModelCalibration] = None,
                     **kw) -> CascadeBackend:
    """Registry factory: pass pre-built ``rungs`` (the island engine does —
    it wires shared executors/coordinators itself), or let the factory build
    one backend per fidelity rung of :func:`ladder` through
    :func:`make_backend`, on the spec's device, all sharing one cache
    (fidelity-prefixed keys keep rungs from aliasing)."""
    if rungs is None:
        shared = cache if cache is not None else ScoreCache()
        rungs = [make_backend(base, suite=rung_spec(spec, f),
                              cache=shared, **kw)
                 for f in (fidelities if fidelities is not None
                           else ladder(spec))]
    return CascadeBackend(rungs, eta=eta, calibration=calibration)


register_backend("cascade", _cascade_factory)
