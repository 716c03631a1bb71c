"""The pure, picklable evaluation worker used by the process backend.

Everything here must be importable by a cold interpreter (spawn) or an
inherited one (fork): module-level functions only, no closures, no state
beyond the per-process spec/scorer tables.  A worker rebuilds its scorer —
and the RNG-derived correctness proxy inputs — deterministically from the
:class:`EvalSpec` alone, so the ScoreVectors it returns are bit-identical to
the inline path (see ``tests/test_evals.py``).

Wire economy: an :class:`EvalSpec` pickles to hundreds of bytes (it carries
the whole BenchConfig suite) and a full :class:`KernelGenome` pickle to ~200,
while a genome is fully determined by its seed-relative edit list
(``KernelGenome.to_edits``, tens of bytes).  So the hot task path ships
``(edits, spec_id)`` instead: specs are *interned* once in the parent
(:func:`intern_spec`), announced to workers at warm time
(:func:`warm_worker` / the service WARM frames), and every subsequent task
references the id (:func:`evaluate_frame`).  :func:`evaluate_genome` remains
the full-payload fallback for executors whose warm set is unknown.

The port's spec also names where a worker scores: ``device`` (``None`` is
the card, as everywhere in the port; a worker asked for the card on a host
without one raises, it never falls back to the CPU) and ``machine`` (rung
0's model).  Both travel as strings.  :func:`worker_stats` is what a pool
or a service worker reports about itself: its pid, its card-lock record,
its ``flash_attention`` launch counts and its peak device memory.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from repro_torch.core.evals.cache import FIDELITIES, MEASURED, PERFMODEL
from repro_torch.core.evals.scorer import Scorer, set_batch_scoring
from repro_torch.core.evals.vector import ScoreVector
from repro_torch.core.perfmodel import BenchConfig, suite_by_name
from repro_torch.core.search_space import KernelGenome


@dataclass(frozen=True)
class EvalSpec:
    """Everything a worker needs to rebuild a :class:`Scorer`: the resolved
    benchmark configs (BenchConfig is a frozen, picklable dataclass), the
    correctness toggle, the proxy-input RNG seed, the modelled
    evaluation-service latency (see ``Scorer.service_latency_s``), the
    evaluation *fidelity* rung (see ``cache.FIDELITIES``), the ``device`` a
    worker scores on (``None``: the card) and rung 0's ``machine``
    (``None``: the rung's default).

    Fidelity is part of the spec's value, so interning (:func:`intern_spec`)
    hands every rung its own wire id: worker scorer tables, process-pool
    tasks, and service frames are keyed per ``(genome, spec, fidelity)``
    without any transport-layer change — two rungs of one suite are simply
    two different specs on the wire."""
    suite: tuple                  # tuple[BenchConfig, ...]
    check_correctness: bool = True
    rng_seed: int = 0
    service_latency_s: float = 0.0
    fidelity: str = PERFMODEL
    device: Optional[str] = None
    machine: Optional[str] = None

    def __post_init__(self):
        if self.fidelity not in FIDELITIES:
            raise ValueError(f"unknown fidelity {self.fidelity!r}; "
                             f"known: {FIDELITIES}")
        if self.device is not None and not isinstance(self.device, str):
            object.__setattr__(self, "device", str(self.device))

    @property
    def on_card(self) -> bool:
        """Whether a worker of this spec scores on a CUDA card."""
        return self.device is None or torch.device(self.device).type == "cuda"

    def with_fidelity(self, fidelity: str) -> "EvalSpec":
        """The same evaluation target at another rung of the ladder."""
        return EvalSpec(self.suite, self.check_correctness, self.rng_seed,
                        self.service_latency_s, fidelity, self.device,
                        self.machine)

    @classmethod
    def resolve(cls, suite: Union[str, Sequence[BenchConfig], "EvalSpec", None],
                check_correctness: bool = True, rng_seed: int = 0,
                service_latency_s: float = 0.0,
                fidelity: str = PERFMODEL, device: Optional[str] = None,
                machine: Optional[str] = None) -> "EvalSpec":
        """Accept a registered suite name ('mha', 'mha+gqa'), an explicit
        config sequence, an EvalSpec (returned as-is), or None (MHA default)."""
        if isinstance(suite, EvalSpec):
            return suite
        if isinstance(suite, str):
            cfgs = suite_by_name(suite)
        elif suite is None:
            from repro_torch.core.perfmodel import mha_suite
            cfgs = mha_suite()
        else:
            cfgs = list(suite)
        return cls(tuple(cfgs), check_correctness, rng_seed,
                   service_latency_s, fidelity, device, machine)


# -- parent-side spec interning ---------------------------------------------------
# One process-global table: every backend in one parent hands out consistent
# ids, so any number of backends can share one executor/coordinator/fleet.
_SPEC_IDS: dict = {}           # EvalSpec -> int
_INTERN_LOCK = threading.Lock()


def intern_spec(spec: EvalSpec) -> int:
    """Assign (or look up) the parent-side wire id for a spec.  Ids are
    sequential, never reused, and only meaningful together with the explicit
    ``(id, spec)`` announcements the parent sends — hash() would not survive
    a spawn boundary (per-interpreter string-hash salt)."""
    with _INTERN_LOCK:
        sid = _SPEC_IDS.get(spec)
        if sid is None:
            sid = len(_SPEC_IDS)
            _SPEC_IDS[spec] = sid
        return sid


# -- per-process worker state -------------------------------------------------------
# spec table: what THIS process has been told each wire id means
_WORKER_SPECS: dict = {}       # int -> EvalSpec

# scorer table: one warm Scorer per spec, built on first use and kept across
# batches (proxy inputs + trace warmup are paid once per spec-epoch, not per
# task).  LRU-bounded so a long-lived service worker that has seen many
# retired specs (7-day runs, multi-tenant coordinators) does not leak one
# warm scorer — with its proxy and full-shape inputs — per dead spec.
_WORKER_SCORERS: "OrderedDict" = OrderedDict()
SCORER_CACHE_CAP = 8


def register_worker_specs(pairs: Sequence) -> None:
    """Record ``(spec_id, spec)`` announcements (idempotent; re-announcing an
    id with the same spec is a no-op, which the wire protocol exploits by
    repeating announcements until delivery is confirmed)."""
    for sid, spec in pairs:
        _WORKER_SPECS[int(sid)] = spec


def _scorer_for(spec: EvalSpec) -> Scorer:
    scorer = _WORKER_SCORERS.get(spec)
    if scorer is None:
        scorer = Scorer(suite=list(spec.suite),
                        check_correctness=spec.check_correctness,
                        rng_seed=spec.rng_seed,
                        service_latency_s=spec.service_latency_s,
                        fidelity=spec.fidelity, device=spec.device,
                        machine=spec.machine)
        _WORKER_SCORERS[spec] = scorer
        while len(_WORKER_SCORERS) > max(1, SCORER_CACHE_CAP):
            _WORKER_SCORERS.popitem(last=False)      # evict least recently used
    else:
        _WORKER_SCORERS.move_to_end(spec)
    return scorer


def warm_worker(specs: Sequence,
                batch_scoring: Optional[bool] = None) -> None:
    """Process-pool initializer: pre-build the scorer (its proxy inputs, and
    at the measured rung its full-shape inputs; rung 1 traces on the meta
    device and builds nothing) for every suite this pool will serve, so the
    first real evaluation in each worker pays no warm-up.
    Accepts ``(spec_id, spec)`` pairs (registered for the compact
    :func:`evaluate_frame` path) or bare :class:`EvalSpec`\\ s.
    ``batch_scoring`` hands a spawned worker the parent's batch-path setting,
    which a forked one inherits."""
    if batch_scoring is not None:
        set_batch_scoring(batch_scoring)
    for item in specs:
        if isinstance(item, EvalSpec):
            spec = item
        else:
            sid, spec = item
            _WORKER_SPECS[int(sid)] = spec
        _scorer_for(spec).warm()


def evaluate_genome(genome: KernelGenome,
                    suite: Union[str, EvalSpec],
                    *, check_correctness: bool = True,
                    rng_seed: int = 0,
                    service_latency_s: float = 0.0,
                    fidelity: str = PERFMODEL,
                    device: Optional[str] = None,
                    machine: Optional[str] = None) -> ScoreVector:
    """Evaluate one genome on one suite — the full-payload task function.

    ``suite`` is a registered suite name (resolved through the perfmodel
    scenario registry) or a pre-resolved :class:`EvalSpec` (which carries its
    own latency model — the keyword applies to the name/sequence forms, so a
    name-addressed evaluation models the same ``service_latency_s`` as a
    spec-addressed one).  Pure: the result depends only on the arguments,
    never on which process runs it.
    """
    spec = EvalSpec.resolve(suite, check_correctness, rng_seed,
                            service_latency_s, fidelity, device, machine)
    return _scorer_for(spec).score_uncached(genome)


def evaluate_frame(edits: tuple, spec_id: int) -> ScoreVector:
    """Evaluate one seed-only genome frame — the compact task function.

    ``edits`` is ``KernelGenome.to_edits()`` output and ``spec_id`` an
    interned spec this worker was warmed with; together they pickle to tens
    of bytes where the full ``(genome, spec)`` payload is hundreds.  Pure for
    the same reason :func:`evaluate_genome` is: the genome rebuilds
    deterministically from the edit list, the scorer from the spec."""
    spec = _WORKER_SPECS.get(spec_id)
    if spec is None:
        raise RuntimeError(
            f"unknown interned spec id {spec_id}: this worker was never "
            f"warmed with it (announced ids: {sorted(_WORKER_SPECS)})")
    return _scorer_for(spec).score_uncached(KernelGenome.from_edits(edits))


def evaluate_frame_many(entries: Sequence) -> list:
    """Evaluate a whole coalesced frame of ``(edits, spec_id)`` tasks — the
    columnar task function.  Entries are grouped per spec and each group is
    scored with one :meth:`Scorer.score_batch` call (one vectorized rung-0
    model evaluation, one structural correctness-memo pass), results returned
    in entry order.  Pure like :func:`evaluate_frame`; a batch that raises
    mid-group degrades to per-entry scalar scoring so failure attribution
    stays per task."""
    entries = list(entries)
    genomes = [KernelGenome.from_edits(edits) for edits, _sid in entries]
    groups: "OrderedDict[int, list[int]]" = OrderedDict()
    for idx, (_edits, sid) in enumerate(entries):
        groups.setdefault(int(sid), []).append(idx)
    out: list = [None] * len(entries)
    for sid, idxs in groups.items():
        spec = _WORKER_SPECS.get(sid)
        if spec is None:
            raise RuntimeError(
                f"unknown interned spec id {sid}: this worker was never "
                f"warmed with it (announced ids: {sorted(_WORKER_SPECS)})")
        scorer = _scorer_for(spec)
        try:
            svs = scorer.score_batch([genomes[i] for i in idxs])
        except Exception:            # pragma: no cover - defensive fallback
            svs = [scorer.score_uncached(genomes[i]) for i in idxs]
        for i, sv in zip(idxs, svs):
            out[i] = sv
    return out


def _prestart_noop() -> None:
    """Trivial task submitted once per worker to force the pool to fork/spawn
    its processes immediately (while the parent is still CUDA-clean)."""


def prepare_parent(specs: Sequence[EvalSpec]) -> None:
    """What a parent does before it starts workers for ``specs``: a spec on
    the card needs a card here (raises without one), and the kernel its
    workers launch (a gate or the measured rung; rung 1 launches none) is
    built and loaded once, so that workers only load."""
    card = [s for s in specs if s.on_card]
    if not card:
        return
    from repro_torch.device import resolve_device
    resolve_device(card[0].device)
    if any(s.check_correctness or s.fidelity == MEASURED for s in card):
        from repro_torch.kernels import _build
        _build.load("flash_attention.cu")


def worker_stats(hold_s: float = 0.0) -> dict:
    """This process's pid, card-lock record (``device.card_lock_stats``),
    ``flash_attention`` launch counts and peak device memory (None before
    CUDA is initialised).  ``hold_s`` keeps the worker busy that long, so
    that one such call per worker, submitted together, reaches every worker
    of a pool."""
    from repro_torch.device import card_lock_stats
    from repro_torch.kernels.flash_attention import flash_attention
    time.sleep(hold_s)
    return {"pid": os.getpid(), "card_locks": card_lock_stats(),
            "launches": flash_attention.launches,
            "launches_by_body": dict(flash_attention.launches_by_body),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                  if torch.cuda.is_initialized() else None)}
