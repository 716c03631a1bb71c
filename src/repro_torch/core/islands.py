"""Island-model parallel evolution: many concurrent lineages, one search
(the port of ``repro.core.islands``).

The paper's §3.3 runs a *single* continuous lineage.  This engine scales that
regime out: N islands each drive their own :class:`Lineage` with their own
variation operator (AVO / single-shot / plan-execute-summarize can be mixed
per island) and optionally their own target scenario suite (MHA, GQA, decode
shapes — see ``perfmodel.suite_by_name``).  Between epochs the engine

  * **migrates** each island's best commit along the edges of a pluggable
    :class:`~repro_torch.core.topology.MigrationTopology` (ring — the default
    — star, all-to-all, an explicit edge list, or the acceptance-rate-
    adaptive policy; see ``topology.py``) — each migrant is re-scored on the
    recipient's suite and accepted only on strict improvement (cross-suite
    migration is exactly the paper's §4.3 transfer: an MHA-evolved genome
    warm-starts the GQA island), and every attempt is recorded in a
    :class:`~repro_torch.core.topology.MigrationStats` acceptance ledger that
    adaptive topologies learn from;
  * **publishes** island-local refuted-edit memory into the shared
    :class:`RefutedMemory`, so an edit one island has falsified is never
    re-trialled on another;
  * **persists** the whole archipelago (aggregate JSON + one file per island)
    with atomic replace — lineages, the shared refuted-edit memory, per-island
    supervisor counters, the migration-acceptance ledger, the topology's own
    state, and rung 0's machine — so a killed run resumes exactly where it
    stopped and makes the same migration decisions an uninterrupted run would
    have made.

Candidate evaluation goes through the port's evaluation backends
(``repro_torch.core.evals``): all islands on one suite share one backend —
``thread`` (shared memo cache + in-process executor, the default),
``process`` (one warm worker-process pool shared by every suite), ``service``
(one :class:`~repro_torch.core.evals.EvalCoordinator` fanning every suite's
batches out over TCP to a registered worker fleet), or ``inline`` — and
island epochs themselves run on a thread pool.  At rung 0 backends are
bit-identical, so the choice changes wall-clock only, never lineages.
Every evaluation scores where ``EvalConfig.device`` says (``None``: the card,
where each island's correctness gate runs the hand-written flash-attention
kernel under the card's lock; ``"cpu"``: its plain PyTorch version), with
rung 0's model named by ``EvalConfig.machine`` (``None``: the reference's
TPU v5e model; ``"h100"``: the model of the port's kernel on the card).  Each
island's knowledge base holds that machine's facts
(:func:`~repro_torch.core.knowledge_h100.knowledge_for`).  The kernel and
every in-process scorer's proxy inputs are built in the constructing thread,
before any island thread starts.  ``Archipelago.from_registry()``
auto-scales one specialist island per suite registered in ``perfmodel``
(``register_suite``).

**Pipelined stepping** (``pipeline=True``): each island step splits into a
*proposal* phase — the operator's likely candidate walk is submitted to the
backend's async surface (``EvalBackend.submit``) up front, so workers
evaluate the whole batch concurrently — and a *harvest* phase that runs the
authoritative (serial, seeded) variation walk, whose evaluations collapse
onto the in-flight futures.  Commits therefore land in the operator's
deterministic walk order regardless of completion order, and after its last
epoch step each island proposes its NEXT step before the barrier, so scoring
futures span migration.  Proposals are pure cache warming, so pipelined
lineages are bit-identical to the barrier engine's.  Pair it with an elastic
process pool (``backend="process", elastic_workers=N`` →
:class:`~repro_torch.core.evals.ElasticProcessPool`) and with
``prefetch_budget=`` — a shared speculative-evaluation budget re-divided
across islands each epoch from the KB's predicted-gain distributions
(:class:`PrefetchAllocator`).

Determinism: operators are seeded per island, the Scorer is a deterministic
function of the genome at rung 0, and refuted-memory sharing is synchronized
at the epoch barrier — during an epoch each island reads a *frozen snapshot*
of the shared memory plus its own additions (:class:`EpochMemoryView`), so
results do not depend on thread scheduling.  A fixed seed reproduces the same
per-island lineages, commit for commit — pipelined or not, on the card or on
the CPU.

**The evaluation cascade** (``cascade_eta``): at every epoch barrier each
island's slate runs successive halving over the fidelity ladder (rung 0 on
its own backend, rung 1 the full-shape launch counted in the kernel's
walk, rung 2 the kernel timed on the card), and rung-2 residuals calibrate
rung 0's promotion ranking.  On the CPU a cascade runs rungs 0-1.  Lineage commits
are scored at rung 0, as in the reference: the cascade only decides where
card time is bought.

``ContinuousEvolution`` (evolution.py) is the single-island special case of
:class:`Island` + this engine's serial loop.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

from repro_torch.core import obs
from repro_torch.core.config import EngineConfig, engine_config_from_legacy
from repro_torch.core.evals import (PERFMODEL, BatchScorer, CascadeBackend,
                                    ElasticProcessPool, EvalCoordinator,
                                    EvalSpec, backend_info, make_backend,
                                    make_process_executor, stop_local_workers)
from repro_torch.core.evals.cascade import ladder, rung_spec
from repro_torch.core.evals.protocol import parse_address
from repro_torch.core.evals.scorer import default_machine
from repro_torch.core.evals.worker import prepare_parent
from repro_torch.core.knowledge import KnowledgeBase, suggestion_sort_key
from repro_torch.core.knowledge_h100 import knowledge_for
from repro_torch.core.perfmodel import (PerfModelCalibration,
                                        registered_suites, suite_by_name)
from repro_torch.core.population import Commit, Lineage, atomic_write_json
from repro_torch.core.search_space import KernelGenome, seed_genome
from repro_torch.core.supervisor import Supervisor
from repro_torch.core.toolbelt import RefutedMemory, Toolbelt
from repro_torch.core.topology import MigrationStats, make_topology
from repro_torch.core.variation import make_operator

ARCHIPELAGO_FORMAT = "archipelago.v1"


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


@dataclass
class IslandReport:
    """Aggregate + per-island accounting for one engine run.

    Aggregate counters (commits, steps, internal_attempts, evaluations,
    cache_hits) are deltas for THIS run() call; the per-island
    EvolutionReports carry island-lifetime numbers (incl. resumed commits).
    """
    islands: dict                 # name -> EvolutionReport
    commits: int
    steps: int
    internal_attempts: int
    migrations_accepted: int
    best_island: str
    best_geomean: float
    coverage_geomean: float
    evaluations: int
    cache_hits: int
    wall_seconds: float
    proposed: int = 0             # speculative proposal-phase submissions
    eval_workers: dict = field(default_factory=dict)  # suite -> pool width
    eval_pool: dict = field(default_factory=dict)     # elastic pool stats
    score_caches: dict = field(default_factory=dict)  # suite -> ScoreCache.stats()
    cascade: dict = field(default_factory=dict)       # cascade totals + factors
    commit_events_dropped: int = 0    # commit-event ring overflow (bounded window)


class EpochMemoryView:
    """Island-local view over a shared :class:`RefutedMemory`.

    Reads see the shared set as frozen at the last epoch barrier, plus this
    island's own additions; writes stay local until :meth:`publish`.  This
    keeps cross-island memory sharing deterministic under threading: what an
    island knows depends only on the epoch number, never on thread timing.
    """

    def __init__(self, shared: RefutedMemory):
        self.shared = shared
        self._frozen = shared.snapshot()
        self._local: set = set()
        self.notes: list[str] = []

    def add(self, entry, note: str = "") -> None:
        self._local.add(entry)
        if note:
            self.notes.append(note)

    def __contains__(self, entry) -> bool:
        return entry in self._local or entry in self._frozen

    def __len__(self) -> int:
        return len(self._local) + sum(1 for e in self._frozen
                                      if e not in self._local)

    def publish(self) -> None:
        """Epoch barrier: push local refutations into the shared memory and
        re-freeze against everything published so far."""
        self.shared.merge(self._local)
        self._local.clear()
        self._frozen = self.shared.snapshot()

    def refreeze(self) -> None:
        """Re-snapshot the shared memory without publishing — used after
        resume restores the shared set underneath already-built views."""
        self._frozen = self.shared.snapshot()


@dataclass
class IslandSpec:
    """Declarative island description; the engine builds the machinery."""
    name: str = ""
    operator: Union[str, object] = "avo"      # avo | single-shot | pes | instance
    target_suite: Optional[str] = None        # perfmodel suite name; None = engine default
    init_genome: Optional[KernelGenome] = None  # diverse initialization point
    agent_kwargs: dict = field(default_factory=dict)


class Island:
    """One lineage + its operator, supervisor, and toolbelt.

    ``ContinuousEvolution`` wraps exactly one of these; ``IslandEvolution``
    schedules N of them against shared scoring/memory.
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


def default_specs(n_islands: int, seed: int = 0) -> list[IslandSpec]:
    """Homogeneous-suite default: AVO everywhere, diverse initialization.

    Island 0 starts from the paper's naive-but-correct x0; the others start
    from distinct single-field neighbours of x0 (standard island-model diverse
    init), chosen deterministically from the seed.
    """
    import random
    inits = [None,
             seed_genome().with_(kv_in_grid=True),
             seed_genome().with_(mask_mode="block_skip"),
             seed_genome().with_(rescale_mode="branchless"),
             seed_genome().with_(block_q=256),
             seed_genome().with_(div_mode="deferred"),
             seed_genome().with_(block_k=256),
             seed_genome().with_(block_q=64)]
    rng = random.Random(seed)
    order = inits[1:]
    rng.shuffle(order)
    pool = [None] + order
    return [IslandSpec(name=f"island{i}",
                       init_genome=pool[i % len(pool)])
            for i in range(n_islands)]


def scenario_specs() -> list[IslandSpec]:
    """Scenario-sweep preset: one specialist island per suite family."""
    return [
        IslandSpec(name="mha", target_suite="mha"),
        IslandSpec(name="gqa", target_suite="gqa"),
        IslandSpec(name="decode", target_suite="decode"),
        IslandSpec(name="mha-explorer", target_suite="mha",
                   init_genome=seed_genome().with_(kv_in_grid=True)),
    ]


class PrefetchAllocator:
    """Shared speculative-evaluation budget, re-divided across islands every
    epoch from each island's predicted-gain distribution.

    Per island the *desired* speculation depth is the smallest candidate-walk
    prefix whose cumulative commit probability reaches ``commit_target``,
    modelling each suggestion's clamped predicted gain as its commit
    probability: a front-loaded gain profile (top candidate dominates) wants
    a shallow batch, a flat/low profile (the agent will walk deep before
    giving up) wants a deep one.  Desired depths are then fit into the shared
    ``total`` budget by largest-remainder apportionment with a deterministic
    name tie-break — allocation is a pure function of the gain profiles, so
    it can never perturb the (already speculation-proof) search.
    """

    def __init__(self, total: int, commit_target: float = 0.8,
                 max_gain: float = 0.95):
        if total < 1:
            raise ValueError(f"prefetch budget must be >= 1, got {total}")
        self.total = total
        self.commit_target = commit_target
        self.max_gain = max_gain

    def desired_depth(self, gains: Sequence[float]) -> int:
        """How deep the operator is likely to walk before committing."""
        if not gains:
            return 1                  # nothing known: speculate the minimum
        p_miss = 1.0
        for d, g in enumerate(gains, start=1):
            p_miss *= 1.0 - min(max(g, 0.0), self.max_gain)
            if 1.0 - p_miss >= self.commit_target:
                return d
        return len(gains)

    def allocate(self, profiles: dict) -> dict:
        """``{island name -> gain profile}`` to ``{island name -> prefetch_k}``,
        summing to at most ``total``."""
        desired = {name: self.desired_depth(g) for name, g in profiles.items()}
        want = sum(desired.values())
        if want <= self.total:
            return desired
        quotas = {name: self.total * d / want for name, d in desired.items()}
        alloc = {name: int(q) for name, q in quotas.items()}
        leftovers = self.total - sum(alloc.values())
        # largest fractional remainder first; names break ties determinist-
        # ically so equal remainders never depend on dict iteration order
        order = sorted(quotas, key=lambda n: (-(quotas[n] - alloc[n]), n))
        for name in order[:leftovers]:
            alloc[name] += 1
        return alloc


class IslandEvolution:
    """N-island parallel evolution engine (see module docstring)."""

    def __init__(self, config: Optional[EngineConfig] = None, *,
                 on_commit: Optional[Callable[[dict], None]] = None,
                 **legacy):
        """The supported construction is ``IslandEvolution(config=
        EngineConfig(...))`` — see :mod:`repro_torch.core.config` for the
        three dataclasses (engine / evals / migration).  The historical flat
        kwargs (``backend=``, ``topology=``, ``n_islands=``, ``device=``, ...)
        keep working through a mapping shim that emits one DeprecationWarning
        per alias; ``EngineConfig.from_kwargs(**flat)`` is the warning-free
        flat spelling.  ``on_commit`` is a runtime hook (never persisted):
        called with every commit-event dict (``{"t", "island", "geomean",
        "values"}``) as islands commit.

        ``evals.device`` is where every evaluation scores (``None``: the
        card, which must be present; ``"cpu"``: the plain PyTorch path), and
        ``evals.machine`` rung 0's model (``None``: ``"tpu_v5e"``, the
        reference's, for lineage parity; ``"h100"``: the model of the port's
        kernel).  Both reach every suite's spec, so worker processes score
        where the engine does.  Each island plans from that machine's facts.

        ``prefetch`` > 0 speculatively batch-evaluates that many KB
        candidate edits per island step on the scorer executor (cache warming
        only — lineages are identical with or without it).

        ``backend`` selects the evaluation service: 'thread' (shared
        in-process executor, the default), 'process' (one warm worker-process
        pool shared by every suite), 'service' (scoring over socket workers;
        see ``service_workers``), or 'inline'.  At rung 0 backends are
        bit-identical, so lineages do not depend on the choice.
        ``max_workers`` sizes the island and scorer thread pools (default
        ``min(8, islands)``) and, in the port, the fixed process pool
        (default: 2 on the card, the CPU count elsewhere).

        ``topology`` selects the migration graph walked at each epoch
        barrier: 'ring' (the default), 'star', 'all-to-all', 'adaptive'
        (acceptance-rate EMA pruning + seeded edge trials), or any
        :class:`~repro_torch.core.topology.MigrationTopology` instance.

        ``pipeline`` switches islands from step-blocking to propose ->
        submit -> harvest stepping (see the module docstring).
        Bit-identical lineages; wall-clock and paid-evaluation counts may
        differ.

        ``elastic_workers`` > 0 (process backend only) replaces the fixed
        worker pool with an :class:`~repro_torch.core.evals.ElasticProcessPool`
        capped at that many workers, growing/shrinking with queue depth.

        ``prefetch_budget`` sets a *shared* speculative-evaluation budget:
        every epoch a :class:`PrefetchAllocator` re-divides it into
        per-island ``prefetch_k`` caps from the KB's predicted-gain
        distributions (replacing the static ``prefetch`` constant).

        ``backend='service'`` scores over the evaluation service: the engine
        hosts one :class:`~repro_torch.core.evals.EvalCoordinator` shared by
        every suite's backend, and ``service_workers`` > 0 spawns that many
        localhost worker processes against it (with 0, external workers must
        ``--connect`` to ``engine.service_coordinator.address`` before
        stepping can proceed).  ``service_listen`` binds the coordinator.
        Worker death mid-run is transparent: in-flight evaluations are
        requeued onto survivors.

        ``migrant_policy`` sets what a donor island sends along each
        migration edge: ``'best'`` (the default — its single best commit)
        or ``'top-k'`` (its ``migrant_k`` best distinct genomes; the
        recipient re-scores all of them on its own suite and adopts the best
        survivor).

        ``cascade_eta`` (>= 2) turns on the multi-fidelity evaluation
        cascade: every epoch barrier, each island's candidate slate (its
        best genome + up to ``cascade_slate`` KB suggestions) runs
        successive halving across the fidelity ladder — the whole slate at
        rung 0 (``perfmodel``, through the island's own backend, so it is
        pure cache warming), the top ``1/eta`` at rung 1 (``hlo``: the
        full-shape launch counted in the kernel's physical walk),
        the top ``1/eta`` of that at rung 2 (``measured``: the kernel timed
        on the card, planned from the card's model) — and measured-vs-
        predicted residuals feed a per-bottleneck-class EMA correction that
        sharpens rung-0 promotion ranking over the run
        (:class:`~repro_torch.core.perfmodel.PerfModelCalibration`;
        persisted in the archipelago payload with the promotion log).  With
        ``device="cpu"`` the ladder stops at rung 1.  ``cascade_promote=
        False`` keeps the cascade at rung 0 only.  Lineage commits are
        *never* scored above rung 0; the cascade only decides where
        expensive signal is bought."""
        if config is not None and legacy:
            raise TypeError(
                "pass either config=EngineConfig(...) or the legacy flat "
                f"kwargs, not both (got config and {sorted(legacy)})")
        if config is None:
            config = engine_config_from_legacy(legacy)
        self.config = config
        self._on_commit = on_commit
        ev, mig = config.evals, config.migration
        n_islands, specs, suite = config.n_islands, config.specs, config.suite
        seed = config.seed
        max_workers = config.max_workers
        backend = ev.backend
        self.specs = list(specs) if specs is not None else \
            default_specs(n_islands, seed=seed)
        if not self.specs:
            raise ValueError("need at least one island "
                             f"(n_islands={n_islands}, specs={specs})")
        self.migration_interval = max(1, mig.interval)
        self.persist_path = config.persist_path
        self.seed = seed
        self.pipeline = config.pipeline
        if ev.elastic_workers and backend != "process":
            raise ValueError("elastic_workers requires backend='process' "
                             f"(got backend={backend!r})")
        if ev.service_workers and backend != "service":
            raise ValueError("service_workers requires backend='service' "
                             f"(got backend={backend!r})")
        if mig.migrant_policy not in ("best", "top-k"):
            raise ValueError(f"unknown migrant_policy {mig.migrant_policy!r}; "
                             "known: 'best', 'top-k'")
        if mig.migrant_k < 1:
            raise ValueError(f"migrant_k must be >= 1, got {mig.migrant_k}")
        self.migrant_policy = mig.migrant_policy
        self.migrant_k = mig.migrant_k
        if ev.cascade_eta is not None and ev.cascade_eta < 2:
            raise ValueError(f"cascade_eta must be >= 2, got {ev.cascade_eta}")
        if ev.cascade_slate < 1:
            raise ValueError(f"cascade_slate must be >= 1, got {ev.cascade_slate}")
        self.cascade_eta = ev.cascade_eta
        self.cascade_slate = ev.cascade_slate
        self.cascade_promote = ev.cascade_promote
        self.calibration = PerfModelCalibration()
        self.cascade_log: list[dict] = []
        # rung 0's model: what every lineage of this engine is scored under,
        # recorded in the payload so a resume never mixes two machines
        self.machine = ev.machine or default_machine(PERFMODEL)
        self._prefetch_allocator = (PrefetchAllocator(config.prefetch_budget)
                                    if config.prefetch_budget is not None
                                    else None)
        self.memory = RefutedMemory()
        self.migrations_accepted = 0
        self.topology = make_topology(mig.topology, seed=seed)
        self.migration_stats = MigrationStats()
        # bounded commit-event window: iteration/len/indexing work as on a
        # list; shed history is counted in .dropped
        self.commit_events = obs.EventRing(
            cap=int(os.environ.get("REPRO_OBS_COMMIT_CAP", obs.DEFAULT_CAP)))
        self._t0 = None

        n = len(self.specs)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers or min(8, n), thread_name_prefix="island")
        self._scorer_pool = scorer_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers or min(8, n), thread_name_prefix="scorer")
        self._process_pool = None

        # resolve every distinct suite up front: the process pool must be
        # warm-initialized with all of them before its workers start
        suite_cfgs: dict[str, Optional[list]] = {}
        for spec in self.specs:
            key = spec.target_suite or "default"
            if key not in suite_cfgs:
                suite_cfgs[key] = (suite_by_name(spec.target_suite)
                                   if spec.target_suite else suite)

        # one shared backend per distinct suite, all on one executor; the
        # name -> backend dispatch lives in evals.make_backend alone
        self.backend = backend
        self.scorers: dict[str, object] = {}
        eval_specs = {
            key: EvalSpec.resolve(cfgs, check_correctness=ev.check_correctness,
                                  device=ev.device, machine=ev.machine)
            for key, cfgs in suite_cfgs.items()}
        # higher-fidelity rungs of each suite (cascade only): correctness was
        # already verified at rung 0, so the expensive rungs skip it
        rung_specs = {
            key: [rung_spec(dataclasses.replace(espec, check_correctness=False), f)
                  for f in ladder(espec)[1:]]
            for key, espec in eval_specs.items()} if ev.cascade_eta else {}
        warm_specs = tuple(eval_specs.values()) + tuple(
            s for rungs in rung_specs.values() for s in rungs)
        # which shared resource this backend wants injected is registry
        # metadata, not a name branch — raises the stable 'unknown eval
        # backend' ValueError for unregistered names
        info = backend_info(backend)
        if info.executor == "process":
            # elastic: capacity follows queue depth (the pipelined proposal
            # bursts); fixed: a warm pool sized once (max_workers, or the
            # default width for the specs' device)
            self._process_pool = (
                ElasticProcessPool(warm_specs, max_workers=ev.elastic_workers)
                if ev.elastic_workers else
                make_process_executor(warm_specs, max_workers=max_workers))
        # cross-host scoring: ONE coordinator (worker fleet) serves every
        # suite's backend — tasks carry their spec, workers warm per spec.
        # An injected coordinator (EvalConfig.coordinator) is shared, never
        # owned: close() leaves it running.
        self.service_coordinator = ev.coordinator
        self._own_coordinator = False
        self._service_procs: list = []
        if info.needs_coordinator and self.service_coordinator is None:
            self.service_coordinator = EvalCoordinator(
                *parse_address(ev.service_listen))
            self._own_coordinator = True
            if ev.service_workers:
                try:
                    prepare_parent(warm_specs)
                except Exception:
                    self.service_coordinator.close()
                    raise
                # on timeout this closes the coordinator + stops the procs
                self._service_procs = self.service_coordinator.spawn_workers(
                    ev.service_workers, device=ev.device)
        self.cascades: dict[str, CascadeBackend] = {}
        for key, espec in eval_specs.items():
            extra: dict = {}
            if info.executor == "process":
                extra["executor"] = self._process_pool
            elif info.executor == "thread":
                extra["executor"] = scorer_pool
            if info.needs_coordinator:
                extra["coordinator"] = self.service_coordinator
                if ev.tenant:
                    extra["tenant"] = ev.tenant
            sc = self.scorers[key] = make_backend(backend, suite=espec, **extra)
            if ev.cascade_eta:
                # sibling rung backends share the rung-0 cache (fidelity-
                # prefixed keys keep rungs from aliasing) and the same
                # executor/coordinator, so the cascade adds no new pools
                rungs = [sc] + [
                    make_backend(backend, suite=rspec, cache=sc.cache, **extra)
                    for rspec in rung_specs[key]]
                self.cascades[key] = CascadeBackend(
                    rungs, eta=ev.cascade_eta, calibration=self.calibration)
        self._warm(warm_specs)

        def scorer_for(suite_name: Optional[str]):
            return self.scorers[suite_name or "default"]

        self.islands: list[Island] = []
        for i, spec in enumerate(self.specs):
            name = spec.name or f"island{i}"
            agent_kwargs = dict(spec.agent_kwargs)
            if spec.init_genome is not None and "seed" not in agent_kwargs:
                agent_kwargs["seed"] = spec.init_genome
            operator = make_operator(spec.operator, seed=seed + i,
                                     agent_kwargs=agent_kwargs)
            scorer = scorer_for(spec.target_suite)
            self.islands.append(Island(
                name=name,
                scorer=scorer,
                operator=operator,
                supervisor=Supervisor(patience=config.supervisor_patience,
                                      focus_offset=i),
                kb=knowledge_for(scorer.plan_machine),
                memory=EpochMemoryView(self.memory),
                persist_path=self._island_path(name),
                on_commit=self._record_commit,
                prefetch_k=config.prefetch,
                pipeline=self.pipeline))
        self._allocate_prefetch()     # epoch-0 budget (no-op without one)

    def _warm(self, specs: Sequence[EvalSpec]) -> None:
        """Pay every first use of the card in the constructing thread,
        before any island or scorer thread starts: the kernel built and
        loaded (``prepare_parent``; a no-op for CPU specs, a raise for a
        card spec on a host without one), and the proxy inputs of every
        in-process scorer and the full-shape inputs of every in-process
        rung-2 scorer (the thread backend builds its own at construction;
        pooled backends' workers warm in their initializers).  Rung 1
        builds nothing on the card."""
        prepare_parent(specs)
        rungs = [r for c in self.cascades.values() for r in c.rungs[1:]]
        for sc in list(self.scorers.values()) + rungs:
            warm = getattr(sc, "warm", None)
            if warm is not None:
                warm()

    # -- persistence paths --------------------------------------------------------
    def _island_path(self, name: str) -> Optional[str]:
        if not self.persist_path:
            return None
        root, ext = os.path.splitext(self.persist_path)
        return f"{root}.{name}{ext or '.json'}"

    # -- event log (bench instrumentation) ---------------------------------------
    def _record_commit(self, island: Island) -> None:
        b = island.lineage.best()
        event = {
            "t": 0.0 if self._t0 is None else time.time() - self._t0,
            "island": island.name,
            "geomean": island.best_geomean(),
            "values": tuple(b.values) if b else (),
        }
        self.commit_events.append(event)
        if obs.enabled():
            # the bus/journal record stitches to the harvest walk's trace
            # (commit runs inside the operator walk, so the TLS binding from
            # Island.harvest is still live here)
            obs.publish("commit", trace=obs.current_trace(),
                        island=island.name, geomean=event["geomean"])
        if self._on_commit is not None:
            # runtime observer (the frontier's event stream); an observer
            # failure must never poison the island's stepping thread
            try:
                self._on_commit(dict(event))
            except Exception:
                pass

    # -- aggregate metrics --------------------------------------------------------
    def best(self) -> tuple[Optional[str], Optional[Commit]]:
        """Global best commit across islands (by the island's own suite)."""
        winner, commit = None, None
        for isl in self.islands:
            b = isl.lineage.best()
            if b is not None and (commit is None or b.geomean > commit.geomean):
                winner, commit = isl.name, b
        return winner, commit

    def best_geomean(self) -> float:
        _, c = self.best()
        return c.geomean if c else 0.0

    def coverage_values(self) -> list[float]:
        """Per-config throughput under each config's OWNING island's best
        genome — the scenario-coverage vector.  Islands sharing one suite are
        deduplicated: the suite's owner is its best-scoring island, so each
        config contributes exactly once."""
        best_per_suite: dict[int, tuple[float, Optional[Commit], Island]] = {}
        for isl in self.islands:
            key = id(isl.scorer)      # one shared scorer per distinct suite
            b = isl.lineage.best()
            gm = b.geomean if b else 0.0
            cur = best_per_suite.get(key)
            if cur is None or gm > cur[0]:
                best_per_suite[key] = (gm, b, isl)
        out: list[float] = []
        for _, b, isl in best_per_suite.values():
            out.extend(b.values if b else [0.0] * len(isl.scorer.suite))
        return out

    def coverage_geomean(self) -> float:
        import math
        vals = self.coverage_values()
        if not vals or any(v <= 0 for v in vals):
            return 0.0
        return math.exp(sum(math.log(v) for v in vals) / len(vals))

    # -- the engine loop ----------------------------------------------------------
    def run(self, max_steps: int = 40,
            target_commits: Optional[int] = None,
            wall_budget_s: Optional[float] = None,
            verbose: bool = False) -> IslandReport:
        """Run every island for up to ``max_steps`` steps (per island), with a
        migration + memory-publish barrier every ``migration_interval`` steps."""
        t0 = time.time()
        self._t0 = t0 if self._t0 is None else self._t0
        # an obs-enabled run always journals — no extra setup at call sites
        # (no-op when disabled or when a journal is already attached)
        obs.ensure_journal()
        start_steps = [isl.steps for isl in self.islands]
        start_commits = sum(len(isl.lineage) for isl in self.islands)
        start_attempts = sum(isl.internal_attempts for isl in self.islands)
        start_evals = sum(s.n_evaluations for s in self.scorers.values())
        start_hits = sum(s.cache_hits for s in self.scorers.values())
        start_proposed = sum(isl.proposed for isl in self.islands)
        self._bootstrap_batch()
        done = 0
        while done < max_steps:
            if wall_budget_s is not None and time.time() - t0 > wall_budget_s:
                break
            if target_commits is not None and \
                    sum(len(isl.lineage) for isl in self.islands) \
                    - start_commits >= target_commits:
                break
            chunk = min(self.migration_interval, max_steps - done)
            # pipelined: after its last step of the epoch each island
            # proposes its NEXT step, so those scoring futures evaluate in
            # the workers while the barrier migrates (nothing waits on them)
            ahead = self.pipeline and done + chunk < max_steps

            def epoch(island, k=chunk, propose_ahead=ahead):
                for _ in range(k):
                    island.step()
                if propose_ahead:
                    island.propose()

            futures = [self._pool.submit(epoch, isl) for isl in self.islands]
            for f in futures:
                f.result()
            done += chunk
            self._epoch_barrier()
            if verbose:
                name, b = self.best()
                # routed through the console sink so the journal records the
                # same line the terminal shows — they can't disagree
                obs.narrate(
                    f"[epoch @{done:3d} steps/island] "
                    f"best={b.geomean if b else 0:.1f} "
                    f"TFLOPS on {name}  coverage={self.coverage_geomean():.1f} "
                    f"migrations={self.migrations_accepted}",
                    epoch=done, island=name,
                    best=b.geomean if b else 0.0,
                    migrations=self.migrations_accepted)

        wall = time.time() - t0
        name, b = self.best()
        return IslandReport(
            islands={isl.name: isl.report(wall) for isl in self.islands},
            commits=sum(len(isl.lineage) for isl in self.islands) - start_commits,
            steps=sum(isl.steps - s0 for isl, s0 in
                      zip(self.islands, start_steps)),
            internal_attempts=sum(isl.internal_attempts
                                  for isl in self.islands) - start_attempts,
            migrations_accepted=self.migrations_accepted,
            best_island=name or "", best_geomean=b.geomean if b else 0.0,
            coverage_geomean=self.coverage_geomean(),
            evaluations=sum(s.n_evaluations
                            for s in self.scorers.values()) - start_evals,
            cache_hits=sum(s.cache_hits
                           for s in self.scorers.values()) - start_hits,
            wall_seconds=wall,
            proposed=sum(isl.proposed for isl in self.islands) - start_proposed,
            eval_workers={key: getattr(s, "max_workers", None)
                          for key, s in self.scorers.items()},
            eval_pool=(self._process_pool.stats()
                       if isinstance(self._process_pool, ElasticProcessPool)
                       else self.service_coordinator.stats()
                       if self.service_coordinator is not None
                       else {}),
            score_caches={key: s.cache.stats()
                          for key, s in self.scorers.items()
                          if hasattr(getattr(s, "cache", None), "stats")},
            cascade=self.cascade_totals(),
            commit_events_dropped=self.commit_events.dropped)

    def _bootstrap_batch(self) -> None:
        """Batch-evaluate the starting genomes of all not-yet-seeded islands
        through their shared scorers' executors — the suites' first (and
        coldest) evaluations overlap instead of serializing."""
        by_scorer: dict[int, tuple[BatchScorer, list[KernelGenome]]] = {}
        for isl, spec in zip(self.islands, self.specs):
            if len(isl.lineage) or not hasattr(isl.scorer, "map"):
                continue
            genomes = by_scorer.setdefault(id(isl.scorer), (isl.scorer, []))[1]
            genomes.append(spec.init_genome if spec.init_genome is not None
                           else seed_genome())
        futures = [self._pool.submit(scorer.map, genomes)
                   for scorer, genomes in by_scorer.values()]
        for f in futures:
            f.result()

    def _allocate_prefetch(self) -> None:
        """Re-divide the shared speculative-evaluation budget into per-island
        ``prefetch_k`` caps from the KB's predicted-gain distributions.  A
        pure function of cached state — never pays an evaluation, never
        perturbs the search."""
        if self._prefetch_allocator is None:
            return
        alloc = self._prefetch_allocator.allocate(
            {isl.name: isl.gain_profile() for isl in self.islands})
        for isl in self.islands:
            # both knobs: prefetch_cap caps pipelined proposals (where an
            # allocated 0 must mean ZERO, not "uncapped"), prefetch_k sizes
            # the barrier-mode KB prefetch
            isl.prefetch_cap = isl.prefetch_k = alloc.get(isl.name, 0)

    def _cascade_slate(self, island: Island) -> list[KernelGenome]:
        """The candidate slate one island feeds the cascade: its current best
        plus the KB's top suggested edits, deterministically ordered
        (``suggestion_sort_key``) and capped at ``cascade_slate``.  A pure
        function of the lineage + KB state the payload persists, so a
        resumed run rebuilds the identical slate."""
        best = island.lineage.best()
        if best is None:
            return []
        sv = island.scorer(best.genome)              # cached after stepping
        if not sv.correct:
            return [best.genome]
        sugg = island.kb.suggestions(best.genome, sv, island.scorer.suite,
                                     sv.dominant_bottleneck(), count=False)
        sugg = sorted(sugg, key=suggestion_sort_key)[:self.cascade_slate]
        return [best.genome] + [best.genome.with_(**s.edit) for s in sugg]

    def _run_cascades(self) -> None:
        """One successive-halving pass per island, in island order (the
        calibration EMA update order is part of the replayed decision
        sequence).  Rung-0 scoring goes through each island's own backend —
        pure cache warming — so lineages never depend on this running."""
        if not self.cascades:
            return
        epoch = len(self.cascade_log) and self.cascade_log[-1]["epoch"] + 1
        for isl, spec in zip(self.islands, self.specs):
            cascade = self.cascades[spec.target_suite or "default"]
            log = cascade.run_cascade(self._cascade_slate(isl),
                                      promote=self.cascade_promote)
            self.cascade_log.append({"epoch": int(epoch), "island": isl.name,
                                     **log})

    def cascade_totals(self) -> dict:
        """Aggregate cascade accounting (per-rung eval counts over all epochs
        + current calibration factors) for reports and benchmarks."""
        if not self.cascades:
            return {}
        totals: dict[str, int] = {}
        for entry in self.cascade_log:
            for fid, n in entry["evals"].items():
                totals[fid] = totals.get(fid, 0) + n
        return {"eta": self.cascade_eta, "epochs": len(self.cascade_log),
                "evals": totals, "calibration": self.calibration.state()}

    def _epoch_barrier(self) -> None:
        """Epoch barrier: publish refuted memory, run the evaluation cascade,
        migrate along the topology's edges (each migrant re-scored on the
        recipient's scorer, in this thread), record acceptance per edge,
        re-divide the speculative-prefetch budget, persist.  Nothing here
        waits on scoring futures — in pipelined mode each island's next-step
        proposals keep evaluating in the workers while this runs."""
        for isl in self.islands:
            mem = isl.tools.memory_refuted
            if isinstance(mem, EpochMemoryView):
                mem.publish()
        self._run_cascades()
        stats = self.migration_stats
        stats.island_best = [isl.best_geomean() for isl in self.islands]
        edges = self.topology.edges(len(self.islands), stats)
        if edges:
            # snapshot donor payloads first so a hop this epoch can't chain
            # N times; 'best' keeps the historical single-commit path
            if self.migrant_policy == "top-k":
                donations = [isl.lineage.top(self.migrant_k)
                             for isl in self.islands]
                bests = None
            else:
                donations = None
                bests = [isl.lineage.best() for isl in self.islands]
            for src, dst in edges:
                if src == dst:
                    continue               # self-migration is meaningless
                if donations is None:
                    b = bests[src]
                    if b is None:
                        continue           # nothing to donate: not an attempt
                    accepted = self.islands[dst].accept_migrant(
                        b, self.islands[src].name)
                else:
                    donated = donations[src]
                    if not donated:
                        continue
                    accepted = self.islands[dst].accept_migrants(
                        donated, self.islands[src].name)
                stats.record(src, dst, accepted)
                if accepted:
                    self.migrations_accepted += 1
        self._allocate_prefetch()     # budgets follow post-migration profiles
        if self.persist_path:
            self.save(self.persist_path)

    # -- persistence ----------------------------------------------------------------
    def save(self, path: str) -> None:
        payload = {
            "format": ARCHIPELAGO_FORMAT,
            "seed": self.seed,
            # rung 0's model: load_state adopts no history scored under
            # another machine (the device does not matter: card and CPU
            # gates agree)
            "machine": self.machine,
            # the construction config rides along (runtime-only fields
            # excluded), so resume(path) can rebuild the engine from the
            # payload alone — kwarg-path saves resume under the config path
            "config": self.config.to_payload(),
            "migration_interval": self.migration_interval,
            "migrations_accepted": self.migrations_accepted,
            "topology": {"name": getattr(self.topology, "name", "custom"),
                         "state": self.topology.state()},
            "migration_stats": self.migration_stats.to_payload(),
            "refuted": self.memory.to_payload(),
            # calibration factors must survive kill/resume bit-exactly, or a
            # resumed cascade would rank (and so promote) differently; the
            # log tail is observability only
            "cascade": {"calibration": self.calibration.state(),
                        "log": self.cascade_log[-64:]} if self.cascades else {},
            "islands": [
                {"name": isl.name,
                 "suite": spec.target_suite or "default",
                 "operator": (spec.operator if isinstance(spec.operator, str)
                              else getattr(spec.operator, "name", "custom")),
                 "supervisor": isl.supervisor.state(),
                 "lineage": isl.lineage.to_payload()}
                for isl, spec in zip(self.islands, self.specs)],
        }
        atomic_write_json(path, payload)

    def load_state(self, path: str) -> None:
        """Restore island lineages (matched by name) from an archipelago file.

        The aggregate file is written at epoch barriers, but each island also
        persists its own lineage on every commit — so after a mid-epoch kill
        the per-island file can be AHEAD of the aggregate.  Whichever is
        longer wins: no durably persisted commit is ever dropped.

        History scored under another rung-0 machine is never adopted, as
        history from another suite is not: a payload whose machine (absent:
        the reference's ``tpu_v5e``) differs from this engine's restores
        nothing, per-island files included, and the engine starts fresh."""
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != ARCHIPELAGO_FORMAT:
            raise ValueError(f"{path}: not an archipelago file")
        if payload.get("machine", default_machine(PERFMODEL)) != self.machine:
            return
        by_name = {d["name"]: d for d in payload["islands"]}
        for isl, spec in zip(self.islands, self.specs):
            suite_names = tuple(c.name for c in isl.scorer.suite)

            def scored_on_this_suite(lineage: Optional[Lineage]) -> bool:
                # never adopt history scored on a different suite: geomeans
                # and value vectors would silently mix incomparable configs
                return lineage is not None and (
                    not lineage.config_names
                    or tuple(lineage.config_names) == suite_names)

            d = by_name.get(isl.name)
            if d is not None and \
                    d.get("suite", "default") != (spec.target_suite or "default"):
                d = None
            if d is not None and "supervisor" in d:
                # stall/refocus counters are part of the search state: without
                # them a resumed run would re-time its interventions
                isl.supervisor.load_state(d["supervisor"])
            restored = Lineage.from_payload(d["lineage"]) if d else None
            if not scored_on_this_suite(restored):
                restored = None
            ip = self._island_path(isl.name)
            if ip and os.path.exists(ip):
                try:
                    per_island = Lineage.load(ip)
                except (OSError, ValueError, KeyError):
                    per_island = None        # torn/foreign file: aggregate wins
                if scored_on_this_suite(per_island) and (
                        restored is None or len(per_island) > len(restored)):
                    restored = per_island
            if restored is not None:
                isl.lineage.commits = restored.commits
                isl.lineage.config_names = restored.config_names
        self.migrations_accepted = payload.get("migrations_accepted", 0)
        if "migration_stats" in payload:
            self.migration_stats = MigrationStats.from_payload(
                payload["migration_stats"])
        topo = payload.get("topology")
        if topo and topo.get("name") == getattr(self.topology, "name", None):
            # same policy family: restore its exact decision state (adaptive
            # edge set, EMA epoch counter, trial-schedule position …)
            self.topology.load_state(topo.get("state", {}))
        if "refuted" in payload:
            self.memory.load_payload(payload["refuted"])
            for isl in self.islands:
                mem = isl.tools.memory_refuted
                if isinstance(mem, EpochMemoryView):
                    mem.refreeze()
        cascade = payload.get("cascade") or {}
        if cascade.get("calibration"):
            self.calibration.load_state(cascade["calibration"])
        if cascade.get("log"):
            self.cascade_log = list(cascade["log"])

    @classmethod
    def resume(cls, persist_path: str,
               config: Optional[EngineConfig] = None,
               **kw) -> "IslandEvolution":
        """Rebuild an engine and pick up exactly where a killed run stopped.

        With neither ``config`` nor kwargs, the engine is rebuilt from the
        construction config embedded in the persisted payload (pre-config
        payloads fall back to defaults); an explicit ``config`` or legacy
        kwargs override the persisted one."""
        if config is None and not kw and os.path.exists(persist_path):
            try:
                with open(persist_path) as f:
                    payload = json.load(f)
                if payload.get("format") == ARCHIPELAGO_FORMAT \
                        and "config" in payload:
                    config = EngineConfig.from_payload(payload["config"])
            except (OSError, ValueError, KeyError, TypeError):
                config = None       # torn/pre-config file: default engine
        if config is not None:
            config.persist_path = persist_path
            engine = cls(config=config)
        else:
            engine = cls(persist_path=persist_path, **kw)
        if os.path.exists(persist_path):
            engine.load_state(persist_path)
        return engine

    @classmethod
    def from_registry(cls, suites: Optional[Sequence[str]] = None,
                      **kw) -> "IslandEvolution":
        """Auto-scale the archipelago from the scenario registry: one
        specialist island per registered suite (or per name in ``suites``).
        Registering a new scenario family (``perfmodel.register_suite``) is
        all it takes to get a working specialist island — no engine change.
        Engine kwargs (``topology=``, ``backend=``, …) pass through."""
        names = tuple(suites) if suites is not None else registered_suites()
        if not names:
            raise ValueError("no suites registered")
        specs = [IslandSpec(name=n, target_suite=n) for n in names]
        return cls(specs=specs, **kw)

    def prewarm_eval_pool(self, wait: bool = True) -> None:
        """Block until the process pool's workers are up and warm (an elastic
        pool is first grown to its cap).  Wall-clock only — benchmarks call
        it before a timed window so stepping strategies race on equal footing
        with the thread backend, whose warmup runs at construction.  On the
        service backend, waits for at least the spawned worker fleet."""
        if self.service_coordinator is not None:
            if wait and self._service_procs:
                self.service_coordinator.wait_for_workers(
                    len(self._service_procs), timeout=120.0)
            return
        pool = self._process_pool
        if pool is None:
            return
        if hasattr(pool, "prestart"):
            pool.prestart(wait=wait)
        elif wait:
            from repro_torch.core.evals.worker import _prestart_noop
            n = getattr(pool, "_max_workers", 1)
            concurrent.futures.wait([pool.submit(_prestart_noop)
                                     for _ in range(n)])

    def close(self) -> None:
        for scorer in self.scorers.values():
            scorer.close()
        for cascade in self.cascades.values():
            cascade.close()          # higher rungs; rung-0 close is idempotent
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._scorer_pool.shutdown(wait=True, cancel_futures=True)
        if self._process_pool is not None:
            self._process_pool.shutdown(wait=True, cancel_futures=True)
        if self.service_coordinator is not None and self._own_coordinator:
            # backends share (and so never close) the engine's coordinator;
            # an INJECTED coordinator (EvalConfig.coordinator) belongs to the
            # frontier and outlives every job engine
            self.service_coordinator.close()
            stop_local_workers(self._service_procs)


# the engine's public face in docs/examples: an archipelago of islands
Archipelago = IslandEvolution
