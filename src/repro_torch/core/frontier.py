"""Evolution-as-a-service: the multi-tenant search frontier.

The ROADMAP's north star is an always-on system where many concurrent
clients contend for one accelerator fleet.  PRs 5-7 built the substrate —
an :class:`EvalCoordinator` with a live worker registry, heartbeats,
fault-tolerant requeue, and batched wire frames — and this module adds the
*job* abstraction above it:

  :class:`SearchJob`       what a tenant asks for: suite, evaluation budget,
                           deadline, priority, seed, archipelago shape
  :class:`SearchFrontier`  the long-lived service: accepts jobs from many
                           concurrent clients (over the same length-prefixed
                           frame protocol the workers speak — a HELLO with
                           ``role: "client"``), runs each job as an island
                           archipelago multiplexed over ONE shared worker
                           fleet, and streams :class:`JobEvent` frames back
  :class:`JobEvent`        the streamed lifecycle: accepted, started, lineage
                           commits, budget spend, completion

Scheduling: every job is a coordinator *tenant*.  Queued evaluation slots
are granted weighted-fair by ``granted / weight`` (service.py), and the
frontier re-weights each job at every chunk boundary to ``priority x
remaining budget`` — a high-priority job with budget left outbids a draining
one, jobs queue when ``total_slots`` is saturated, and per-job grant
accounting surfaces in ``stats()``.

Determinism: a job's engine is an ordinary ``IslandEvolution`` with
``backend="service"`` against the shared coordinator (``pipeline=False``,
stepped in migration-interval chunks — chunked ``run()`` calls commit the
identical lineage to one long call because the bootstrap batch re-runs are
cache-warming no-ops).  The scorer is a deterministic function of the
genome, so WHO ELSE shares the fleet, worker death mid-job, and slot-grant
interleaving can change wall-clock and spend pacing only — never the
lineage.  The bench gate holds a frontier job bit-identical to the same
seed run through ``IslandEvolution(backend="service")`` directly.

On the card: a job scores at rung 0 (its ``machine``'s model, the TPU v5e
one by default) and gates every genome on the kernel's fp32 body in a
worker, under ``device.card_lock``, so the sections of every tenant stay
disjoint on the one card; the gate's verdicts on the card equal the CPU's,
so the determinism above holds there too.  ``SearchJob.device`` says where
a job scores (``None``: the card) and ``SearchFrontier(device=)`` where its
own workers do; a job asked for the card on a host without one fails, and
nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

from repro_torch.core import obs
from repro_torch.core.config import EngineConfig, EvalConfig, MigrationConfig
from repro_torch.core.evals import protocol
from repro_torch.core.evals.backends import backend_info, register_backend
from repro_torch.core.evals.service import (ClientSession, EvalCoordinator,
                                            ServiceBackend, stop_local_workers)
from repro_torch.core.evals.worker import EvalSpec, prepare_parent
from repro_torch.core.islands import IslandEvolution
from repro_torch.core.perfmodel import suite_by_name

__all__ = ["JobEvent", "SearchFrontier", "SearchJob", "lineage_fingerprint"]


@dataclass(frozen=True)
class SearchJob:
    """One tenant's search request.

    ``suite`` names a registered scenario suite (None = engine default);
    ``budget`` caps *paid* evaluations (None = unbounded); ``deadline_s``
    caps wall-clock from job start; ``priority`` scales the job's weighted-
    fair share of the fleet; ``backend`` names an evals-registry backend for
    the job engine (must be coordinator-capable — it scores against the
    frontier's shared fleet); ``device`` is where the job scores (``None``:
    the card) and ``machine`` rung 0's model (``None``: ``tpu_v5e``); the
    rest shapes the archipelago."""
    suite: Optional[str] = None
    budget: Optional[int] = None
    deadline_s: Optional[float] = None
    priority: float = 1.0
    seed: int = 0
    n_islands: int = 2
    steps: int = 8
    backend: str = "service"
    topology: str = "ring"
    migration_interval: int = 4
    check_correctness: bool = True
    device: Optional[str] = None
    machine: Optional[str] = None

    def to_wire(self) -> dict:
        return asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "SearchJob":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class JobEvent:
    """One streamed lifecycle event.  ``kind`` is one of: accepted, started,
    commit, progress, done, cancelled, failed."""
    job: str
    kind: str
    t: float                       # seconds since job submission
    data: dict = field(default_factory=dict)

    def to_frame(self) -> dict:
        return {"type": protocol.JOB_EVENT, "job": self.job,
                "kind": self.kind, "t": self.t, "data": self.data}


def lineage_fingerprint(engine: IslandEvolution) -> list:
    """Bit-exact lineage identity of a whole archipelago: per island, every
    commit's genome key + score vector, in commit order.  Two engines agree
    on this iff they walked identical lineages — the frontier-vs-direct and
    worker-kill gates compare exactly this."""
    return [[(c.genome.key(), tuple(c.values)) for c in isl.lineage.commits]
            for isl in engine.islands]


class _JobState:
    """One submitted job's runtime record."""

    __slots__ = ("job", "job_id", "status", "cancel", "thread", "events",
                 "callback", "spent", "steps_done", "best_geomean",
                 "fingerprint", "error", "t0")

    def __init__(self, job: SearchJob, job_id: str,
                 callback: Optional[Callable[[JobEvent], None]]):
        self.job = job
        self.job_id = job_id
        self.status = "queued"     # queued -> running -> done|cancelled|failed
        self.cancel = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.events: list[JobEvent] = []
        self.callback = callback
        self.spent = 0
        self.steps_done = 0
        self.best_geomean = 0.0
        self.fingerprint: Optional[list] = None
        self.error = ""
        self.t0 = time.monotonic()


class SearchFrontier:
    """The long-lived evolution service: one shared worker fleet, many
    concurrent search jobs.

    Jobs arrive two ways — in-process (:meth:`submit`) or over the wire
    (:class:`~repro_torch.core.frontier_client.FrontierClient` speaks JOB /
    JOB_CANCEL frames to the coordinator's listener; the frontier installs
    itself as the coordinator's client-session handler).  Each job runs on
    its own thread as an archipelago whose evaluation backend shares the
    frontier's coordinator under the job's own scheduling tenant; between
    migration-interval chunks the job checks cancellation, deadline, and
    budget, re-weights its tenant to priority x remaining budget, and
    streams progress events.

    Pass ``coordinator=`` to embed the frontier on an existing fleet, or let
    it own one (``listen`` / ``workers`` as in :class:`ServiceBackend`;
    ``device`` is where its workers score, ``None``: the card, whose kernel
    is built and loaded here before the first spawn).
    ``close()`` cancels running jobs, waits for their threads, and tears
    down an owned coordinator only.
    """

    def __init__(self, coordinator: Optional[EvalCoordinator] = None, *,
                 listen: str = "127.0.0.1:0", workers: int = 0,
                 worker_slots: int = 1, worker_timeout_s: float = 60.0,
                 device: Optional[str] = None):
        self._own_coordinator = coordinator is None
        self.coordinator = coordinator if coordinator is not None else \
            EvalCoordinator(*protocol.parse_address(listen))
        self._procs: list = []
        if self._own_coordinator and workers > 0:
            try:
                prepare_parent((EvalSpec.resolve(None, device=device),))
            except Exception:
                self.coordinator.close()
                raise
            self._procs = self.coordinator.spawn_workers(
                workers, slots=worker_slots, timeout_s=worker_timeout_s,
                device=device)
        self._lock = threading.Lock()
        self._jobs: dict[str, _JobState] = {}
        self._next_job = itertools.count(1)
        self._closed = False
        # frontier job lifecycle counters, labelled by the fleet they ran on
        # (the coordinator's registry id); per-job gauges are created per
        # tenant as jobs progress (see _emit)
        reg, cid = obs.REGISTRY, self.coordinator.obs_id
        self._m_jobs = reg.counter("frontier_jobs_submitted", coord=cid)
        self._m_final = {
            "done": reg.counter("frontier_jobs_done", coord=cid),
            "cancelled": reg.counter("frontier_jobs_cancelled", coord=cid),
            "failed": reg.counter("frontier_jobs_failed", coord=cid),
        }
        # wire ingress: the coordinator routes client HELLOs + frames here
        self.coordinator.on_client_msg = self._on_client_msg
        self.coordinator.on_client_close = lambda session: None

    @property
    def address(self) -> tuple[str, int]:
        """Where clients (and workers) connect."""
        return self.coordinator.address

    # -- ingress -------------------------------------------------------------------
    def _on_client_msg(self, session: ClientSession, msg: dict) -> None:
        """Coordinator event-loop thread: must not block.  JOB spawns the job
        thread; JOB_CANCEL flips an event the job thread polls."""
        kind = msg.get("type")
        if kind == protocol.JOB:
            try:
                job = SearchJob.from_wire(msg.get("job") or {})
            except (TypeError, ValueError) as e:
                session.send({"type": protocol.JOB_EVENT, "job": "",
                              "kind": "failed", "t": 0.0,
                              "data": {"error": f"bad job: {e}",
                                       "ref": msg.get("ref")}})
                return
            self.submit(job, callback=lambda ev: session.send(ev.to_frame()),
                        _ref=msg.get("ref"))
        elif kind == protocol.JOB_CANCEL:
            self.cancel(str(msg.get("job", "")))

    # -- the job API ---------------------------------------------------------------
    def submit(self, job: SearchJob,
               callback: Optional[Callable[[JobEvent], None]] = None, *,
               _ref=None) -> str:
        """Accept one job; returns its id immediately.  ``callback`` receives
        every :class:`JobEvent` (on the job's thread) — the wire path passes
        the client session's thread-safe ``send``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("submit on closed SearchFrontier")
            job_id = f"job-{next(self._next_job):04d}"
            state = _JobState(job, job_id, callback)
            self._jobs[job_id] = state
            self._m_jobs.inc()
        self._emit(state, "accepted",
                   {"job": job.to_wire(), "ref": _ref,
                    "fleet_slots": self.coordinator.total_slots})
        state.thread = threading.Thread(target=self._run_job, args=(state,),
                                        name=job_id, daemon=True)
        state.thread.start()
        return job_id

    def cancel(self, job_id: str) -> bool:
        """Request cancellation; the job stops at its next chunk boundary."""
        with self._lock:
            state = self._jobs.get(job_id)
        if state is None:
            return False
        state.cancel.set()
        return True

    def wait(self, job_id: str, timeout: Optional[float] = None) -> str:
        """Block until the job's thread finishes; returns its final status."""
        with self._lock:
            state = self._jobs.get(job_id)
        if state is None:
            raise KeyError(job_id)
        if state.thread is not None:
            state.thread.join(timeout)
        return state.status

    def job_events(self, job_id: str) -> list[JobEvent]:
        with self._lock:
            state = self._jobs.get(job_id)
        if state is None:
            raise KeyError(job_id)
        return list(state.events)

    def stats(self) -> dict:
        """Frontier + fleet accounting: per-job status/spend/steps plus the
        coordinator's registry snapshot (which carries the per-tenant
        weighted-fair grant counters)."""
        with self._lock:
            jobs = {jid: {"status": s.status, "priority": s.job.priority,
                          "budget": s.job.budget, "spent": s.spent,
                          "steps_done": s.steps_done,
                          "best_geomean": s.best_geomean,
                          "events": len(s.events)}
                    for jid, s in self._jobs.items()}
        return {"jobs": jobs, "coordinator": self.coordinator.stats()}

    # -- the job runner ------------------------------------------------------------
    def _emit(self, state: _JobState, kind: str, data: dict) -> None:
        ev = JobEvent(state.job_id, kind, time.monotonic() - state.t0, data)
        with self._lock:
            state.events.append(ev)
        final = self._m_final.get(kind)
        if final is not None:
            final.inc()
        if kind == "progress":
            # per-tenant frontier gauges: spend + best, labelled like the
            # coordinator's grant counters so one registry read joins them
            labels = dict(coord=self.coordinator.obs_id, tenant=state.job_id)
            obs.REGISTRY.gauge("frontier_job_spent", **labels).set(state.spent)
            obs.REGISTRY.gauge("frontier_job_best",
                               **labels).set(state.best_geomean)
        if obs.enabled():
            # the job lifecycle, mirrored onto the run journal (tenant-tagged
            # so the report's per-tenant rollup sees it)
            obs.publish("job_event", tenant=state.job_id, kind=kind,
                        t_job=round(ev.t, 6))
        if state.callback is not None:
            try:
                state.callback(ev)
            except Exception:
                state.callback = None    # dead client: stop streaming

    def _job_config(self, state: _JobState) -> EngineConfig:
        job = state.job
        if not backend_info(job.backend).needs_coordinator:
            raise ValueError(
                f"job backend {job.backend!r} cannot score against the "
                "frontier's shared fleet (needs_coordinator=False)")
        return EngineConfig(
            n_islands=job.n_islands,
            suite=suite_by_name(job.suite) if job.suite else None,
            seed=job.seed,
            pipeline=False,
            evals=EvalConfig(backend=job.backend,
                             check_correctness=job.check_correctness,
                             coordinator=self.coordinator,
                             tenant=state.job_id, device=job.device,
                             machine=job.machine),
            migration=MigrationConfig(topology=job.topology,
                                      interval=job.migration_interval))

    def _reweight(self, state: _JobState) -> None:
        """priority x remaining budget: a draining job's claim on contended
        slots decays toward bare priority."""
        job = state.job
        remaining = max(1.0, job.budget - state.spent) \
            if job.budget is not None else 1.0
        self.coordinator.set_tenant_weight(
            state.job_id, max(job.priority, 1e-9) * remaining)

    def _run_job(self, state: _JobState) -> None:
        job = state.job
        engine = None
        try:
            engine = IslandEvolution(config=self._job_config(state),
                                     on_commit=lambda ev: self._emit(
                                         state, "commit", ev))
            state.status = "running"
            self._reweight(state)
            self._emit(state, "started", {"islands": len(engine.islands)})
            chunk = max(1, job.migration_interval)
            while state.steps_done < job.steps:
                if state.cancel.is_set():
                    state.status = "cancelled"
                    break
                if job.deadline_s is not None and \
                        time.monotonic() - state.t0 > job.deadline_s:
                    state.status = "cancelled"
                    self._emit(state, "progress",
                               {"deadline_exceeded": True})
                    break
                if job.budget is not None and state.spent >= job.budget:
                    break
                # one migration epoch per run() call: chunked stepping is
                # bit-identical to one long run (pipeline=False, and the
                # per-call bootstrap batch is a cache-warming no-op)
                engine.run(max_steps=min(chunk, job.steps - state.steps_done))
                state.steps_done += min(chunk, job.steps - state.steps_done)
                state.spent = sum(s.n_evaluations
                                  for s in engine.scorers.values())
                state.best_geomean = engine.best_geomean()
                self._reweight(state)
                self._emit(state, "progress",
                           {"steps_done": state.steps_done,
                            "spent": state.spent,
                            "budget": job.budget,
                            "best_geomean": state.best_geomean})
            state.fingerprint = lineage_fingerprint(engine)
            if state.status != "cancelled":
                state.status = "done"
            self._emit(state, state.status,
                       {"steps": state.steps_done, "spent": state.spent,
                        "best_geomean": state.best_geomean,
                        "fingerprint": state.fingerprint})
        except Exception as e:  # job isolation: one bad job never kills the service
            state.status = "failed"
            state.error = f"{type(e).__name__}: {e}"
            self._emit(state, "failed", {"error": state.error})
        finally:
            if engine is not None:
                engine.close()   # shared coordinator survives (not owned)

    # -- lifecycle -----------------------------------------------------------------
    def close(self) -> None:
        """Cancel every running job, join their threads, release the fleet
        (owned coordinator only).  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            states = list(self._jobs.values())
        for s in states:
            s.cancel.set()
        for s in states:
            if s.thread is not None:
                s.thread.join(timeout=30.0)
        self.coordinator.on_client_msg = None
        self.coordinator.on_client_close = None
        if self._own_coordinator:
            self.coordinator.close()
            stop_local_workers(self._procs)


def _frontier_factory(spec, cache=None, **kw) -> ServiceBackend:
    """The 'frontier' registry entry: scoring-wise it IS the service backend
    (the frontier's jobs score over the shared coordinator); registered
    separately so ``SearchJob.backend`` can name the frontier substrate
    through the registry like any other backend."""
    return ServiceBackend(spec=spec, cache=cache, **kw)


register_backend("frontier", _frontier_factory, needs_coordinator=True)
