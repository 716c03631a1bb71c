"""Pluggable evaluation backends: inline, thread, process.

The AVO loop is bounded by how fast the scoring function ``f`` can be paid
(paper §3.1: every variation step executes correctness + profiling).  On
one card the timed part of an evaluation is serial (one timer per card), so
worker processes overlap its host side: starting up, proxy inputs, rung-0
profiles.  All three backends share one contract (:class:`EvalBackend`).
At rung 0 they are bit-identical: the Scorer is a deterministic function of
the genome, so backend choice changes wall-clock only, never search
behaviour.  At the measured rung a score is a timing, and backends agree
within its spread.

  inline   evaluate in the calling thread (the plain :class:`Scorer` path)
  thread   shared memo cache + in-flight dedup on a ThreadPoolExecutor —
           overlaps what little the GIL releases; cheap to share
  process  ProcessPoolExecutor with per-worker warm initializers, a
           parent-side shared :class:`ScoreCache`, and parent-side in-flight
           dedup (concurrent requests for one genome collapse onto one
           worker task)

Process-start strategy: pools spawn their workers.  CUDA does not survive
``fork``, and a parent with threads (a coordinator's event loop, another
pool's manager) can leave a forked child deadlocked on a lock it will never
see released.  An explicit ``mp_context="fork"`` is honoured only for CPU
specs from a parent that has not initialised CUDA.  Before the
first spawn for a card spec the parent builds and loads the kernel
(``worker.prepare_parent``), so the workers only load it.  On the card a pool
is 2 workers wide unless the caller says otherwise: each spawned worker
holds a CUDA context and the suite's full-shape inputs, and the card's lock
(``device.card_lock``) lets one of them time at a time, so more workers
overlap only host work.

Cache keys are the port's ``Scorer.score_key`` for the backend's spec
(fidelity, planning machine, device type), so an inline scorer and a pooled
backend that share a :class:`ScoreCache` never alias two devices or two
machines.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import multiprocessing
import os
import threading
import time
from dataclasses import dataclass
from typing import (Callable, Optional, Protocol, Sequence, Union,
                    runtime_checkable)

import torch

from repro_torch.core import obs
from repro_torch.core.evals.cache import PERFMODEL, ScoreCache
from repro_torch.core.evals.scorer import (InlineBackend, Scorer,
                                           batch_scoring_enabled,
                                           default_machine, rung_key)
from repro_torch.core.evals.vector import ScoreVector
from repro_torch.core.evals.worker import (EvalSpec, _prestart_noop,
                                           evaluate_frame, evaluate_frame_many,
                                           evaluate_genome, intern_spec,
                                           prepare_parent, warm_worker,
                                           worker_stats)
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.core.search_space import KernelGenome

# reusable, reentrant no-op context (nullcontext is both) for un-traced paths
_NULL_CTX = contextlib.nullcontext()


# -- the backend registry ------------------------------------------------------
#
# Mirrors perfmodel.register_suite: backends self-register a factory under a
# name instead of living as hardcoded branches in make_backend, so the
# service / cascade / frontier modules (and out-of-tree extensions) plug in
# without this module importing them.  The metadata fields are what the
# island engine's generic wiring reads: which shared resource a backend of
# this name wants injected (a process/thread executor, or the coordinator).

@dataclass(frozen=True)
class BackendInfo:
    """One registry entry: the factory plus the wiring metadata the island
    engine uses to hand shared resources to backends it builds per suite."""
    name: str
    factory: Callable[..., "EvalBackend"]
    executor: Optional[str] = None     # "thread" | "process": wants a pool
    needs_coordinator: bool = False    # wants the shared EvalCoordinator

_REGISTRY: dict[str, BackendInfo] = {}

# backends that register on first use, keyed by the module that registers
# them — make_backend imports lazily so the registry never forces the
# service stack (and its import cycle) on inline users
_LAZY_MODULES = {
    "service": "repro_torch.core.evals.service",
    "frontier": "repro_torch.core.frontier",
}


def register_backend(name: str,
                     factory: Optional[Callable[..., "EvalBackend"]] = None, *,
                     executor: Optional[str] = None,
                     needs_coordinator: bool = False,
                     overwrite: bool = False):
    """Register an evaluation-backend factory under ``name`` (usable directly
    or as a decorator, like :func:`perfmodel.register_suite`).

    The factory is called as ``factory(spec=EvalSpec, cache=ScoreCache|None,
    **kw)`` — :func:`make_backend` resolves suite/fidelity/cache once, every
    backend receives the same pre-resolved spec.  ``executor`` /
    ``needs_coordinator`` tell the island engine which shared resource to
    inject when it builds this backend per suite."""
    if not name or not name.replace("_", "").replace("-", "").isalnum():
        raise ValueError(f"invalid backend name {name!r}")

    def _register(fn):
        if name in _REGISTRY and not overwrite:
            raise ValueError(f"backend {name!r} already registered "
                             "(overwrite=True replaces)")
        _REGISTRY[name] = BackendInfo(name, fn, executor=executor,
                                      needs_coordinator=needs_coordinator)
        return fn

    return _register if factory is None else _register(factory)


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def registered_backends() -> tuple[str, ...]:
    """Currently-registered backend names, sorted (the lazily-registered
    service appears once its module has loaded)."""
    return tuple(sorted(_REGISTRY))


def backend_info(name: str) -> BackendInfo:
    """Resolve one registry entry, importing a known lazy provider module on
    first miss; unknown names raise the stable ``unknown eval backend``
    ValueError every caller (engine included) matches on."""
    info = _REGISTRY.get(name)
    if info is None and name in _LAZY_MODULES:
        importlib.import_module(_LAZY_MODULES[name])
        info = _REGISTRY.get(name)
    if info is None:
        known = tuple(sorted(set(_REGISTRY) | set(_LAZY_MODULES)))
        raise ValueError(f"unknown eval backend {name!r}; known: {known}")
    return info


# pool width on one card: each worker holds a CUDA context and the suite's
# full-shape inputs, and the card lock times one scoring at a time
CARD_WORKERS = 2


def default_worker_count(max_workers: Optional[int] = None,
                         clamp: int = 8, *, on_card: bool = False) -> int:
    """Worker-pool width when the caller does not choose one: the host's CPU
    count, clamped — never a hard-coded constant — or :data:`CARD_WORKERS`
    for a pool that scores on the card.  Shared by the thread and process
    backends so both size from the hardware."""
    if max_workers:
        return max_workers
    if on_card:
        return CARD_WORKERS
    return max(2, min(clamp, os.cpu_count() or 2))


@runtime_checkable
class EvalBackend(Protocol):
    """What every evaluation backend exposes.  ``__call__`` and ``map`` are
    the synchronous scoring surface; ``submit`` is the async surface the
    pipelined engine's proposal phase uses (returns a
    ``concurrent.futures.Future[ScoreVector]``; duplicate submissions for one
    genome share a single evaluation).  ``overlapping`` says whether ``submit``
    actually runs elsewhere (thread/process pools) or inline — speculation is
    pointless on a backend that evaluates in the calling thread.  The rest is
    accounting the engine reports."""

    suite: Sequence[BenchConfig]
    overlapping: bool

    def __call__(self, genome: KernelGenome) -> ScoreVector: ...
    def submit(self, genome: KernelGenome) -> concurrent.futures.Future: ...
    def map(self, genomes: Sequence[KernelGenome]) -> list: ...
    def prefetch(self, genomes: Sequence[KernelGenome]) -> None: ...
    def baselines(self) -> dict: ...
    def close(self) -> None: ...


class BatchScorer:
    """The ``thread`` backend: a thread-safe wrapper around a :class:`Scorer`
    with a shared memo cache and batched candidate evaluation on a
    ``concurrent.futures`` executor.

    Several islands share one BatchScorer per benchmark suite, so an edit one
    island has already paid to evaluate (or falsify) is a cache hit everywhere
    else.  Results are bit-identical to the wrapped Scorer — the Scorer is a
    deterministic function of the genome — so sharing only changes wall-clock
    and evaluation counts, never search behaviour.

    Concurrency contract: concurrent calls for the *same* genome collapse into
    one evaluation (in-flight keys carry an event other callers wait on);
    concurrent calls for different genomes run in parallel.  If the owner's
    evaluation raises, the exception propagates to the owner's caller, waiters
    wake, and one of them becomes the new owner and retries.
    """

    overlapping = True

    def __init__(self, base: Optional[Scorer] = None, *,
                 suite: Optional[Sequence[BenchConfig]] = None,
                 max_workers: Optional[int] = None,
                 executor: Optional[concurrent.futures.Executor] = None):
        self.base = base if base is not None else Scorer(suite=suite)
        self._lock = threading.Lock()
        self._inflight: dict[str, threading.Event] = {}
        self._futures: dict[str, concurrent.futures.Future] = {}
        self._closed = False
        self._own_executor = executor is None
        # CPU-count-derived default width, like make_process_executor — the
        # chosen width is exposed as .max_workers for reports/JSON
        on_card = self.base.device.type == "cuda"
        if executor is not None:
            self.max_workers = getattr(executor, "_max_workers", None) \
                or default_worker_count(max_workers, on_card=on_card)
        else:
            self.max_workers = default_worker_count(max_workers,
                                                    on_card=on_card)
        self._executor = executor or concurrent.futures.ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="batch-scorer")
        # the lazy proxy build must not race across threads
        self.base.warm()

    # -- delegation --------------------------------------------------------------
    @property
    def suite(self):
        return self.base.suite

    @property
    def cache(self) -> ScoreCache:
        return self.base.cache

    @property
    def fidelity(self) -> str:
        return self.base.fidelity

    @property
    def plan_machine(self) -> str:
        return self.base.plan_machine

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def cache_hits(self) -> int:
        return self.base.cache.hits

    def score_key(self, genome: KernelGenome) -> str:
        """The wrapped scorer's fidelity-aware cache/dedup key."""
        return self.base.score_key(genome)

    @property
    def n_evaluations(self) -> int:
        return self.base.n_evaluations

    @property
    def in_flight(self) -> tuple:
        """Snapshot of genome keys currently being evaluated."""
        with self._lock:
            return tuple(self._inflight)

    def baselines(self) -> dict:
        return self.base.baselines()

    # -- thread-safe scoring -----------------------------------------------------
    def submit(self, genome: KernelGenome) -> concurrent.futures.Future:
        """Async scoring surface: cache hit -> completed future; already
        submitted -> the shared future; otherwise dispatch onto the executor.
        A failed evaluation is dropped from the submit table (never cached),
        so a later submit retries — mirroring the ``__call__`` contract."""
        key = self.base.score_key(genome)
        with self._lock:
            if self._closed:
                raise RuntimeError("submit on closed BatchScorer")
            # counted lookup: one cache hit per served request, the same
            # contract as __call__ and ParentCacheBackend.submit — so
            # cache_hits in reports is comparable across backends
            sv = self.base.cache.get(key)
            if sv is not None:
                done: concurrent.futures.Future = concurrent.futures.Future()
                done.set_result(sv)
                return done
            fut = self._futures.get(key)
            if fut is not None:
                return fut
            fut = self._submit_call(genome)
            self._futures[key] = fut
        fut.add_done_callback(lambda f, key=key: self._drop_submitted(key))
        if obs.enabled():
            obs.span("submit", obs.current_trace(), backend="thread", n=1)
        return fut

    def _submit_call(self, genome) -> concurrent.futures.Future:
        """Dispatch one synchronous ``self(genome)`` onto the executor,
        re-binding the submitter's trace in the scoring thread (trace ids are
        thread-local, and executor threads are not the submitting thread)."""
        if obs.enabled():
            tr = obs.current_trace()

            def call_traced(g=genome, tr=tr):
                with obs.use_trace(tr):
                    return self(g)
            return self._executor.submit(call_traced)
        return self._executor.submit(self, genome)

    def _drop_submitted(self, key: str) -> None:
        with self._lock:
            self._futures.pop(key, None)

    def submit_many(self, genomes: Sequence[KernelGenome]) -> list:
        """Batch form of :meth:`submit`: one future per request (duplicates
        and in-flight keys share), with everything actually uncached scored
        in up to ``max_workers`` chunked :meth:`Scorer.score_batch` tasks —
        one vectorized rung-0 call per chunk — instead of one executor task
        per genome.  Cache lookups stay counted per request, so hit/miss
        accounting matches the per-genome path exactly.  With the batch path
        disabled this degrades to a :meth:`submit` loop."""
        genomes = list(genomes)
        if not batch_scoring_enabled():
            return [self.submit(g) for g in genomes]
        results: list[concurrent.futures.Future] = []
        waiters: list[tuple[str, concurrent.futures.Future]] = []
        todo_g: list[KernelGenome] = []
        todo_k: list[str] = []
        todo_f: list[concurrent.futures.Future] = []
        todo_e: list[threading.Event] = []
        with self._lock:
            if self._closed:
                raise RuntimeError("submit on closed BatchScorer")
            for g in genomes:
                key = self.base.score_key(g)
                sv = self.base.cache.get(key)     # counted, like submit
                if sv is not None:
                    done: concurrent.futures.Future = \
                        concurrent.futures.Future()
                    done.set_result(sv)
                    results.append(done)
                    continue
                fut = self._futures.get(key)
                if fut is not None:
                    results.append(fut)           # collapse onto in-flight
                    continue
                if key in self._inflight:
                    # a synchronous __call__ owns it: wait it out on the
                    # executor, exactly like submit() would
                    fut = self._submit_call(g)
                    self._futures[key] = fut
                    waiters.append((key, fut))
                    results.append(fut)
                    continue
                ev = threading.Event()            # claim batch ownership
                self._inflight[key] = ev
                fut = concurrent.futures.Future()
                self._futures[key] = fut
                todo_g.append(g)
                todo_k.append(key)
                todo_f.append(fut)
                todo_e.append(ev)
                results.append(fut)
        for key, fut in waiters:
            fut.add_done_callback(lambda f, key=key: self._drop_submitted(key))
        n = len(todo_g)
        if n:
            tr = obs.current_trace() if obs.enabled() else None
            n_chunks = min(n, self.max_workers)
            for c in range(n_chunks):
                lo, hi = c * n // n_chunks, (c + 1) * n // n_chunks
                if lo == hi:
                    continue
                task = self._executor.submit(
                    self._run_batch_chunk, todo_g[lo:hi], todo_k[lo:hi],
                    todo_f[lo:hi], todo_e[lo:hi], tr)
                task.add_done_callback(
                    lambda t, k=todo_k[lo:hi], f=todo_f[lo:hi],
                    e=todo_e[lo:hi]: self._on_chunk_task_done(k, f, e, t))
            if obs.enabled():
                obs.span("submit", tr, backend="thread", n=n)
        return results

    def _run_batch_chunk(self, genomes, keys, futs, events, tr=None) -> None:
        """One executor task scoring a whole chunk via ``score_batch``:
        cache the results, release the in-flight events (waiters re-read the
        cache), resolve the per-key futures.  On failure nothing is cached
        and the keys are evicted so later submits retry — the same contract
        as the per-genome path.  ``tr`` re-binds the submitter's trace in
        this executor thread so the chunk's score span stitches."""
        try:
            with obs.use_trace(tr) if tr is not None else _NULL_CTX:
                svs = self.base.score_batch(genomes)
        except Exception as e:
            with self._lock:
                for k in keys:
                    self._inflight.pop(k, None)
                    self._futures.pop(k, None)
            for ev in events:
                ev.set()                 # waiters retry and become owners
            for f in futs:
                f.set_exception(e)
            return
        for k, sv in zip(keys, svs):
            self.base.cache.put(k, sv)
        with self._lock:
            for k in keys:
                self._inflight.pop(k, None)
                self._futures.pop(k, None)
        for ev in events:
            ev.set()
        for f, sv in zip(futs, svs):
            f.set_result(sv)

    def _on_chunk_task_done(self, keys, futs, events, task) -> None:
        """Only meaningful when ``close(cancel_futures=True)`` cancels a
        queued chunk: release its claims and cancel its futures so nothing
        waits forever on work that will never run."""
        if not task.cancelled():
            return                       # _run_batch_chunk resolved everything
        with self._lock:
            for k in keys:
                self._inflight.pop(k, None)
                self._futures.pop(k, None)
        for ev in events:
            ev.set()
        for f in futs:
            f.cancel()

    def __call__(self, genome: KernelGenome) -> ScoreVector:
        key = self.base.score_key(genome)
        cache = self.base.cache
        while True:
            with self._lock:
                sv = cache.get(key)
                if sv is not None:
                    return sv
                event = self._inflight.get(key)
                if event is None:
                    self._inflight[key] = event = threading.Event()
                    owner = True
                else:
                    owner = False
            if not owner:
                event.wait()
                continue               # re-read the cache (or retry on error)
            try:
                sv = self.base.score_uncached(genome)
                cache.put(key, sv)
                return sv
            finally:
                with self._lock:
                    del self._inflight[key]
                event.set()

    def map(self, genomes: Sequence[KernelGenome]) -> list[ScoreVector]:
        """Evaluate a batch concurrently; order-preserving, duplicates collapse
        onto one evaluation (one counted lookup per unique genome, as the
        per-genome path did).  Routed through :meth:`submit_many` so the whole
        uncached slate runs as chunked ``score_batch`` tasks sharing the same
        in-flight table as concurrent submitters."""
        unique: dict[str, KernelGenome] = {}
        for g in genomes:
            unique.setdefault(self.base.score_key(g), g)
        futs = dict(zip(unique, self.submit_many(list(unique.values()))))
        return [futs[self.base.score_key(g)].result() for g in genomes]

    def prefetch(self, genomes: Sequence[KernelGenome]) -> None:
        """Fire-and-forget cache warming for speculative candidates.  Peeks
        first (speculative work must not inflate the hit count), skips genomes
        already in flight either way (``_futures`` from submits, ``_inflight``
        from synchronous callers), and routes the rest through
        :meth:`submit_many` so later submitters share the prefetch's futures
        and the speculative slate rides the batch path."""
        todo: list[KernelGenome] = []
        for g in genomes:
            key = self.base.score_key(g)
            with self._lock:
                if self.base.cache.peek(key) is not None \
                        or key in self._inflight or key in self._futures:
                    continue
            todo.append(g)
        if todo:
            self.submit_many(todo)

    def close(self) -> None:
        """Idempotent: later calls are no-ops; ``submit`` after close raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._own_executor:
            self._executor.shutdown(wait=True, cancel_futures=True)


# the thread backend's canonical name; BatchScorer predates the backend layer
ThreadBackend = BatchScorer


def _resolve_mp_context(mp_context, specs: Sequence[EvalSpec] = ()):
    """The start method of a pool serving ``specs``: ``spawn`` unless the
    caller asks otherwise.  An explicit ``fork`` is refused when a spec
    scores on the card or the parent has initialised CUDA (CUDA does not
    survive ``fork``)."""
    if mp_context is None:
        return multiprocessing.get_context("spawn")
    ctx = multiprocessing.get_context(mp_context) \
        if isinstance(mp_context, str) else mp_context
    if ctx.get_start_method() == "fork" and (
            torch.cuda.is_initialized() or any(s.on_card for s in specs)):
        raise ValueError("CUDA does not survive fork: a pool that scores on "
                         "the card, or whose parent has initialised CUDA, "
                         "spawns its workers")
    return ctx


def make_process_executor(specs: Sequence[EvalSpec],
                          max_workers: Optional[int] = None,
                          mp_context=None) -> concurrent.futures.Executor:
    """A ProcessPoolExecutor whose workers are warm for every given spec.

    Workers are prestarted immediately: eager start overlaps worker warmup
    (a spawn, a CUDA context, the suite's inputs) with whatever the parent
    does next.
    """
    ctx = _resolve_mp_context(mp_context, specs)
    # clamped through default_worker_count: an unclamped cpu_count() here
    # would start dozens of warm workers on a big host
    workers = default_worker_count(max_workers,
                                   on_card=any(s.on_card for s in specs))
    prepare_parent(specs)
    # workers get (interned id, spec) pairs so the compact evaluate_frame
    # path can address specs by id; warm_spec_ids advertises which ids this
    # pool understands (ProcessBackend gates its dispatch encoding on it)
    pairs = tuple((intern_spec(s), s) for s in specs)
    executor = concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=ctx,
        initializer=warm_worker, initargs=(pairs, batch_scoring_enabled()))
    executor.warm_spec_ids = frozenset(sid for sid, _ in pairs)
    for _ in range(workers):
        executor.submit(_prestart_noop)
    return executor


class ParentCacheBackend:
    """The shared parent-side contract for backends whose evaluations run
    somewhere else (worker processes, remote hosts): the parent keeps the
    shared :class:`ScoreCache` and the in-flight future table, concurrent
    requests for one genome collapse onto a single dispatch, a failed
    evaluation is evicted from the in-flight table (never cached) so
    callers can retry, and ``close`` is idempotent.  Subclasses say where an
    evaluation actually goes (:meth:`_dispatch_eval`) and what ``close``
    tears down (:meth:`_close_resources`) — the caching/dedup semantics must
    never diverge between them.

    The scorer behind :meth:`baselines` is built on first use, from the
    spec's device, machine and fidelity: at the measured rung it times
    cuDNN and flash on the card under the card's lock, and a parent that
    never asks for baselines opens no CUDA context for them."""

    overlapping = True
    obs_name = "remote"     # span label; subclasses name their wire

    def __init__(self, spec: EvalSpec, cache: Optional[ScoreCache] = None):
        self.spec = spec
        self.cache = cache if cache is not None else ScoreCache()
        self._lock = threading.Lock()
        self._futures: dict[str, concurrent.futures.Future] = {}
        self._paid = 0
        self._closed = False
        self._baseline_scorer: Optional[Scorer] = None

    # -- what a subclass provides ---------------------------------------------------
    def _dispatch_eval(self, genome: KernelGenome) -> concurrent.futures.Future:
        raise NotImplementedError

    def score_key(self, genome: KernelGenome) -> str:
        """Cache/dedup key: exactly ``Scorer.score_key`` of a scorer built
        from this backend's spec (fidelity, planning machine, device type),
        so backends of one suite at different rungs, machines or devices
        share one cache without ever aliasing."""
        return rung_key(genome, self.spec.fidelity, self.plan_machine,
                        self.device.type)

    def _dispatch_eval_many(self, genomes: Sequence[KernelGenome]) -> list:
        """Dispatch a batch the parent has already deduped.  Default: one
        dispatch per genome; backends with a batched wire (the service
        coordinator's ``tasks`` frames) override to ship the whole batch in
        one frame.  Called under the backend lock."""
        return [self._dispatch_eval(g) for g in genomes]

    def _close_resources(self) -> None:
        raise NotImplementedError

    # -- accounting ---------------------------------------------------------------
    @property
    def suite(self):
        return list(self.spec.suite)

    @property
    def fidelity(self) -> str:
        return self.spec.fidelity

    @property
    def plan_machine(self) -> str:
        """The machine whose model gives the profiles the agent plans from."""
        return self.spec.machine or default_machine(self.spec.fidelity)

    @property
    def device(self) -> torch.device:
        """Where the workers score (``None`` in the spec: the card)."""
        return torch.device(self.spec.device or "cuda")

    @property
    def n_evaluations(self) -> int:
        """Evaluations dispatched to workers (the paid count)."""
        with self._lock:
            return self._paid

    @property
    def cache_hits(self) -> int:
        return self.cache.hits

    @property
    def in_flight(self) -> tuple:
        with self._lock:
            return tuple(self._futures)

    def baselines(self) -> dict:
        with self._lock:
            if self._baseline_scorer is None:
                self._baseline_scorer = Scorer(
                    suite=list(self.spec.suite), check_correctness=False,
                    fidelity=self.spec.fidelity, device=self.spec.device,
                    machine=self.spec.machine)
            scorer = self._baseline_scorer
        return scorer.baselines()

    # -- scoring ------------------------------------------------------------------
    def submit(self, genome: KernelGenome) -> concurrent.futures.Future:
        """Cache hit -> completed future; in flight -> the shared future;
        otherwise dispatch to a worker."""
        key = self.score_key(genome)
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    f"submit on closed {type(self).__name__}")
            sv = self.cache.get(key)
            if sv is not None:
                done: concurrent.futures.Future = concurrent.futures.Future()
                done.set_result(sv)
                return done
            fut = self._futures.get(key)
            if fut is not None:
                return fut
            fut = self._dispatch_eval(genome)
            self._paid += 1
            self._futures[key] = fut
        # outside the lock: an already-completed future runs the callback
        # synchronously right here, and _on_done takes the lock itself
        fut.add_done_callback(lambda f, key=key: self._on_done(key, f))
        if obs.enabled():
            obs.span("submit", obs.current_trace(), backend=self.obs_name,
                     n=1, rung=self.spec.fidelity)
        return fut

    def _on_done(self, key: str, fut: concurrent.futures.Future) -> None:
        with self._lock:
            self._futures.pop(key, None)
            if not fut.cancelled() and fut.exception() is None:
                self.cache.put(key, fut.result())

    def submit_many(self, genomes: Sequence[KernelGenome]) -> list:
        """Batch form of :meth:`submit`: one future per request (duplicates
        share), with every genome that actually needs evaluation handed to the
        subclass as ONE batch (:meth:`_dispatch_eval_many`) under a single
        lock pass — the wire-level win for the service backend, where the
        batch travels in one frame instead of len(batch) round trips."""
        new_keys: list[str] = []
        new_seen: set[str] = set()
        new_genomes: list[KernelGenome] = []
        futs: dict[str, concurrent.futures.Future] = {}
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    f"submit on closed {type(self).__name__}")
            for g in genomes:
                key = self.score_key(g)
                if key in futs or key in new_seen:
                    continue                      # within-batch duplicate
                sv = self.cache.get(key)
                if sv is not None:
                    done: concurrent.futures.Future = \
                        concurrent.futures.Future()
                    done.set_result(sv)
                    futs[key] = done
                    continue
                fut = self._futures.get(key)
                if fut is not None:
                    futs[key] = fut               # collapse onto in-flight
                    continue
                new_keys.append(key)
                new_seen.add(key)
                new_genomes.append(g)
            dispatched = self._dispatch_eval_many(new_genomes) \
                if new_genomes else []
            for key, fut in zip(new_keys, dispatched):
                self._paid += 1
                self._futures[key] = fut
                futs[key] = fut
        # outside the lock: a completed future runs its callback synchronously
        for key, fut in zip(new_keys, dispatched):
            fut.add_done_callback(lambda f, key=key: self._on_done(key, f))
        if new_keys and obs.enabled():
            obs.span("submit", obs.current_trace(), backend=self.obs_name,
                     n=len(new_keys), rung=self.spec.fidelity)
        return [futs[self.score_key(g)] for g in genomes]

    def __call__(self, genome: KernelGenome) -> ScoreVector:
        return self.submit(genome).result()

    def map(self, genomes: Sequence[KernelGenome]) -> list[ScoreVector]:
        """Order-preserving batch evaluation; duplicates share one task and
        the whole batch ships in one dispatch (:meth:`submit_many`)."""
        futures = self.submit_many(genomes)
        return [f.result() for f in futures]

    def prefetch(self, genomes: Sequence[KernelGenome]) -> None:
        """Speculative batch warming: peek (hit count untouched — these are
        guesses, not served requests), then batch-submit whatever is neither
        cached nor in flight."""
        todo: list[KernelGenome] = []
        seen: set[str] = set()
        with self._lock:
            for g in genomes:
                key = self.score_key(g)
                if key in seen or self.cache.peek(key) is not None \
                        or key in self._futures:
                    continue
                seen.add(key)
                todo.append(g)
        if todo:
            self.submit_many(todo)

    def close(self) -> None:
        """Idempotent: later calls are no-ops; ``submit`` after close raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._close_resources()


class ProcessBackend(ParentCacheBackend):
    """The ``process`` backend: evaluations in warm worker processes, which
    on the card overlap the host side of an evaluation while the card's lock
    times one at a time.

    Workers are pure (see ``worker.py``) and rebuild proxy inputs
    deterministically from the spec, so results are bit-identical to the
    inline path; the parent-side cache/dedup contract is
    :class:`ParentCacheBackend`'s.
    """

    def __init__(self, suite: Union[str, Sequence[BenchConfig], None] = None, *,
                 spec: Optional[EvalSpec] = None,
                 check_correctness: bool = True, rng_seed: int = 0,
                 device: Optional[str] = None, machine: Optional[str] = None,
                 max_workers: Optional[int] = None, mp_context=None,
                 cache: Optional[ScoreCache] = None,
                 executor: Optional[concurrent.futures.Executor] = None):
        super().__init__(spec if spec is not None else EvalSpec.resolve(
            suite, check_correctness, rng_seed, device=device,
            machine=machine), cache)
        self._own_executor = executor is None
        self._executor = executor or make_process_executor(
            (self.spec,), max_workers=max_workers, mp_context=mp_context)
        self.max_workers = getattr(self._executor, "_max_workers", None) \
            or default_worker_count(max_workers, on_card=self.spec.on_card)
        # compact dispatch needs workers that know this spec's interned id —
        # true for make_process_executor/ElasticProcessPool pools, unknowable
        # for arbitrary injected executors (tests inject thread pools), which
        # keep the full-payload path
        self._spec_id = intern_spec(self.spec)
        self._compact_wire = self._spec_id in getattr(
            self._executor, "warm_spec_ids", ())

    obs_name = "process"

    def _dispatch_eval(self, genome: KernelGenome) -> concurrent.futures.Future:
        if self._compact_wire:
            # seed-only frame: tens of bytes on the queue vs ~560 for the
            # full (genome, spec) pickle — the cold-batch wire win
            fut = self._executor.submit(
                evaluate_frame, genome.to_edits(), self._spec_id)
        else:
            fut = self._executor.submit(evaluate_genome, genome, self.spec)
        if obs.enabled():
            # parent-side dispatch span: duration covers queue + worker
            # scoring (the pool's wire does not ship worker timings back)
            self._obs_dispatch_span(fut, obs.current_trace(), 1)
        return fut

    def _obs_dispatch_span(self, fut, tr, n) -> None:
        t0 = time.perf_counter()
        fut.add_done_callback(lambda f: obs.span(
            "dispatch", tr, backend="process", n=n,
            dur_s=time.perf_counter() - t0, rung=self.spec.fidelity))

    def _dispatch_eval_many(self, genomes: Sequence[KernelGenome]) -> list:
        """Columnar dispatch: the deduped batch ships as up to
        ``max_workers`` :func:`evaluate_frame_many` tasks (balanced
        contiguous chunks — multi-core parallelism is preserved, each chunk
        is one vectorized ``score_batch`` in its worker) instead of one task
        per genome.  Per-genome futures are fanned out from each chunk task.
        Requires the compact wire (workers that know the interned spec id);
        otherwise, or with the batch path disabled, singleton dispatch."""
        if len(genomes) <= 1 or not self._compact_wire \
                or not batch_scoring_enabled():
            return [self._dispatch_eval(g) for g in genomes]
        entries = [(g.to_edits(), self._spec_id) for g in genomes]
        futs = [concurrent.futures.Future() for _ in genomes]
        n, n_chunks = len(entries), min(len(entries), self.max_workers)
        traced = obs.enabled()
        for c in range(n_chunks):
            lo, hi = c * n // n_chunks, (c + 1) * n // n_chunks
            if lo == hi:
                continue
            task = self._executor.submit(evaluate_frame_many, entries[lo:hi])
            if traced:
                self._obs_dispatch_span(task, obs.current_trace(), hi - lo)
            task.add_done_callback(
                lambda t, chunk=futs[lo:hi]: _fan_out_chunk(t, chunk))
        return futs

    def worker_stats(self, timeout: float = 120.0) -> dict:
        """``{pid: worker.worker_stats()}`` of every worker of the pool.  An
        elastic pool takes one call per slot; a fixed pool one call per
        worker, each holding its worker a while so that the calls spread
        over the pool (held longer, and asked again, until every worker
        has answered)."""
        call_each = getattr(self._executor, "call_each", None)
        if call_each is not None:
            return {st["pid"]: st for st in (
                f.result(timeout) for f in call_each(worker_stats))}
        out: dict = {}
        hold = 0.5
        while len(out) < self.max_workers and hold <= 4.0:
            futs = [self._executor.submit(worker_stats, hold)
                    for _ in range(self.max_workers)]
            for f in futs:
                st = f.result(timeout)
                out[st["pid"]] = st
            hold *= 2
        return out

    def _close_resources(self) -> None:
        if self._own_executor:
            self._executor.shutdown(wait=True, cancel_futures=True)


def _fan_out_chunk(task: concurrent.futures.Future, futs: list) -> None:
    """Resolve a chunk's per-genome futures from its batch task: results in
    order, a batch-level failure/cancellation propagated to every member (the
    parent evicts them from the in-flight table, so callers retry)."""
    if task.cancelled():
        for f in futs:
            f.cancel()
        return
    err = task.exception()
    if err is not None:
        for f in futs:
            f.set_exception(err)
        return
    for f, sv in zip(futs, task.result()):
        f.set_result(sv)


def make_backend(name: str,
                 suite: Union[str, Sequence[BenchConfig], EvalSpec,
                              None] = None,
                 **kw) -> "EvalBackend":
    """Build an evaluation backend by name — the single dispatch point over
    the registry (see :func:`register_backend` / :func:`registered_backends`;
    'inline' | 'thread' | 'process' ship from this module, 'service'
    self-registers on first use).

    ``suite`` is a registered suite name, an explicit BenchConfig sequence,
    a pre-resolved :class:`EvalSpec`, or None (MHA default); ``fidelity``
    selects the evaluation rung ('perfmodel' | 'measured', overriding a
    pre-resolved spec's rung), ``device`` and ``machine`` where workers score
    and rung 0's model (the spec's own when one is given), and ``cache``
    injects a shared
    :class:`ScoreCache` — sibling backends of one suite at different rungs
    share a cache safely because keys carry the fidelity.  Remaining keywords
    go to the backend factory (e.g. ``executor=`` to share a pool,
    ``max_workers=``, or — for 'service' — ``coordinator=`` / ``workers=`` to
    share or spawn a worker fleet).
    """
    fid = kw.pop("fidelity", None)
    cache = kw.pop("cache", None)
    spec = EvalSpec.resolve(suite,
                            kw.pop("check_correctness", True),
                            kw.pop("rng_seed", 0),
                            kw.pop("service_latency_s", 0.0),
                            fid if fid is not None else PERFMODEL,
                            kw.pop("device", None),
                            kw.pop("machine", None))
    if fid is not None and spec.fidelity != fid:
        spec = spec.with_fidelity(fid)      # suite arrived as an EvalSpec
    return backend_info(name).factory(spec=spec, cache=cache, **kw)


def _inline_factory(spec: EvalSpec, cache: Optional[ScoreCache] = None,
                    **kw) -> InlineBackend:
    return InlineBackend(suite=list(spec.suite),
                         check_correctness=spec.check_correctness,
                         rng_seed=spec.rng_seed, cache=cache,
                         service_latency_s=spec.service_latency_s,
                         fidelity=spec.fidelity, device=spec.device,
                         machine=spec.machine, **kw)


def _thread_factory(spec: EvalSpec, cache: Optional[ScoreCache] = None,
                    **kw) -> ThreadBackend:
    return ThreadBackend(Scorer(suite=list(spec.suite),
                                check_correctness=spec.check_correctness,
                                rng_seed=spec.rng_seed, cache=cache,
                                service_latency_s=spec.service_latency_s,
                                fidelity=spec.fidelity, device=spec.device,
                                machine=spec.machine),
                         **kw)


def _process_factory(spec: EvalSpec, cache: Optional[ScoreCache] = None,
                     **kw) -> ProcessBackend:
    return ProcessBackend(spec=spec, cache=cache, **kw)


register_backend("inline", _inline_factory)
register_backend("thread", _thread_factory, executor="thread")
register_backend("process", _process_factory, executor="process")
