"""Elastic worker-process pool: capacity follows queue depth.

``make_process_executor`` (backends.py) sizes its pool once, up front.  That
is the wrong shape for the pipelined island engine, whose evaluation demand
breathes: a proposal phase dumps a burst of speculative candidates on the
queue, the harvest drains them, the epoch barrier goes quiet, and the next
epoch bursts again.  :class:`ElasticProcessPool` keeps the executor surface
(``submit``/``shutdown``) but *grows* its worker count when the queue backs
up and *shrinks* it when the pool idles — with hysteresis in both directions
so a single burst or a single quiet beat never thrashes workers.

Structure: one central FIFO of pending tasks and N *slots*, each slot a
single-worker executor (by default a warm one-worker ``ProcessPoolExecutor``
built per slot, so growth never re-shapes an existing pool and each new
worker spawns independently).  An explicit ``fork`` start is re-checked per
slot: a slot added after the parent initialised CUDA is refused.  Tasks are dispatched to idle slots in submission order,
so results are deterministic functions of the task alone — elasticity changes
wall-clock and worker count, never values.

Everything is observable: ``stats()`` reports current/peak worker counts and
the resize-event log the benchmarks publish.
"""
from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
from typing import Callable, Optional, Sequence

from repro_torch.core import obs
from repro_torch.core.evals.scorer import batch_scoring_enabled
from repro_torch.core.evals.worker import (EvalSpec, _prestart_noop,
                                           intern_spec, prepare_parent,
                                           warm_worker)

__all__ = ["ElasticProcessPool"]


def _default_slot_factory(specs: Sequence[EvalSpec],
                          mp_context) -> Callable[[], concurrent.futures.Executor]:
    """One warm single-worker ProcessPoolExecutor per call.  The start method
    is resolved at *each* slot creation (growth can happen long after
    construction, when a fork would no longer be safe)."""
    from repro_torch.core.evals.backends import _resolve_mp_context
    # (interned id, spec) pairs: every slot's worker registers the ids, so
    # the pool as a whole honours the compact evaluate_frame wire format
    pairs = tuple((intern_spec(s), s) for s in specs)
    prepare_parent(specs)

    def factory() -> concurrent.futures.Executor:
        ctx = _resolve_mp_context(mp_context, specs)
        ex = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=ctx,
            initializer=warm_worker, initargs=(pairs, batch_scoring_enabled()))
        ex.submit(_prestart_noop)      # start the worker process immediately
        return ex

    return factory


class _Slot:
    __slots__ = ("executor", "busy", "idle_since")

    def __init__(self, executor: concurrent.futures.Executor):
        self.executor = executor
        self.busy = False
        self.idle_since = time.monotonic()


class ElasticProcessPool:
    """Executor-compatible pool that grows/shrinks worker slots from queue
    depth with hysteresis.

    Grow rule:   queue depth > ``grow_depth`` x workers on ``hysteresis``
                 consecutive submissions -> add one slot (up to
                 ``max_workers``).
    Shrink rule: queue empty and a slot continuously idle for
                 ``shrink_idle_s`` seconds -> retire it (down to
                 ``min_workers``), at most one per observation.  Shrink is
                 deliberately time-based and conservative: a worker slot
                 costs seconds to spin up (fork/spawn + warm initializer),
                 so reclaiming one must only happen when the idle period has
                 clearly out-lasted that cost — a beat of quiet (an epoch
                 barrier) must never thrash workers.

    Drop-in for a ``ProcessPoolExecutor`` wherever only ``submit`` and
    ``shutdown`` are used (e.g. ``ProcessBackend(executor=...)`` or the
    island engine's shared process pool); ``slot_factory`` swaps the worker
    implementation (tests inject single-thread slots to exercise elasticity
    without process spin-up cost).
    """

    def __init__(self, specs: Sequence[EvalSpec] = (), *,
                 min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 grow_depth: float = 2.0,
                 hysteresis: int = 2,
                 shrink_idle_s: float = 10.0,
                 mp_context=None,
                 slot_factory: Optional[Callable[[], concurrent.futures.Executor]] = None):
        from repro_torch.core.evals.backends import default_worker_count
        if min_workers < 1:
            raise ValueError(f"min_workers must be >= 1, got {min_workers}")
        self.min_workers = min_workers
        if max_workers is not None and max_workers < min_workers:
            # an explicit, contradictory cap is an error; only the *default*
            # cap below is silently lifted to the floor
            raise ValueError(f"max_workers {max_workers} < "
                             f"min_workers {min_workers}")
        # default cap clamped like make_process_executor — an unclamped
        # cpu_count() would let bursts start dozens of warm workers
        self.max_workers = max(min_workers, default_worker_count(
            max_workers, on_card=any(s.on_card for s in specs)))
        # which interned spec ids this pool's real worker slots understand
        # (injected slot factories run arbitrary executors -> none)
        self.warm_spec_ids = frozenset(
            intern_spec(s) for s in specs) if slot_factory is None \
            else frozenset()
        # reported as the pool width by backends that introspect executors
        self._max_workers = self.max_workers
        self.grow_depth = grow_depth
        self.hysteresis = max(1, hysteresis)
        self.shrink_idle_s = shrink_idle_s
        self._slot_factory = slot_factory if slot_factory is not None \
            else _default_slot_factory(tuple(specs), mp_context)
        self._lock = threading.Lock()
        self._quiet = threading.Condition(self._lock)   # notified per completion
        self._pending: collections.deque = collections.deque()
        self._slots: list[_Slot] = []
        self._closed = False
        self._grow_streak = 0
        self.tasks_submitted = 0
        self.tasks_completed = 0
        self.peak_workers = 0
        self.resize_events: list[dict] = []
        with self._lock:
            for _ in range(self.min_workers):
                self._add_slot_locked(reason="init")

    # -- introspection ------------------------------------------------------------
    @property
    def n_workers(self) -> int:
        with self._lock:
            return len(self._slots)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": len(self._slots),
                "peak_workers": self.peak_workers,
                "min_workers": self.min_workers,
                "max_workers": self.max_workers,
                "queue_depth": len(self._pending),
                "tasks_submitted": self.tasks_submitted,
                "tasks_completed": self.tasks_completed,
                "grown": sum(1 for e in self.resize_events
                             if e["event"] == "grow"),
                "shrunk": sum(1 for e in self.resize_events
                              if e["event"] == "shrink"),
                "resize_events": list(self.resize_events),
            }

    def prestart(self, n: Optional[int] = None, wait: bool = True) -> None:
        """Grow to ``n`` slots (default: the cap) immediately, optionally
        blocking until every worker is up and warm.  Benchmarks call this
        before their timed window so a race measures stepping strategy, not
        process spin-up — the shrink rule reclaims the idle slots afterwards
        as usual."""
        with self._lock:
            if self._closed:
                raise RuntimeError("prestart on closed ElasticProcessPool")
            target = min(n if n is not None else self.max_workers,
                         self.max_workers)
            while len(self._slots) < target:
                self._add_slot_locked(reason="prestart")
            slots = list(self._slots)
        if wait:
            for s in slots:
                # direct to the slot executor: queues behind (and therefore
                # completes after) the slot's warm initializer
                s.executor.submit(_prestart_noop).result()

    def call_each(self, fn, /, *args) -> list:
        """``fn(*args)`` once on every current slot's worker, beside the
        queue (for a worker's own record, such as ``worker.worker_stats``)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("call_each on closed ElasticProcessPool")
            slots = list(self._slots)
        return [s.executor.submit(fn, *args) for s in slots]

    # -- the executor surface ------------------------------------------------------
    def submit(self, fn, /, *args, **kwargs) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("submit on closed ElasticProcessPool")
            self.tasks_submitted += 1
            self._pending.append((fut, fn, args, kwargs))
            self._observe_pressure_locked()
        self._dispatch()
        return fut

    def shutdown(self, wait: bool = True, *, cancel_futures: bool = False) -> None:
        """Executor contract: with ``cancel_futures`` queued tasks are
        cancelled; without it (and ``wait=True``) the queue is drained before
        the worker slots go down.  ``wait=False`` without ``cancel_futures``
        cannot drain — still-queued tasks then fail with the slot executors'
        shutdown error when dispatched."""
        with self._lock:
            already = self._closed
            if not already and cancel_futures:
                while self._pending:
                    fut, *_ = self._pending.popleft()
                    fut.cancel()
            if not already and wait and not cancel_futures:
                # drain: submissions are rejected once _closed flips, so
                # pending+busy strictly decreases to zero
                self._closed = True
                while self._pending or any(s.busy for s in self._slots):
                    self._quiet.wait()
            self._closed = True
            executors = [s.executor for s in self._slots]
        for ex in executors:
            ex.shutdown(wait=wait, cancel_futures=cancel_futures)

    # -- internals (all *_locked run under self._lock) -----------------------------
    def _add_slot_locked(self, reason: str) -> None:
        self._slots.append(_Slot(self._slot_factory()))
        self.peak_workers = max(self.peak_workers, len(self._slots))
        if reason != "init":
            self.resize_events.append({
                "event": "grow", "workers": len(self._slots),
                "queue_depth": len(self._pending), "why": reason})
            if obs.enabled():
                # the pool's resize log, mirrored onto the process event bus
                # (journal + ring) with its structured reason
                obs.publish("pool_grow", workers=len(self._slots),
                            queue_depth=len(self._pending), why=reason)

    def _retire_slot_locked(self, slot: _Slot, reason: str) -> None:
        self._slots.remove(slot)
        self.resize_events.append({
            "event": "shrink", "workers": len(self._slots),
            "queue_depth": len(self._pending), "why": reason})
        if obs.enabled():
            obs.publish("pool_shrink", workers=len(self._slots),
                        queue_depth=len(self._pending), why=reason)
        # never block the caller on a worker teardown
        threading.Thread(target=slot.executor.shutdown,
                         kwargs=dict(wait=False), daemon=True).start()

    def _observe_pressure_locked(self) -> None:
        """Growth signal, observed at submission: queue backing up relative
        to current capacity."""
        if len(self._pending) > self.grow_depth * len(self._slots):
            self._grow_streak += 1
            if self._grow_streak >= self.hysteresis \
                    and len(self._slots) < self.max_workers:
                self._add_slot_locked(
                    reason=f"depth {len(self._pending)} > "
                           f"{self.grow_depth:g}x{len(self._slots)}")
                self._grow_streak = 0
        else:
            self._grow_streak = 0

    def _observe_idle_locked(self) -> None:
        """Shrink signal, observed at completion: nothing queued and a slot
        idle for longer than a worker costs to spin up."""
        if self._pending or len(self._slots) <= self.min_workers:
            return
        now = time.monotonic()
        stale = [s for s in self._slots
                 if not s.busy and now - s.idle_since >= self.shrink_idle_s]
        if stale:
            self._retire_slot_locked(stale[-1], reason="idle")

    def _dispatch(self) -> None:
        """Feed idle slots from the FIFO.  Callback registration happens
        OUTSIDE the lock: an inner future that completed instantly runs its
        callback synchronously, and that callback re-enters this code."""
        while True:
            failed: list[tuple[concurrent.futures.Future, Exception]] = []
            started: list[tuple[concurrent.futures.Future, _Slot,
                                concurrent.futures.Future]] = []
            with self._lock:
                while self._pending:
                    slot = next((s for s in self._slots if not s.busy), None)
                    if slot is None:
                        break
                    fut, fn, args, kwargs = self._pending.popleft()
                    if not fut.set_running_or_notify_cancel():
                        continue       # cancelled while queued
                    slot.busy = True
                    try:
                        inner = slot.executor.submit(fn, *args, **kwargs)
                    except Exception as e:     # slot broken mid-flight
                        slot.busy = False
                        self._retire_slot_locked(slot, reason=f"broken: {e}")
                        if not self._slots and not self._closed:
                            self._add_slot_locked(reason="replace-broken")
                        failed.append((fut, e))
                        continue
                    started.append((inner, slot, fut))
            for fut, e in failed:
                fut.set_exception(e)
            if failed:
                with self._lock:
                    self._quiet.notify_all()   # a draining shutdown may wait
            for inner, slot, fut in started:
                inner.add_done_callback(
                    lambda f, slot=slot, fut=fut: self._task_done(slot, fut, f))
            if not started and not failed:
                return

    def _task_done(self, slot: _Slot, fut: concurrent.futures.Future,
                   inner: concurrent.futures.Future) -> None:
        exc = inner.exception()
        with self._lock:
            self.tasks_completed += 1
            slot.busy = False
            slot.idle_since = time.monotonic()
            if isinstance(exc, concurrent.futures.BrokenExecutor) \
                    and slot in self._slots:
                self._retire_slot_locked(slot, reason="broken-executor")
                if not self._slots and not self._closed:
                    self._add_slot_locked(reason="replace-broken")
            if not self._closed:
                self._observe_idle_locked()
            self._quiet.notify_all()           # a draining shutdown may wait
        if exc is None:
            fut.set_result(inner.result())
        else:
            fut.set_exception(exc)
        self._dispatch()
