"""The cross-host evaluation service: coordinator, host registry, and the
``service`` :class:`EvalBackend`.

The ``process`` backend (backends.py) scales scoring to the cores of ONE
host.  This module is the RPC shim on top of the same pure-worker contract:
a :class:`EvalCoordinator` listens on a TCP socket, remote workers
(``python -m repro_torch.core.evals.service_worker --connect HOST:PORT
[--device DEVICE]``) register and heartbeat, and :class:`ServiceBackend` fans
genome batches out over the live worker set.  At rung 0 results are
bit-identical to the inline path for exactly the reason process results
are: a worker rebuilds its :class:`~repro_torch.core.evals.worker.EvalSpec`
scorer deterministically, so WHERE an evaluation runs can never change its
value.  At the measured rung a score is a timing; workers that share a card
time one at a time under the card's lock (``device.card_lock``).

A worker's HELLO names its package (``protocol.PACKAGE``); the coordinator
refuses a worker of another package (a ``repro`` worker cannot unpickle
this package's specs) with a REFUSED frame that says so, and a ``refused``
event.  :meth:`EvalCoordinator.worker_stats` asks every live worker for its
own record (``worker.worker_stats``: card-lock spans, kernel launches, peak
device memory).

Concurrency model: ONE asyncio event loop on a background thread owns every
connection.  Each peer gets a reader coroutine and a sender coroutine fed by
a per-connection FIFO queue of pre-encoded frames; the sender ``await``\\ s
``writer.drain()`` after every frame, so a slow peer stalls only its own
sender — explicit per-connection backpressure instead of one blocked thread
per socket.  Frame ordering guarantees (WELCOME before any TASK/WARM, WARM
before a tasks frame that addresses the spec by id) fall out of queue FIFO
order.  Registry state is guarded by a plain ``threading.Lock`` held only
for short critical sections and never across an ``await``, so the public
surface (``submit_many``, ``stats``, ``wait_for_workers``, ``close``) stays
callable from any thread; submissions hop onto the loop with
``call_soon_threadsafe``.

Multi-tenant scheduling: every task belongs to a *tenant* (the default ""
tenant preserves the historical single-queue FIFO bit for bit).  Pending
tasks queue per tenant, and each free slot is granted to the pending tenant
minimizing ``granted / weight`` (tenant id breaks ties) — weighted fair
sharing, with weights set by the search frontier to priority x remaining
budget.  ``granted_contended`` counts grants made while >= 2 tenants were
queued: the fairness benchmark gates on each tenant's share of exactly
those grants, the only ones where the scheduler had a real choice.

Fault model (the paper's 7-day-run regime: workers come and go, the search
must not notice):

  * a worker's death is detected two ways — synchronously, when its socket
    drops (kill/crash/network reset) or its sender fails, and
    asynchronously, when it misses heartbeats for ``dead_after_s``
    (hang/partition);
  * every task in flight on a dead worker is requeued at the FRONT of its
    tenant's pending queue (original submission order) and re-dispatched to
    the surviving workers — the waiting future never notices, and
    determinism makes the retried result identical to the one the dead
    worker owed;
  * a task that *fails* (the evaluation itself raised) is NOT requeued: the
    scorer is deterministic, so retrying a poisoned genome elsewhere would
    loop forever.  The exception propagates to the caller, mirroring the
    thread/process backends' owner-failure contract.

Topology is observable like :class:`ElasticProcessPool`'s resizes: ``join``
/ ``leave`` / ``requeue`` events accumulate in ``EvalCoordinator.events``
and ``stats()`` snapshots the registry (now including per-tenant grant
accounting).

The parent keeps the shared :class:`ScoreCache` and the in-flight future
table (duplicate submissions for one genome collapse onto one wire task),
so cache behaviour is identical to the process backend's.  Both are keyed by
``ParentCacheBackend.score_key`` — the fidelity-aware key — so several
ServiceBackends of one suite at different cascade rungs can share a cache
AND a coordinator (each rung's spec interns to its own wire id) without a
rung-0 result ever masking a rung-2 task.

Client sessions: a HELLO frame whose ``role`` is ``"client"`` routes the
connection to the frontier layer instead of the worker registry — the
coordinator keeps a :class:`ClientSession` per such peer and hands inbound
frames to ``on_client_msg`` (set by a search frontier).  Workers never send
``role``, so older worker binaries register exactly as before.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from multiprocessing import shared_memory
from typing import Callable, Optional, Sequence, Union

from repro_torch.core import obs
from repro_torch.core.evals import protocol
from repro_torch.core.evals.backends import ParentCacheBackend, register_backend
from repro_torch.core.evals.cache import ScoreCache
from repro_torch.core.evals.scorer import batch_scoring_enabled
from repro_torch.core.evals.worker import EvalSpec, intern_spec, prepare_parent
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.core.search_space import KernelGenome

__all__ = ["ClientSession", "EvalCoordinator", "ServiceBackend",
           "spawn_local_workers", "stop_local_workers"]

DEFAULT_TENANT = ""

# per-coordinator registry label (the metrics registry is process-global and
# coordinators are many across a test session)
_COORD_IDS = itertools.count()


class _Tenant:
    """Per-tenant scheduling state: a FIFO of pending tasks plus the grant
    accounting the weighted-fair scheduler and ``stats()`` read.

    The grant counters are registry instruments (``obs.REGISTRY``) labelled
    by coordinator + tenant — the per-tenant demand signal a market-priced
    slot scheme would need.  The scheduler reads ``granted.value``,
    which counts identically to the old plain int, so grant traces are
    unchanged."""

    __slots__ = ("tid", "weight", "queue", "submitted", "granted",
                 "granted_contended", "completed")

    def __init__(self, tid: str, weight: float = 1.0, coord: str = "c?"):
        self.tid = tid
        self.weight = max(float(weight), 1e-9)
        self.queue: deque[dict] = deque()
        reg = obs.REGISTRY
        self.submitted = reg.counter("tenant_submitted",
                                     coord=coord, tenant=tid)
        # slot grants (dispatches incl. retries)
        self.granted = reg.counter("tenant_granted", coord=coord, tenant=tid)
        # grants while >= 2 tenants were queued
        self.granted_contended = reg.counter("tenant_granted_contended",
                                             coord=coord, tenant=tid)
        self.completed = reg.counter("tenant_completed",
                                     coord=coord, tenant=tid)


class _RemoteWorker:
    """Registry entry for one connected worker host."""

    __slots__ = ("wid", "name", "slots", "reader", "writer", "queue",
                 "sender", "conn_task", "in_flight", "last_seen", "alive",
                 "host", "compact", "shm_ok", "specs_known", "segments_known",
                 "trace", "stats_waiters")

    def __init__(self, wid: int, name: str, slots: int,
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter, *,
                 host: Optional[str] = None, compact: bool = False,
                 wants_shm: bool = False, trace: bool = False):
        self.wid = wid
        self.name = name
        self.slots = max(1, slots)
        self.reader = reader
        self.writer = writer
        self.queue: asyncio.Queue = asyncio.Queue()  # encoded outbound frames
        self.sender: Optional[asyncio.Task] = None
        self.conn_task: Optional[asyncio.Task] = None
        self.in_flight: dict[int, dict] = {}       # task id -> task
        self.last_seen = time.monotonic()
        self.alive = True
        # wire-format capabilities from the HELLO frame.  A worker that
        # advertises nothing (old binary, test zombie) gets legacy per-task
        # full-payload frames forever — capability is negotiated, not assumed.
        self.host = host                     # for the same-host shm fast path
        self.compact = compact               # understands batched tasks frames
        # understands the optional per-frame trace map and ships spans back
        # on results (negotiated exactly like compact/shm: a worker that
        # does not advertise it never sees a trace field)
        self.trace = trace
        # None = shm untried (use optimistically), False = failed, disabled
        self.shm_ok: Optional[bool] = None if wants_shm else False
        # announcements already enqueued ahead of any frame that would need
        # them (queue FIFO order makes enqueue == ordered delivery-or-death)
        self.specs_known: set[int] = set()
        self.segments_known: set[str] = set()
        # futures of worker_stats() requests awaiting this worker's reply
        self.stats_waiters: list[concurrent.futures.Future] = []

    @property
    def free_slots(self) -> int:
        return self.slots - len(self.in_flight)


class ClientSession:
    """One connected frontier client (HELLO ``role: "client"``).

    ``send`` is thread-safe — it hops the encoded frame onto the event loop
    and into this connection's FIFO sender queue — so the frontier's job
    threads can stream job-event frames without
    touching the loop directly."""

    __slots__ = ("cid", "name", "queue", "sender", "conn_task", "alive",
                 "_loop")

    def __init__(self, cid: int, name: str, loop: asyncio.AbstractEventLoop):
        self.cid = cid
        self.name = name
        self.queue: asyncio.Queue = asyncio.Queue()
        self.sender: Optional[asyncio.Task] = None
        self.conn_task: Optional[asyncio.Task] = None
        self.alive = True
        self._loop = loop

    def send(self, msg: dict) -> bool:
        """Enqueue one frame for this client; False if the session (or the
        loop) is already gone — the caller just stops streaming."""
        if not self.alive:
            return False
        try:
            data = protocol.encode_frame(msg)
            self._loop.call_soon_threadsafe(self.queue.put_nowait, data)
            return True
        except RuntimeError:
            return False


class _ShmGenomeStore:
    """Append-only arena of pickled genomes in POSIX shared memory — the
    same-host fast path's parent side.  Each unique genome (by key) is
    written once; tasks then carry a ~30-byte ``(segment, offset, length)``
    ref instead of the payload, and a same-host worker reads the bytes
    straight out of the mapping (zero copies through the socket).  Append-only
    is what makes lock-free worker reads safe: a published ref's bytes are
    immutable for the store's lifetime.  The coordinator owns the segments
    and unlinks them on close."""

    def __init__(self, segment_bytes: int = 1 << 20):
        self._segment_bytes = segment_bytes
        self._segments: list[shared_memory.SharedMemory] = []
        self._refs: dict[str, tuple[str, int, int]] = {}   # genome key -> ref
        self._fill = 0
        self.bytes_stored = 0

    def put(self, genome: KernelGenome) -> tuple[str, int, int]:
        """Intern one genome; returns its ``(segment name, offset, length)``."""
        key = genome.key()
        ref = self._refs.get(key)
        if ref is not None:
            return ref
        payload = pickle.dumps(genome, protocol=pickle.HIGHEST_PROTOCOL)
        n = len(payload)
        if not self._segments or self._fill + n > self._segment_bytes:
            self._segments.append(shared_memory.SharedMemory(
                create=True, size=max(self._segment_bytes, n)))
            self._fill = 0
        seg = self._segments[-1]
        seg.buf[self._fill:self._fill + n] = payload
        ref = (seg.name, self._fill, n)
        self._fill += n
        self.bytes_stored += n
        self._refs[key] = ref
        return ref

    @property
    def n_genomes(self) -> int:
        return len(self._refs)

    def close(self) -> None:
        for seg in self._segments:
            try:
                seg.close()
                seg.unlink()
            except OSError:
                pass
        self._segments.clear()
        self._refs.clear()


class EvalCoordinator:
    """Listens for workers, keeps the live host registry, dispatches tasks.

    ``submit(spec, genome)`` returns a ``Future[ScoreVector]`` immediately;
    tasks queue per tenant until a worker with a free slot exists, slots are
    granted weighted-fair across queued tenants (the default tenant alone
    degenerates to the historical FIFO), tasks are dispatched
    least-loaded-first (deterministic id tie-break), and survive the death
    of their worker via front-of-queue requeue.  One coordinator serves any
    number of :class:`ServiceBackend`\\ s (each task carries its own spec;
    workers warm a per-spec scorer table on demand), which is how the island
    engine — and the search frontier's whole job population — shares one
    worker fleet across all suites.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 heartbeat_s: float = 2.0,
                 dead_after_s: Optional[float] = None):
        self.heartbeat_s = heartbeat_s
        self.dead_after_s = dead_after_s if dead_after_s is not None \
            else 3.0 * heartbeat_s
        self._lock = threading.Lock()
        self._roster = threading.Condition(self._lock)  # notified on join
        self._workers: dict[int, _RemoteWorker] = {}
        self._clients: dict[int, ClientSession] = {}
        self._tenants: dict[str, _Tenant] = {}
        self._specs: list[tuple[int, EvalSpec]] = []   # (interned id, spec)
        self._next_wid = itertools.count()
        self._next_cid = itertools.count()
        self._next_tid = itertools.count()
        self._closed = False
        self.peak_workers = 0
        # lifecycle counters live in the process metrics registry, labelled
        # per coordinator; ``stats()`` is now a read of the registry.  These
        # attributes hold the Counter instruments (internal call sites use
        # .inc(); nothing outside this module read the raw ints).
        self.obs_id = f"c{next(_COORD_IDS)}"
        reg = obs.REGISTRY
        self.tasks_submitted = reg.counter("coord_tasks_submitted",
                                           coord=self.obs_id)
        self.tasks_completed = reg.counter("coord_tasks_completed",
                                           coord=self.obs_id)
        self.tasks_requeued = reg.counter("coord_tasks_requeued",
                                          coord=self.obs_id)
        self.granted_contended = reg.counter("coord_granted_contended",
                                             coord=self.obs_id)
        # join/leave totals are counters, not ring scans: the event window
        # below is bounded, so derived counts must not depend on it
        self._m_joined = reg.counter("coord_workers_joined", coord=self.obs_id)
        self._m_left = reg.counter("coord_workers_left", coord=self.obs_id)
        # bounded join/leave/requeue window (a long frontier run used to grow
        # this list without limit); list-attribute reads keep working as views
        self.events = obs.EventRing(
            cap=int(os.environ.get("REPRO_OBS_EVENT_CAP", obs.DEFAULT_CAP)))
        # frontier hooks: called on the EVENT LOOP thread for every frame a
        # client session sends / when one disconnects — handlers must not block
        self.on_client_msg: Optional[Callable[[ClientSession, dict], None]] \
            = None
        self.on_client_close: Optional[Callable[[ClientSession], None]] = None
        # wire accounting for the bench's bytes-per-task metric: every
        # task-carrying frame's on-wire size, and the tasks it carried
        self.wire_task_bytes = 0
        self.wire_tasks_sent = 0
        # same-host fast path: lazily-created genome arena, and this host's
        # name to match worker HELLOs against
        self._hostname = socket.gethostname()
        self._shm_store: Optional[_ShmGenomeStore] = None
        self._shm_broken = False    # /dev/shm unusable: stop trying

        # the listening socket is created synchronously so .address is known
        # before __init__ returns; the event loop adopts it via start_server
        self._listener = socket.create_server((host, port))
        self.address: tuple[str, int] = self._listener.getsockname()[:2]
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop_main, name="eval-coordinator-loop", daemon=True)
        self._thread.start()
        asyncio.run_coroutine_threadsafe(self._start(), self._loop).result()

    # -- the event loop ------------------------------------------------------------
    def _loop_main(self) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_forever()
        finally:
            # drain whatever close() left cancelled, then free the loop
            pending = asyncio.all_tasks(self._loop)
            for task in pending:
                task.cancel()
            if pending:
                self._loop.run_until_complete(asyncio.gather(
                    *pending, return_exceptions=True))
            self._loop.close()

    async def _start(self) -> None:
        self._listener.setblocking(False)
        self._server = await asyncio.start_server(
            self._handle_conn, sock=self._listener)
        self._monitor_task = self._loop.create_task(self._monitor())

    def _call_soon(self, fn, *args) -> None:
        """Schedule a callback on the loop from any thread; a no-op once the
        loop is shutting down (callers are all best-effort nudges)."""
        try:
            self._loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:
            pass

    # -- introspection ------------------------------------------------------------
    @property
    def n_workers(self) -> int:
        with self._lock:
            return len(self._workers)

    @property
    def total_slots(self) -> int:
        with self._lock:
            return sum(w.slots for w in self._workers.values())

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(t.queue) for t in self._tenants.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": len(self._workers),
                "peak_workers": self.peak_workers,
                "total_slots": sum(w.slots for w in self._workers.values()),
                "queue_depth": sum(len(t.queue)
                                   for t in self._tenants.values()),
                "in_flight": sum(len(w.in_flight)
                                 for w in self._workers.values()),
                "tasks_submitted": self.tasks_submitted.value,
                "tasks_completed": self.tasks_completed.value,
                "tasks_requeued": self.tasks_requeued.value,
                "granted_contended": self.granted_contended.value,
                "joined": self._m_joined.value,
                "left": self._m_left.value,
                "wire_task_bytes": self.wire_task_bytes,
                "wire_tasks_sent": self.wire_tasks_sent,
                "wire_bytes_per_task": (self.wire_task_bytes /
                                        self.wire_tasks_sent
                                        if self.wire_tasks_sent else 0.0),
                "shm_genomes": (self._shm_store.n_genomes
                                if self._shm_store else 0),
                "shm_bytes": (self._shm_store.bytes_stored
                              if self._shm_store else 0),
                "clients": len(self._clients),
                "tenants": {t.tid: {"weight": t.weight,
                                    "queued": len(t.queue),
                                    "submitted": t.submitted.value,
                                    "granted": t.granted.value,
                                    "granted_contended":
                                        t.granted_contended.value,
                                    "completed": t.completed.value}
                            for t in self._tenants.values()},
                "events": list(self.events),
                "events_dropped": self.events.dropped,
            }

    def wait_for_workers(self, n: int, timeout: Optional[float] = None) -> bool:
        """Block until at least ``n`` workers are registered (True) or the
        timeout lapses (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._roster:
            while len(self._workers) < n:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._roster.wait(remaining)
            return True

    def spawn_workers(self, n: int, *, slots: int = 1,
                      timeout_s: float = 60.0,
                      device: Optional[str] = None) -> list:
        """Spawn ``n`` localhost worker processes against this coordinator
        and block until all have registered — the one registration-failure
        contract every owner (ServiceBackend, the island engine) shares.  On
        timeout the coordinator is closed, the processes are stopped, and a
        RuntimeError reports how many made it.  ``device`` is where the
        workers score (``None``: the card)."""
        procs = spawn_local_workers(self.address, n, slots=slots,
                                    device=device)
        if not self.wait_for_workers(n, timeout=timeout_s):
            got = self.n_workers
            self.close()
            stop_local_workers(procs)
            raise RuntimeError(
                f"only {got}/{n} service workers registered within "
                f"{timeout_s:.0f}s")
        return procs

    def worker_stats(self, timeout: float = 30.0) -> dict:
        """``{worker name: its stats reply}`` from every live worker
        (``worker.worker_stats``); a worker that does not reply within
        ``timeout`` seconds is left out."""
        with self._lock:
            waiting = []
            for w in self._workers.values():
                if w.alive:
                    fut: concurrent.futures.Future = concurrent.futures.Future()
                    w.stats_waiters.append(fut)
                    waiting.append((w.name, fut))
                    self._enqueue_locked(w, {"type": protocol.STATS})
        out = {}
        deadline = time.monotonic() + timeout
        for name, fut in waiting:
            try:
                out[name] = fut.result(max(0.0, deadline - time.monotonic()))
            except (concurrent.futures.TimeoutError,
                    concurrent.futures.CancelledError):
                pass
        return out

    # -- tenants -------------------------------------------------------------------
    def _tenant_locked(self, tid: str) -> _Tenant:
        t = self._tenants.get(tid)
        if t is None:
            t = self._tenants[tid] = _Tenant(tid, coord=self.obs_id)
        return t

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Set one tenant's fair-share weight (the frontier re-computes
        priority x remaining-budget at every job chunk boundary)."""
        with self._lock:
            self._tenant_locked(tenant).weight = max(float(weight), 1e-9)

    # -- the scoring surface -------------------------------------------------------
    def register_spec(self, spec: EvalSpec) -> int:
        """Announce a spec so current AND future workers pre-warm its scorer
        (first-evaluation latency only; tasks announce any spec a worker has
        not yet confirmed).  Returns the spec's interned wire id."""
        sid = intern_spec(spec)
        with self._lock:
            if any(s == spec for _, s in self._specs):
                return sid
            self._specs.append((sid, spec))
        self._call_soon(self._warm_workers, sid, spec)
        return sid

    def _warm_workers(self, sid: int, spec: EvalSpec) -> None:
        """Loop-thread: enqueue a WARM frame to every live worker that has
        not seen this spec.  FIFO queues make the announcement ordered ahead
        of any later tasks frame addressing the spec by id."""
        with self._lock:
            for w in self._workers.values():
                if w.alive and sid not in w.specs_known:
                    self._enqueue_locked(w, {"type": protocol.WARM,
                                             "specs": ((sid, spec),)})
                    w.specs_known.add(sid)

    def submit(self, spec: EvalSpec, genome: KernelGenome, *,
               tenant: str = DEFAULT_TENANT,
               trace: Optional[str] = None) -> concurrent.futures.Future:
        return self.submit_many(spec, (genome,), tenant=tenant,
                                trace=trace)[0]

    def submit_many(self, spec: EvalSpec, genomes: Sequence[KernelGenome], *,
                    tenant: str = DEFAULT_TENANT,
                    trace: Optional[str] = None) -> list:
        """Queue a batch under one lock pass; the whole batch rides to each
        assigned worker in one ``tasks`` frame (see :meth:`_dispatch`).
        ``trace`` tags every task with the submitter's eval-lifecycle trace
        id; ``attempt`` counts dispatches (a death-requeue increments it, so
        a retried eval's spans show both attempts)."""
        sid = intern_spec(spec)
        futs: list[concurrent.futures.Future] = []
        with self._lock:
            if self._closed:
                raise RuntimeError("submit on closed EvalCoordinator")
            t = self._tenant_locked(tenant)
            for genome in genomes:
                fut: concurrent.futures.Future = concurrent.futures.Future()
                t.queue.append({"id": next(self._next_tid), "spec": spec,
                                "sid": sid, "genome": genome,
                                "tenant": tenant, "future": fut,
                                "trace": trace, "attempt": 0})
                t.submitted.inc()
                self.tasks_submitted.inc()
                futs.append(fut)
        self._call_soon(self._dispatch)
        return futs

    # -- dispatch (loop thread only) -------------------------------------------------
    def _dispatch(self) -> None:
        """Feed free worker slots from the tenant queues — each grant goes to
        the queued tenant minimizing granted/weight (weighted fair; the
        default tenant alone is plain FIFO) and to the least-loaded worker
        (wid tie-break) — coalescing everything assigned to one worker into
        a single ``tasks`` frame (legacy workers get per-task frames).
        Frames are encoded here and enqueued on each worker's sender queue;
        enqueue cannot fail, so a send failure surfaces in the sender
        coroutine as a worker death (requeue + re-dispatch), never here."""
        traced: list[tuple] = []
        with self._lock:
            if self._closed:
                return
            grouped: dict[int, tuple[_RemoteWorker, list[dict]]] = {}
            while True:
                queued = [t for t in self._tenants.values() if t.queue]
                if not queued:
                    break
                free = [w for w in self._workers.values()
                        if w.alive and w.free_slots > 0]
                if not free:
                    break
                contended = len(queued) >= 2
                # weighted fair share: grant the slot to the queued tenant
                # with the lowest granted/weight (tenant id breaks ties)
                t = min(queued,
                        key=lambda t: (t.granted.value / t.weight, t.tid))
                task = t.queue.popleft()
                if task["future"].cancelled():
                    continue
                # least-loaded first; wid breaks ties deterministically
                w = min(free, key=lambda w: (len(w.in_flight) / w.slots,
                                             w.wid))
                w.in_flight[task["id"]] = task
                t.granted.inc()
                if contended:
                    t.granted_contended.inc()
                    self.granted_contended.inc()
                grouped.setdefault(w.wid, (w, []))[1].append(task)
            for w, tasks in grouped.values():
                frames, sids, segs = self._encode_tasks_locked(w, tasks)
                sent = 0
                for frame in frames:
                    sent += self._enqueue_locked(w, frame)
                # accounted at enqueue time, under the lock: strictly before
                # the worker can have received the frame, with the exact
                # on-wire size (encode_frame bytes == protocol.frame_size)
                self.wire_task_bytes += sent
                self.wire_tasks_sent += len(tasks)
                w.specs_known |= sids
                w.segments_known |= segs
                for task in tasks:
                    if task.get("trace"):
                        traced.append((task["trace"], task["attempt"],
                                       w.name, task["tenant"]))
        if traced and obs.enabled():
            # one dispatch span per (task, attempt), published outside the
            # lock: a SIGKILLed eval's trace shows every attempt
            for tr, attempt, wname, tenant in traced:
                obs.span("dispatch", tr, worker=wname, attempt=attempt,
                         tenant=tenant)

    def _enqueue_locked(self, w: _RemoteWorker, msg: dict) -> int:
        """Encode one frame onto a worker's sender queue; returns its exact
        on-wire size.  FIFO per connection — enqueue order IS delivery order
        (or the worker dies and everything requeues)."""
        data = protocol.encode_frame(msg)
        w.queue.put_nowait(data)
        return len(data)

    def _encode_tasks_locked(self, w: _RemoteWorker, tasks: list[dict]
                             ) -> tuple[list[dict], set[int], set[str]]:
        """Encode one worker's assignments.  Compact workers get ONE batched
        frame of seed-relative edit lists (or shm refs on the same host) plus
        whatever spec/segment announcements this worker still needs; legacy
        workers get one full-payload frame per task.  Returns the frames and
        the announced spec ids / segment names (confirmed at enqueue)."""
        if not w.compact:
            # a worker that never advertised ``trace`` in HELLO gets frames
            # byte-identical to the pre-trace protocol (same negotiation
            # contract as compact/shm: legacy binaries are untouched)
            frames = []
            for t in tasks:
                frame = {"type": protocol.TASK, "id": t["id"],
                         "spec": t["spec"], "genome": t["genome"]}
                if w.trace and t.get("trace"):
                    frame["trace"] = {t["id"]: (t["trace"], t["attempt"])}
                frames.append(frame)
            return (frames, set(), set())
        use_shm = (w.host == self._hostname and w.shm_ok is not False
                   and not self._shm_broken)
        entries, need_specs, need_segs = [], {}, set()
        for t in tasks:
            sid = t["sid"]
            if sid not in w.specs_known:
                need_specs[sid] = t["spec"]
            payload = None
            if use_shm:
                try:
                    if self._shm_store is None:
                        self._shm_store = _ShmGenomeStore()
                    seg, off, ln = self._shm_store.put(t["genome"])
                except OSError as e:
                    self._shm_broken = True     # no usable /dev/shm: fall back
                    use_shm = False
                    if obs.enabled():
                        obs.publish("shm_broken", coord=self.obs_id,
                                    reason=f"{type(e).__name__}: {e}")
                else:
                    payload = ("shm", seg, off, ln, sid)
                    if seg not in w.segments_known:
                        need_segs.add(seg)
            if payload is None:
                payload = ("ed", t["genome"].to_edits(), sid)
            entries.append((t["id"], payload))
        frame = {"type": protocol.TASKS, "tasks": entries}
        if need_specs:
            frame["specs"] = tuple(need_specs.items())
        if need_segs:
            frame["shm"] = tuple(need_segs)
        if w.trace:
            tmap = {t["id"]: (t["trace"], t["attempt"])
                    for t in tasks if t.get("trace")}
            if tmap:
                frame["trace"] = tmap
        return ([frame], set(need_specs), need_segs)

    # -- connection handling (loop thread) -------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            hello = await protocol.async_recv_msg(reader)
            if hello.get("type") != protocol.HELLO:
                writer.close()
                return
        except Exception:
            # anything up to and including garbage bytes from a stray
            # client (the listener may be bound 0.0.0.0): not a peer
            writer.close()
            return
        if hello.get("role") == "client":
            await self._serve_client(hello, reader, writer)
        else:
            await self._serve_worker(hello, reader, writer)

    async def _sender_loop(self, w: _RemoteWorker) -> None:
        """Drain one worker's frame queue onto its socket.  ``drain()`` is
        the backpressure: a slow worker blocks only this coroutine while its
        queue absorbs bursts.  A send failure is a synchronous death."""
        try:
            while True:
                data = await w.queue.get()
                if data is None:
                    return
                w.writer.write(data)
                await w.writer.drain()
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError):
            self._worker_died(w, "send failed")

    async def _serve_worker(self, hello: dict, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        package = hello.get("package", "repro")
        if package != protocol.PACKAGE:
            why = (f"this coordinator serves {protocol.PACKAGE} workers; "
                   f"worker {hello.get('name')!r} speaks for {package!r}, "
                   f"whose scorer cannot read {protocol.PACKAGE} specs")
            with self._lock:
                self.events.append({"event": "refused",
                                    "worker": hello.get("name"), "why": why})
            try:
                await protocol.async_send_msg(
                    writer, {"type": protocol.REFUSED, "error": why})
            except (ConnectionError, OSError):
                pass
            writer.close()
            return
        with self._lock:
            if self._closed:
                writer.close()
                return
            wid = next(self._next_wid)
            w = _RemoteWorker(wid, hello.get("name") or f"worker{wid}",
                              int(hello.get("slots", 1)), reader, writer,
                              host=hello.get("host"),
                              compact=bool(hello.get("compact")),
                              wants_shm=bool(hello.get("shm")),
                              trace=bool(hello.get("trace")))
            w.conn_task = asyncio.current_task()
            # WELCOME is enqueued before the worker becomes dispatchable, in
            # the same critical section — queue FIFO order guarantees no
            # TASK/WARM frame ever beats it.  specs travel as (interned id,
            # spec) pairs; warm_worker registers the ids so later tasks
            # frames can address specs by id alone.
            specs_sent = tuple(self._specs)
            self._enqueue_locked(w, {"type": protocol.WELCOME,
                                     "worker_id": wid,
                                     "heartbeat_s": self.heartbeat_s,
                                     "specs": specs_sent})
            w.specs_known |= {sid for sid, _ in specs_sent}
            self._workers[wid] = w
            self.peak_workers = max(self.peak_workers, len(self._workers))
            self._m_joined.inc()
            self.events.append({"event": "join", "worker": w.name,
                                "slots": w.slots,
                                "workers": len(self._workers)})
            self._roster.notify_all()
        if obs.enabled():
            obs.publish("join", worker=w.name, coord=self.obs_id,
                        slots=w.slots, trace_capable=w.trace)
        w.sender = self._loop.create_task(self._sender_loop(w))
        self._dispatch()
        while True:
            try:
                msg = await protocol.async_recv_msg(w.reader)
            except asyncio.CancelledError:
                return
            except (ConnectionError, OSError):
                self._worker_died(w, "connection lost")
                return
            except Exception as e:
                # a corrupt frame is as fatal as a dead peer: take the
                # synchronous death path (requeue + eviction), never leave
                # the worker registered with a dead reader
                self._worker_died(w, f"protocol error: {type(e).__name__}")
                return
            with self._lock:
                w.last_seen = time.monotonic()
            kind = msg.get("type")
            if kind == protocol.RESULT:
                self._complete(w, msg)
            elif kind == protocol.SHM_OK:
                with self._lock:
                    w.shm_ok = True
                    w.segments_known.update(msg.get("segments", ()))
            elif kind == protocol.STATS:
                with self._lock:
                    waiters, w.stats_waiters = w.stats_waiters, []
                for fut in waiters:
                    fut.set_result(msg.get("value"))
            # heartbeats (and anything unknown) only refresh last_seen

    async def _serve_client(self, hello: dict, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        with self._lock:
            if self._closed or self.on_client_msg is None:
                writer.close()      # nobody is serving jobs on this fleet
                return
            cid = next(self._next_cid)
            session = ClientSession(cid, hello.get("name") or f"client{cid}",
                                    self._loop)
            session.conn_task = asyncio.current_task()
            self._clients[cid] = session
        session.queue.put_nowait(protocol.encode_frame(
            {"type": protocol.WELCOME, "client_id": cid}))
        session.sender = self._loop.create_task(
            self._client_sender(session, writer))
        try:
            while True:
                try:
                    msg = await protocol.async_recv_msg(reader)
                except asyncio.CancelledError:
                    return
                except Exception:
                    return           # client went away (or spoke garbage)
                handler = self.on_client_msg
                if handler is not None:
                    try:
                        handler(session, msg)
                    except Exception:
                        pass         # a bad job payload must not kill the loop
        finally:
            session.alive = False
            with self._lock:
                self._clients.pop(cid, None)
            if session.sender is not None:
                session.sender.cancel()
            writer.close()
            closer = self.on_client_close
            if closer is not None:
                try:
                    closer(session)
                except Exception:
                    pass

    async def _client_sender(self, session: ClientSession,
                             writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                data = await session.queue.get()
                if data is None:
                    return
                writer.write(data)
                await writer.drain()
        except (asyncio.CancelledError, ConnectionError, OSError):
            session.alive = False

    # -- results + death (loop thread) ------------------------------------------------
    def _complete(self, w: _RemoteWorker, msg: dict) -> None:
        if msg.get("shm_failure"):
            # the worker could not attach/read the shared-memory payload —
            # disable the fast path for it and requeue the task (front of
            # queue, like a death requeue): it re-dispatches as an ordinary
            # edit-list frame, so the waiting future completes late, not wrong
            with self._lock:
                task = w.in_flight.pop(msg["id"], None)
                w.shm_ok = False
                w.segments_known.clear()
                if task is not None:
                    task["attempt"] += 1
                    self._tenant_locked(task["tenant"]).queue.appendleft(task)
                    self.tasks_requeued.inc()
                    self.events.append({"event": "requeue", "worker": w.name,
                                        "tasks": 1,
                                        "workers": len(self._workers),
                                        "why": "shm"})
            if task is not None and obs.enabled():
                obs.publish("shm_failure", worker=w.name, coord=self.obs_id,
                            reason="worker could not attach/read shm payload",
                            trace=task.get("trace"))
            self._dispatch()
            return
        with self._lock:
            task = w.in_flight.pop(msg["id"], None)
            if task is not None:
                self.tasks_completed.inc()
                self._tenant_locked(task["tenant"]).completed.inc()
        if task is None:
            return        # task was requeued past this worker; stale result
        if task.get("trace") and obs.enabled():
            # worker-side spans piggyback on the RESULT frame; re-publish
            # them here stitched onto the task's trace so one journal holds
            # the whole eval lifecycle across hosts
            for sp in msg.get("spans", ()):
                obs.span(sp.get("span", "?"), task["trace"], worker=w.name,
                         attempt=task["attempt"],
                         **{k: v for k, v in sp.items() if k != "span"})
            obs.span("harvest_wire", task["trace"], worker=w.name,
                     attempt=task["attempt"], ok=bool(msg.get("ok")))
        fut = task["future"]
        try:
            if msg.get("ok"):
                fut.set_result(msg["value"])
            else:
                fut.set_exception(RuntimeError(
                    f"remote evaluation failed on {w.name}: "
                    f"{msg.get('error')}"))
        except concurrent.futures.InvalidStateError:
            pass          # cancelled during teardown: nobody is waiting
        self._dispatch()

    def _worker_died(self, w: _RemoteWorker, why: str) -> None:
        to_cancel: list[dict] = []
        with self._lock:
            if not w.alive:
                return
            w.alive = False
            self._workers.pop(w.wid, None)
            orphans = sorted(w.in_flight.values(), key=lambda t: t["id"])
            w.in_flight.clear()
            if self._closed:
                # shutting down: no surviving fleet will ever run these.
                # Cancelled OUTSIDE the lock — cancel() runs done callbacks
                # synchronously, and a ServiceBackend callback takes the
                # backend lock (held around coordinator.submit on the
                # submit path: cancelling here would invert the lock order)
                to_cancel, orphans = orphans, []
            # front of the tenant's queue, original order: requeued work must
            # not queue behind speculation submitted after it
            for task in reversed(orphans):
                task["attempt"] += 1
                self._tenant_locked(task["tenant"]).queue.appendleft(task)
            self.tasks_requeued.inc(len(orphans))
            self._m_left.inc()
            self.events.append({"event": "leave", "worker": w.name,
                                "workers": len(self._workers), "why": why})
            if orphans:
                self.events.append({"event": "requeue", "worker": w.name,
                                    "tasks": len(orphans),
                                    "workers": len(self._workers)})
            requeued_traces = [(t["trace"], t["attempt"]) for t in orphans
                               if t.get("trace")]
        if obs.enabled():
            obs.publish("leave", worker=w.name, coord=self.obs_id, why=why)
            # each orphan's NEW attempt number: the next dispatch span for
            # this trace carries it, so a SIGKILLed eval shows both attempts
            for tr, attempt in requeued_traces:
                obs.span("requeue", tr, worker=w.name, attempt=attempt,
                         why=why)
        for task in to_cancel:
            task["future"].cancel()
        with self._lock:
            waiters, w.stats_waiters = w.stats_waiters, []
        for fut in waiters:
            fut.cancel()
        if w.sender is not None:
            w.sender.cancel()
        try:
            w.writer.close()
        except Exception:
            pass
        self._dispatch()

    async def _monitor(self) -> None:
        """Evict workers that stopped heartbeating (hang/partition — the
        asynchronous half of dead-worker detection)."""
        while True:
            await asyncio.sleep(min(self.heartbeat_s, self.dead_after_s) / 2.0)
            with self._lock:
                if self._closed:
                    return
                now = time.monotonic()
                silent = [w for w in self._workers.values()
                          if now - w.last_seen > self.dead_after_s]
            for w in silent:
                self._worker_died(
                    w, f"missed heartbeats for {self.dead_after_s:.1f}s")

    # -- lifecycle -----------------------------------------------------------------
    async def _shutdown(self, workers: list[_RemoteWorker],
                        clients: list[ClientSession]) -> None:
        for w in workers:
            try:
                w.queue.put_nowait(protocol.encode_frame(
                    {"type": protocol.SHUTDOWN}))
                w.queue.put_nowait(None)          # sender: flush then exit
            except Exception:
                pass
        for c in clients:
            c.alive = False
            c.queue.put_nowait(None)
        senders = [w.sender for w in workers if w.sender is not None] \
            + [c.sender for c in clients if c.sender is not None]
        if senders:
            await asyncio.wait(senders, timeout=2.0)
        self._server.close()
        self._monitor_task.cancel()
        for w in workers:
            try:
                w.writer.close()
            except Exception:
                pass
            if w.conn_task is not None:
                w.conn_task.cancel()
        for c in clients:
            if c.conn_task is not None:
                c.conn_task.cancel()
        await self._server.wait_closed()

    def close(self) -> None:
        """Idempotent: cancel queued work, tell workers to exit, stop
        listening, stop the event loop.  ``submit`` afterwards raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = list(self._workers.values())
            clients = list(self._clients.values())
            pending = [task for t in self._tenants.values()
                       for task in t.queue]
            for t in self._tenants.values():
                t.queue.clear()
        for task in pending:
            task["future"].cancel()
        try:
            asyncio.run_coroutine_threadsafe(
                self._shutdown(workers, clients), self._loop).result(5.0)
        except Exception:
            pass
        self._call_soon(self._loop.stop)
        self._thread.join(timeout=5.0)
        self._listener.close()
        # readers the loop never got to run again: their in-flight futures
        # would otherwise dangle forever
        leftovers: list[dict] = []
        with self._lock:
            for w in workers:
                leftovers.extend(w.in_flight.values())
                w.in_flight.clear()
        for task in leftovers:
            task["future"].cancel()
        if self._shm_store is not None:
            self._shm_store.close()     # unlink the same-host genome arena


def _worker_env() -> dict:
    """Child env with this checkout's ``repro_torch`` importable, whatever
    the parent's own sys.path tricks were (tests prepend src/ manually)."""
    import repro_torch
    # locate the package by __path__ as well, should it lose its __init__
    pkg_dir = (os.path.dirname(repro_torch.__file__)
               if getattr(repro_torch, "__file__", None)
               else next(iter(repro_torch.__path__)))
    src = os.path.dirname(os.path.abspath(pkg_dir))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    # spawned workers inherit the parent's batch-scoring setting, so a
    # whole fleet A/Bs (or rolls back) the columnar path with one switch
    env["REPRO_BATCH_SCORING"] = "1" if batch_scoring_enabled() else "0"
    # same switch semantics for observability: a fleet's workers trace
    # exactly when the parent does
    env["REPRO_OBS"] = "1" if obs.enabled() else "0"
    return env


def spawn_local_workers(address: tuple[str, int], n: int, *,
                        slots: int = 1,
                        device: Optional[str] = None) -> list[subprocess.Popen]:
    """Start ``n`` localhost worker processes connected to ``address`` — the
    single-host convenience path (tests, the chip smoke run, the CLI).
    ``device`` is passed on as ``--device`` (``None``: the worker's default,
    the card).  Real cross-host deployment runs the same entrypoint on other
    machines: ``python -m repro_torch.core.evals.service_worker --connect
    HOST:PORT``."""
    host, port = address
    extra = [] if device is None else ["--device", str(device)]
    procs = []
    for i in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.core.evals.service_worker",
             "--connect", f"{host}:{port}", "--slots", str(slots),
             "--name", f"local{i}", *extra],
            env=_worker_env()))
    return procs


def stop_local_workers(procs: Sequence[subprocess.Popen],
                       timeout: float = 5.0) -> None:
    """Terminate spawned workers, escalating to kill after ``timeout``."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class ServiceBackend(ParentCacheBackend):
    """The ``service`` evaluation backend: scoring fans out over TCP to the
    coordinator's live worker fleet.

    Same parent-side contract as :class:`ProcessBackend` (both inherit it
    from :class:`~repro_torch.core.evals.backends.ParentCacheBackend`): the shared
    :class:`ScoreCache` and the in-flight future table live here, concurrent
    requests for one genome collapse onto one wire task, a failed evaluation
    is evicted (never cached) so callers can retry, and ``close`` is
    idempotent.  Worker death is invisible at this layer — the coordinator
    requeues and the futures complete late, not wrong.

    Pass ``coordinator=`` to share one fleet across several backends (one
    per suite, as the island engine does); otherwise the backend owns a
    fresh coordinator and — when ``workers`` > 0 — a set of spawned
    localhost worker processes (``--device`` from the spec; a card spec
    needs a card here and builds the kernel before the first worker
    starts), both torn down on ``close``.  ``listen``
    sets the owned coordinator's bind address: the loopback default serves
    single-host fleets; bind ``"0.0.0.0:PORT"`` to let workers on OTHER
    hosts register (then give them this host's reachable name/IP).
    ``tenant`` names the coordinator scheduling tenant this backend's tasks
    bill against — the frontier runs each job under its own tenant so the
    weighted-fair scheduler can apportion the shared fleet's slots.
    """

    def __init__(self, suite: Union[str, Sequence[BenchConfig], None] = None, *,
                 spec: Optional[EvalSpec] = None,
                 check_correctness: bool = True, rng_seed: int = 0,
                 device: Optional[str] = None, machine: Optional[str] = None,
                 coordinator: Optional[EvalCoordinator] = None,
                 workers: Optional[int] = None,
                 worker_slots: int = 1,
                 worker_timeout_s: float = 60.0,
                 listen: str = "127.0.0.1:0",
                 tenant: str = DEFAULT_TENANT,
                 cache: Optional[ScoreCache] = None):
        super().__init__(spec if spec is not None else EvalSpec.resolve(
            suite, check_correctness, rng_seed, device=device,
            machine=machine), cache)
        self._own_coordinator = coordinator is None
        self.tenant = tenant
        self.coordinator = coordinator if coordinator is not None \
            else EvalCoordinator(*protocol.parse_address(listen))
        self._procs: list[subprocess.Popen] = []
        if self._own_coordinator:
            n = 2 if workers is None else workers
            if n > 0:
                try:
                    prepare_parent((self.spec,))
                except Exception:
                    self.coordinator.close()
                    raise
                # on timeout this closes the coordinator + stops the procs
                self._procs = self.coordinator.spawn_workers(
                    n, slots=worker_slots, timeout_s=worker_timeout_s,
                    device=self.spec.device)
        elif workers:
            raise ValueError("workers= is owned-coordinator only; spawn "
                             "workers against the shared coordinator instead")
        self.coordinator.register_spec(self.spec)

    @property
    def address(self) -> tuple[str, int]:
        """Where additional workers can ``--connect``."""
        return self.coordinator.address

    @property
    def max_workers(self) -> int:
        """Current fleet capacity in slots (reports/JSON; live, not static)."""
        return self.coordinator.total_slots

    obs_name = "service"

    def _dispatch_eval(self, genome: KernelGenome) -> concurrent.futures.Future:
        """One task on the wire.  ``n_evaluations`` counts these dispatches;
        a dead worker's requeues are coordinator-internal, not re-counted."""
        return self.coordinator.submit(
            self.spec, genome, tenant=self.tenant,
            trace=obs.current_trace() if obs.enabled() else None)

    def _dispatch_eval_many(self, genomes: Sequence[KernelGenome]) -> list:
        """A whole deduped batch in one coordinator pass — the tasks travel
        to each assigned worker in a single batched frame instead of
        len(batch) round trips (``map``/``prefetch`` land here via
        ``ParentCacheBackend.submit_many``)."""
        return self.coordinator.submit_many(
            self.spec, genomes, tenant=self.tenant,
            trace=obs.current_trace() if obs.enabled() else None)

    def _close_resources(self) -> None:
        """A shared coordinator is left running for its other backends."""
        if self._own_coordinator:
            self.coordinator.close()
            stop_local_workers(self._procs)


def _service_factory(spec: EvalSpec, cache: Optional[ScoreCache] = None,
                     **kw) -> ServiceBackend:
    return ServiceBackend(spec=spec, cache=cache, **kw)


register_backend("service", _service_factory, needs_coordinator=True)
