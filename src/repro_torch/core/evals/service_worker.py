"""The standalone evaluation-service worker.

Run one per card (or several on one card) against a coordinator:

  python -m repro_torch.core.evals.service_worker --connect HOST:PORT
  python -m repro_torch.core.evals.service_worker --connect HOST:PORT --slots 2
  python -m repro_torch.core.evals.service_worker --connect HOST:PORT --device cpu

``--device`` is where the worker scores: the card by default (a worker
asked for the card on a host without one raises at start, it never falls
back to the CPU), ``cuda:N`` for one card of several, ``cpu`` for the plain
path.  A task whose spec leaves the device open (``None``, the card) scores
on the worker's own card; a spec naming another device type is refused
with an error result.

The worker registers, pre-warms a per-spec :class:`Scorer` table for every
spec the coordinator announces (so the first real evaluation pays no warmup),
heartbeats on the interval the coordinator dictates, and streams results
back as they complete.  Evaluation rebuilds the genome and scorer
deterministically from the task payload, so a ScoreVector computed here is
bit-identical to one computed inline, in a local worker process, or on any
other host.

Wire formats served (capabilities advertised in HELLO, never assumed):

  * legacy ``task`` frames — full ``(spec, genome)`` pickles;
  * batched ``tasks`` frames — many assignments per frame, each payload a
    seed-relative edit list (``("ed", edits, sid)``) or, when this worker
    runs on the coordinator's own host, a shared-memory ref
    (``("shm", segment, offset, length, sid)``) read straight out of the
    coordinator's genome arena.  ``sid`` names a spec announced earlier
    (WELCOME/WARM/in-frame ``specs`` pairs); announcements repeat until a
    carrying frame is delivered, and re-registration is a no-op, so a task
    can never reference a spec this worker has not seen.

A shared-memory ref the worker cannot attach or decode is reported as a
``shm_failure`` result: the coordinator requeues the task as an ordinary
edit-list frame and stops sending this worker shm refs — degraded, never
wrong.

``--slots N`` evaluates up to N tasks concurrently on a thread pool: sleeps
from a latency-modelled spec (``service_latency_s``) and host work overlap,
while the card's lock (``device.card_lock``) still lets one evaluation at a
time run its gate or its timing on the card.  A ``stats`` frame is answered
with ``worker.worker_stats()``.

:class:`EvalServiceWorker` is also usable programmatically (tests run it on
a thread inside the parent process — registration, dedup, and identity paths
without process spin-up; fault tests use real killed subprocesses).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import pickle
import socket
import threading
import time
from multiprocessing import shared_memory
from typing import Optional, Sequence

import torch

from repro_torch.core.evals import protocol
from repro_torch.core.evals.scorer import batch_scoring_enabled
from repro_torch.core.evals.worker import (EvalSpec, _scorer_for,
                                           evaluate_genome, worker_stats)
from repro_torch.core.search_space import KernelGenome
from repro_torch.device import resolve_device

__all__ = ["EvalServiceWorker", "main"]


def _attach_readonly(name: str) -> shared_memory.SharedMemory:
    """Attach an existing segment WITHOUT adopting ownership: the coordinator
    created it and will unlink it.  Python < 3.13 has no ``track=False``, and
    its resource tracker would unlink the segment when this process exits —
    yanking the arena out from under the coordinator — so the registration is
    explicitly undone."""
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:
        seg = shared_memory.SharedMemory(name=name)
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:
            pass
        return seg


class EvalServiceWorker:
    """One worker host: connect, register, serve tasks until shutdown."""

    def __init__(self, host: str, port: int, *, slots: int = 1,
                 name: Optional[str] = None, device: Optional[str] = None):
        # resolved here: a worker asked for the card on a host without one
        # raises before it registers
        self.device = resolve_device(device)
        self.host = host
        self.port = port
        self.slots = max(1, slots)
        self.name = name
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        # per-instance, not module-global: several workers (tests) or several
        # coordinators' id spaces must never bleed into each other
        self._specs: dict[int, EvalSpec] = {}
        self._segments: dict[str, shared_memory.SharedMemory] = {}
        self._seg_lock = threading.Lock()

    # -- plumbing -----------------------------------------------------------------
    def _send(self, msg: dict) -> None:
        protocol.send_msg(self._sock, msg, lock=self._send_lock)

    def _bind(self, spec: EvalSpec) -> EvalSpec:
        """The spec as this worker scores it: an open device (the card) is
        this worker's own; another device type is refused."""
        want = torch.device(spec.device or "cuda")
        if want.type != self.device.type:
            raise RuntimeError(
                f"worker {self.name!r} scores on {self.device}; the task asks "
                f"for {spec.device or 'the card'}")
        if spec.device is None:
            spec = dataclasses.replace(spec, device=str(self.device))
        return spec

    def _warm(self, pool: concurrent.futures.Executor,
              specs: Sequence) -> None:
        """Register announced ``(sid, spec)`` pairs (bare specs tolerated) and
        pre-build scorers off the receive loop — a long proxy-input build
        must never starve heartbeats or task intake."""
        for item in specs:
            if isinstance(item, EvalSpec):
                spec = item
            else:
                sid, spec = item
                self._specs[int(sid)] = spec
            pool.submit(lambda s=spec: _scorer_for(self._bind(s)).warm())

    def _shm_genome(self, seg_name: str, off: int, ln: int) -> KernelGenome:
        """Read one pickled genome straight out of the coordinator's arena
        (attaching the segment on first reference)."""
        with self._seg_lock:
            seg = self._segments.get(seg_name)
            if seg is None:
                seg = _attach_readonly(seg_name)
                self._segments[seg_name] = seg
                fresh = True
            else:
                fresh = False
        if fresh:
            self._send({"type": protocol.SHM_OK, "segments": (seg_name,)})
        return pickle.loads(bytes(seg.buf[off:off + ln]))

    def _evaluate(self, task_id: int, spec: EvalSpec, genome,
                  traced: bool = False) -> None:
        """Legacy full-payload task frame.  ``traced`` tasks time the score
        and piggyback the span on the RESULT frame (the coordinator stitches
        it onto the submitter's trace) — untraced tasks pay nothing and their
        frames stay byte-identical to the pre-trace wire."""
        try:
            t0 = time.perf_counter() if traced else 0.0
            sv = evaluate_genome(genome, self._bind(spec))
            msg = {"type": protocol.RESULT, "id": task_id, "ok": True,
                   "value": sv}
            if traced:
                msg["spans"] = ({"span": "score",
                                 "dur_s": round(time.perf_counter() - t0, 6),
                                 "rung": getattr(spec, "fidelity", None)},)
        except Exception as e:            # deterministic failure: report, not retry
            msg = {"type": protocol.RESULT, "id": task_id, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        try:
            self._send(msg)
        except OSError:
            self._stop.set()              # coordinator gone: wind down

    def _evaluate_entry(self, task_id: int, payload: tuple,
                        traced: bool = False) -> None:
        """One assignment from a batched ``tasks`` frame."""
        try:
            t0 = time.perf_counter() if traced else 0.0
            if payload[0] == "shm":
                _, seg_name, off, ln, sid = payload
                try:
                    genome = self._shm_genome(seg_name, off, ln)
                except Exception:
                    # cannot reach the arena: ask for the payload another way
                    self._send({"type": protocol.RESULT, "id": task_id,
                                "shm_failure": True})
                    return
            else:
                _, edits, sid = payload
                genome = KernelGenome.from_edits(edits)
            t1 = time.perf_counter() if traced else 0.0
            spec = self._specs.get(sid)
            if spec is None:
                raise RuntimeError(f"task references unannounced spec id {sid}")
            sv = _scorer_for(self._bind(spec)).score_uncached(genome)
            msg = {"type": protocol.RESULT, "id": task_id, "ok": True,
                   "value": sv}
            if traced:
                t2 = time.perf_counter()
                msg["spans"] = (
                    {"span": "deserialize", "dur_s": round(t1 - t0, 6)},
                    {"span": "score", "dur_s": round(t2 - t1, 6),
                     "rung": getattr(spec, "fidelity", None)})
        except Exception as e:
            msg = {"type": protocol.RESULT, "id": task_id, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        try:
            self._send(msg)
        except OSError:
            self._stop.set()

    def _evaluate_frame_batch(self, entries: Sequence,
                              traced_ids: frozenset = frozenset()) -> None:
        """A whole coalesced ``tasks`` frame as one columnar evaluation:
        decode every payload (a per-entry shm failure degrades that entry
        only), group the survivors by spec id, score each group with one
        :meth:`Scorer.score_batch` call — one vectorized rung-0 model pass,
        one structural correctness-memo pass — and stream RESULT frames in
        entry order.  A group whose batch raises falls back to per-entry
        scalar scoring so failure attribution stays per task, with error
        strings identical to the singleton path."""
        decoded: list = []               # (task_id, sid, genome)
        for task_id, payload in entries:
            if payload[0] == "shm":
                _, seg_name, off, ln, sid = payload
                try:
                    genome = self._shm_genome(seg_name, off, ln)
                except Exception:
                    try:
                        self._send({"type": protocol.RESULT, "id": task_id,
                                    "shm_failure": True})
                    except OSError:
                        self._stop.set()
                        return
                    continue
            else:
                _, edits, sid = payload
                genome = KernelGenome.from_edits(edits)
            decoded.append((task_id, sid, genome))
        groups: dict[int, list[int]] = {}
        for idx, (_tid, sid, _g) in enumerate(decoded):
            groups.setdefault(sid, []).append(idx)
        results: dict[int, dict] = {}
        for sid, idxs in groups.items():
            spec = self._specs.get(sid)
            if spec is None:
                err = ("RuntimeError: task references unannounced "
                       f"spec id {sid}")
                for i in idxs:
                    results[i] = {"type": protocol.RESULT,
                                  "id": decoded[i][0], "ok": False,
                                  "error": err}
                continue
            try:
                scorer = _scorer_for(self._bind(spec))
            except Exception as e:
                for i in idxs:
                    results[i] = {"type": protocol.RESULT,
                                  "id": decoded[i][0], "ok": False,
                                  "error": f"{type(e).__name__}: {e}"}
                continue
            try:
                t0 = time.perf_counter()
                svs = scorer.score_batch([decoded[i][2] for i in idxs])
                dur = round(time.perf_counter() - t0, 6)
                # traced tasks in a columnar group share the batch span
                # (dur_s is the whole group's pass; n says so)
                span = ({"span": "score", "dur_s": dur, "n": len(idxs),
                         "rung": getattr(spec, "fidelity", None)},)
                for i, sv in zip(idxs, svs):
                    results[i] = {"type": protocol.RESULT,
                                  "id": decoded[i][0], "ok": True,
                                  "value": sv}
                    if decoded[i][0] in traced_ids:
                        results[i]["spans"] = span
            except Exception:            # pragma: no cover - defensive
                for i in idxs:
                    try:
                        sv = scorer.score_uncached(decoded[i][2])
                        results[i] = {"type": protocol.RESULT,
                                      "id": decoded[i][0], "ok": True,
                                      "value": sv}
                    except Exception as e:
                        results[i] = {"type": protocol.RESULT,
                                      "id": decoded[i][0], "ok": False,
                                      "error": f"{type(e).__name__}: {e}"}
        for i in range(len(decoded)):
            try:
                self._send(results[i])
            except OSError:
                self._stop.set()
                return

    def _heartbeat_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self._send({"type": protocol.HEARTBEAT})
            except OSError:
                self._stop.set()
                return

    # -- the serving loop ----------------------------------------------------------
    def run(self) -> None:
        """Blocks until the coordinator says shutdown, the connection drops,
        or :meth:`stop` is called."""
        self._sock = socket.create_connection((self.host, self.port))
        # heartbeats must keep flowing while big result frames stream
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.slots, thread_name_prefix="eval-worker")
        try:
            try:
                self._send({"type": protocol.HELLO, "name": self.name,
                            "slots": self.slots,
                            # capabilities: batched compact frames, the
                            # same-host shm fast path (the coordinator only
                            # uses it when our hostname matches its own), and
                            # per-task trace maps + result-frame spans
                            "host": socket.gethostname(),
                            "compact": True, "shm": True, "trace": True,
                            "package": protocol.PACKAGE})
                welcome = protocol.recv_msg(self._sock)
            except (ConnectionError, OSError):
                return    # coordinator gone mid-handshake: a normal exit
            if welcome.get("type") == protocol.REFUSED:
                raise ConnectionError(f"coordinator refused this worker: "
                                      f"{welcome.get('error')}")
            if welcome.get("type") != protocol.WELCOME:
                raise ConnectionError(f"expected welcome, got {welcome!r}")
            self._warm(pool, welcome.get("specs", ()))
            hb = threading.Thread(
                target=self._heartbeat_loop,
                args=(float(welcome.get("heartbeat_s", 2.0)),),
                name="eval-worker-heartbeat", daemon=True)
            hb.start()
            while not self._stop.is_set():
                try:
                    msg = protocol.recv_msg(self._sock)
                except Exception:      # dead coordinator or corrupt frame
                    break
                kind = msg.get("type")
                if kind == protocol.TASKS:
                    # spec pairs ride in-frame until the coordinator knows we
                    # have them; registration is synchronous (before any of
                    # the batch evaluates) and idempotent
                    self._warm(pool, msg.get("specs", ()))
                    tasks = tuple(msg.get("tasks", ()))
                    # {task id: (trace, attempt)} — present only when the
                    # coordinator traces (and only for trace-capable workers)
                    traced = frozenset(msg.get("trace") or ())
                    if batch_scoring_enabled() and len(tasks) > 1:
                        # columnar: the whole frame is one vectorized pass
                        pool.submit(self._evaluate_frame_batch, tasks, traced)
                    else:
                        for task_id, payload in tasks:
                            pool.submit(self._evaluate_entry, task_id, payload,
                                        task_id in traced)
                elif kind == protocol.TASK:
                    pool.submit(self._evaluate, msg["id"], msg["spec"],
                                msg["genome"],
                                msg["id"] in (msg.get("trace") or ()))
                elif kind == protocol.WARM:
                    self._warm(pool, msg.get("specs", ()))
                elif kind == protocol.STATS:
                    self._send({"type": protocol.STATS,
                                "value": worker_stats()})
                elif kind == protocol.SHUTDOWN:
                    break
        finally:
            self._stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            with self._seg_lock:
                for seg in self._segments.values():
                    try:
                        seg.close()    # detach only; the coordinator unlinks
                    except OSError:
                        pass
                self._segments.clear()
            try:
                self._sock.close()
            except OSError:
                pass

    def stop(self) -> None:
        """Unblock :meth:`run` from another thread (programmatic use)."""
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="evaluation-service worker (see repro_torch.core.evals.service)")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="coordinator address to register with")
    ap.add_argument("--slots", type=int, default=1,
                    help="concurrent evaluations this worker accepts")
    ap.add_argument("--name", default=None,
                    help="registry display name (default: worker<N>)")
    ap.add_argument("--device", default=None,
                    help="where to score (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    host, port = protocol.parse_address(args.connect)
    EvalServiceWorker(host, port, slots=args.slots, name=args.name,
                      device=args.device).run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
