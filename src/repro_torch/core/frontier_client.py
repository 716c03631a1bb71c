"""Client for the search frontier: submit / stream / cancel search jobs.

Speaks the same length-prefixed frame protocol as the evaluation workers —
one blocking TCP connection, registered with a ``role: "client"`` HELLO so
the coordinator routes it to the frontier's session handler instead of the
worker registry.  One connection can carry any number of concurrent jobs:
every inbound JOB_EVENT frame names its job, and the client buffers events
per job so interleaved streams never lose frames.

    client = FrontierClient(frontier.address)
    job_id = client.submit(SearchJob(suite="decode", budget=200, priority=2))
    for event in client.stream(job_id):          # accepted -> ... -> done
        print(event.kind, event.data)
    client.cancel(job_id)                        # stops at next chunk boundary

Thread model: the client is deliberately synchronous (one reader — calls
that consume frames take an internal lock).  Use one client per thread, or
one shared client from a single dispatcher thread.
"""
from __future__ import annotations

import itertools
import socket
import threading
from collections import deque
from typing import Iterator, Optional, Union

from repro_torch.core import obs
from repro_torch.core.evals import protocol
from repro_torch.core.frontier import JobEvent, SearchJob

__all__ = ["FrontierClient"]

_TERMINAL = ("done", "cancelled", "failed")


class FrontierClient:
    """One connection to a :class:`~repro_torch.core.frontier.SearchFrontier`."""

    def __init__(self, address: Union[str, tuple], *,
                 name: str = "client", timeout: Optional[float] = None):
        if isinstance(address, str):
            address = protocol.parse_address(address)
        self._sock = socket.create_connection(tuple(address), timeout)
        self._lock = threading.Lock()
        self._next_ref = itertools.count(1)
        self._events: dict[str, deque] = {}    # job id -> undelivered events
        self._accepted: deque = deque()        # accepted frames awaiting a ref
        protocol.send_msg(self._sock, {"type": protocol.HELLO,
                                       "role": "client", "name": name})
        welcome = protocol.recv_msg(self._sock)
        if welcome.get("type") != protocol.WELCOME:
            raise ConnectionError(
                f"frontier handshake failed: {welcome.get('type')!r}")
        self.client_id = welcome.get("client_id")

    # -- frame plumbing ------------------------------------------------------------
    def _read_event(self) -> JobEvent:
        """Read one JOB_EVENT frame (skipping anything else)."""
        while True:
            msg = protocol.recv_msg(self._sock)
            if msg.get("type") == protocol.JOB_EVENT:
                return JobEvent(msg.get("job", ""), msg.get("kind", ""),
                                msg.get("t", 0.0), msg.get("data") or {})

    def _route(self, ev: JobEvent) -> None:
        if obs.enabled():
            # mirror the received stream into this process's journal: a
            # client-side record of the remote job, tagged like the server's
            obs.publish("job_event_recv", tenant=ev.job, kind=ev.kind,
                        t_job=round(ev.t, 6))
        if ev.kind in ("accepted", "failed") and ev.data.get("ref"):
            self._accepted.append(ev)
        else:
            self._events.setdefault(ev.job, deque()).append(ev)

    # -- the job surface -----------------------------------------------------------
    def submit(self, job: SearchJob) -> str:
        """Submit one job; blocks until the frontier acknowledges it and
        returns the assigned job id.  Raises RuntimeError if the frontier
        rejects the job payload."""
        ref = next(self._next_ref)
        with self._lock:
            protocol.send_msg(self._sock, {"type": protocol.JOB,
                                           "job": job.to_wire(), "ref": ref})
            while True:
                for i, ev in enumerate(self._accepted):
                    if ev.data.get("ref") == ref:
                        del self._accepted[i]
                        if ev.kind == "failed":
                            raise RuntimeError(ev.data.get("error",
                                                           "job rejected"))
                        # the accepted event leads the job's stream too
                        self._events.setdefault(ev.job,
                                                deque()).appendleft(ev)
                        return ev.job
                self._route(self._read_event())

    def stream(self, job_id: str) -> Iterator[JobEvent]:
        """Yield the job's events in order — commits, progress, spend — until
        (and including) its terminal event (done / cancelled / failed)."""
        while True:
            with self._lock:
                q = self._events.setdefault(job_id, deque())
                while not q:
                    self._route(self._read_event())
                ev = q.popleft()
            yield ev
            if ev.kind in _TERMINAL:
                return

    def wait(self, job_id: str) -> JobEvent:
        """Drain the job's stream; returns the terminal event."""
        ev = None
        for ev in self.stream(job_id):
            pass
        return ev

    def cancel(self, job_id: str) -> None:
        """Ask the frontier to stop the job at its next chunk boundary (the
        job's stream then terminates with a ``cancelled`` event)."""
        with self._lock:
            protocol.send_msg(self._sock, {"type": protocol.JOB_CANCEL,
                                           "job": job_id})

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "FrontierClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
