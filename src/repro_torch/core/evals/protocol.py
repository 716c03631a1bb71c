"""Length-prefixed wire protocol for the cross-host evaluation service.

One frame = a 4-byte big-endian payload length followed by a pickled message
dict.  Messages carry :class:`~repro_torch.core.evals.worker.EvalSpec` +
:class:`~repro_torch.core.search_space.KernelGenome` payloads coordinator->worker
and :class:`~repro_torch.core.evals.vector.ScoreVector` results worker->coordinator
— all three are plain picklable dataclasses the process backend already
ships across process boundaries, so the socket transport reuses the exact
same serialization and inherits its bit-identity guarantee.  The evaluation
*fidelity* rung travels as part of the spec's value (``EvalSpec.fidelity``):
two rungs of one suite are two different interned specs on the wire, so
worker scorer tables and task frames are keyed per ``(genome, spec,
fidelity)`` with no frame-format change — and the shm genome arena stays
safely shared across rungs, since it stores only the genome payload.

Frame types (the ``"type"`` key of every message):

  hello      worker -> coordinator  registration: name, slots (capacity),
                                    host (enables the same-host shm path),
                                    trace (understands eval-lifecycle trace
                                    maps; see below), package (the package
                                    whose specs it scores: ``PACKAGE``)
  refused    coordinator -> worker  {error}: a HELLO from a worker of another
                                    package (a ``repro`` worker cannot
                                    unpickle this package's specs); the
                                    connection closes after it
  welcome    coordinator -> worker  assigned worker id, heartbeat interval,
                                    and the specs to pre-warm scorers for
  warm       coordinator -> worker  additional specs registered later
  task       coordinator -> worker  {id, spec, genome}: evaluate and reply
                                    (legacy single-task frame, kept for old
                                    workers; the coordinator now batches)
  tasks      coordinator -> worker  {tasks: [(id, payload), ...],
                                    specs: [(sid, spec), ...],
                                    shm: [segment names]}: a batch of
                                    compact assignments — payload is
                                    ("ed", edits, sid) for a seed-relative
                                    genome frame or ("shm", seg, off, len,
                                    sid) for a same-host shared-memory ref;
                                    specs/shm repeat un-acked announcements
                                    (idempotent worker-side)
  result     worker -> coordinator  {id, ok, value | error}; may carry
                                    ``spans`` (below)
  shm_ok     worker -> coordinator  worker attached the shm segments named
                                    in a tasks frame (same-host fast path
                                    confirmed usable)
  heartbeat  worker -> coordinator  liveness beacon (any frame counts too)
  stats      coordinator -> worker  request: the worker's own record
             worker -> coordinator  {value}: its pid, card-lock spans and
                                    waits, kernel launch counts and peak
                                    device memory (``worker.worker_stats``)
  shutdown   coordinator -> worker  drain and exit

Search-frontier frames (clients, not workers — a HELLO whose ``role`` is
``"client"`` routes the connection to the frontier's client session handler;
legacy workers never send ``role``, so older worker binaries are untouched):

  job         client -> frontier    {job: {...}}: submit a search job; the
                                    frontier replies with a stream of
                                    job_event frames (first: "accepted",
                                    carrying the assigned job id)
  job_cancel  client -> frontier    {job: job_id}: stop a running job at its
                                    next chunk boundary
  job_event   frontier -> client    {job, kind, t, data}: lineage commits,
                                    budget spend, completion, ... — the
                                    streamed lifecycle of a submitted job

Eval-lifecycle tracing (``repro_torch.core.obs``) rides the same capability
negotiation as compact/shm: a worker that sends ``trace: True`` in HELLO may
receive an optional ``trace`` field on task/tasks frames — a ``{task id:
(trace id, attempt)}`` map naming which assignments belong to a traced
evaluation — and piggybacks ``spans`` (a tuple of ``{span, dur_s, ...}``
dicts timing deserialize/score on that host) on the corresponding RESULT
frames, which the coordinator stitches onto the submitter's trace.  A worker
that never advertises ``trace`` (any pre-trace binary) receives frames
byte-identical to the old wire and replies exactly as before — tracing is
negotiated, never assumed, and carries no scoring payload, so it cannot
perturb results.

Transport security: frames are pickles, so the listener must only ever be
reachable by trusted workers (loopback, or a private cluster network) — the
same trust model as multiprocessing's own pickle-over-pipe transport.
"""
from __future__ import annotations

import asyncio
import pickle
import socket
import struct
import threading

# 4-byte length prefix; a frame is at most ~4 GiB, far beyond any genome batch
_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 31

# the package a worker must speak for: the HELLO names it, the coordinator
# refuses any other
PACKAGE = "repro_torch"

HELLO = "hello"
WELCOME = "welcome"
REFUSED = "refused"
WARM = "warm"
TASK = "task"
TASKS = "tasks"
RESULT = "result"
SHM_OK = "shm_ok"
HEARTBEAT = "heartbeat"
STATS = "stats"
SHUTDOWN = "shutdown"
JOB = "job"
JOB_CANCEL = "job_cancel"
JOB_EVENT = "job_event"


def frame_size(msg: dict) -> int:
    """On-wire size of a message (length prefix included) — what the
    coordinator's wire-bytes accounting and the bench's bytes-per-task
    metric measure."""
    return _LEN.size + len(pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))


def encode_frame(msg: dict) -> bytes:
    """Frame one message into its exact wire bytes (length prefix included).
    The async coordinator encodes at enqueue time — wire accounting reads
    ``len(encode_frame(msg))``, which equals :func:`frame_size`."""
    payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) >= MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)} bytes")
    return _LEN.pack(len(payload)) + payload


def send_msg(sock: socket.socket, msg: dict,
             lock: "threading.Lock | None" = None) -> int:
    """Frame and send one message; ``lock`` serializes concurrent senders
    (heartbeat thread vs result thread) so frames never interleave.
    Returns the number of bytes put on the wire (prefix included)."""
    data = encode_frame(msg)
    if lock is None:
        sock.sendall(data)
    else:
        with lock:
            sock.sendall(data)
    return len(data)


def recv_msg(sock: socket.socket) -> dict:
    """Read exactly one frame; raises ``ConnectionError`` on EOF/short read
    (how a dead peer is detected synchronously)."""
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    if n >= MAX_FRAME:
        raise ConnectionError(f"oversized frame announced: {n} bytes")
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the connection")
        buf.extend(chunk)
    return bytes(buf)


async def async_recv_msg(reader: asyncio.StreamReader) -> dict:
    """Async twin of :func:`recv_msg` for the coordinator's event loop.
    EOF/short reads surface as ``ConnectionError`` (same dead-peer contract
    as the blocking helper); a corrupt payload raises whatever ``pickle``
    raises, which the reader treats as a protocol error."""
    try:
        header = await reader.readexactly(_LEN.size)
    except asyncio.IncompleteReadError as e:
        raise ConnectionError("peer closed the connection") from e
    (n,) = _LEN.unpack(header)
    if n >= MAX_FRAME:
        raise ConnectionError(f"oversized frame announced: {n} bytes")
    try:
        payload = await reader.readexactly(n)
    except asyncio.IncompleteReadError as e:
        raise ConnectionError("peer closed the connection") from e
    return pickle.loads(payload)


async def async_send_msg(writer: asyncio.StreamWriter, msg: dict) -> int:
    """Frame and send one message on a stream writer, draining the transport
    buffer — the await IS the backpressure: a slow peer stalls only its own
    sender coroutine, never the event loop."""
    data = encode_frame(msg)
    writer.write(data)
    await writer.drain()
    return len(data)


def parse_address(address: str) -> tuple[str, int]:
    """``HOST:PORT`` -> (host, port); the worker CLI's --connect format.
    IPv6 literals use the standard bracket form — ``[::1]:9000`` -> ``::1``
    (the brackets are wire syntax only; ``socket`` wants them stripped)."""
    host, sep, port = address.rpartition(":")
    if not sep or not host:
        raise ValueError(f"address must be HOST:PORT, got {address!r}")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    elif ":" in host:
        raise ValueError(
            f"IPv6 address must be bracketed, like [::1]:9000; got {address!r}")
    return host, int(port)
