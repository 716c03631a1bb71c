"""The port's cross-host evaluation service, as ``tests/test_service.py``
holds the JAX package's: wire protocol, worker registry + heartbeats,
ServiceBackend bit-identity with inline, dead-worker requeue onto survivors;
and the port's own: the HELLO's package, the workers' stats replies and the
worker's device.  Workers score on the CPU (``device="cpu"``)."""
import socket
import threading
import time

import pytest

from repro_torch.core.evals import (EvalCoordinator, EvalSpec, Scorer,
                                    ServiceBackend, make_backend)
from repro_torch.core.evals import protocol
from repro_torch.core.evals.service_worker import EvalServiceWorker
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.core.search_space import seed_genome

FAST_SUITE = [BenchConfig("c4k", 8, 16, 16, 4096, causal=True),
              BenchConfig("n4k", 8, 16, 16, 4096, causal=False)]
HELLO = {"type": protocol.HELLO, "slots": 1, "package": protocol.PACKAGE}


def _inproc_worker(address, slots=1, name="inproc", device="cpu"):
    """Worker on a thread inside the test process: registration, dispatch,
    and identity paths without process spin-up cost.  (Fault tests use real
    killed subprocesses — a thread cannot be SIGKILLed.)"""
    w = EvalServiceWorker(*address, slots=slots, name=name, device=device)
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    return w, t


# -- the wire protocol ---------------------------------------------------------


def test_protocol_roundtrip_and_eof():
    a, b = socket.socketpair()
    try:
        g = seed_genome()
        spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
        protocol.send_msg(a, {"type": protocol.TASK, "id": 7, "spec": spec,
                              "genome": g})
        msg = protocol.recv_msg(b)
        assert msg["id"] == 7 and msg["spec"] == spec
        assert msg["genome"].key() == g.key()
        a.close()
        with pytest.raises(ConnectionError):
            protocol.recv_msg(b)
    finally:
        b.close()


def test_parse_address():
    assert protocol.parse_address("10.0.0.3:5123") == ("10.0.0.3", 5123)
    with pytest.raises(ValueError, match="HOST:PORT"):
        protocol.parse_address("5123")


# -- registry + dispatch --------------------------------------------------------


def test_worker_registers_and_join_event_observable():
    coord = EvalCoordinator()
    try:
        assert not coord.wait_for_workers(1, timeout=0.05)
        w, t = _inproc_worker(coord.address, slots=2, name="alpha")
        assert coord.wait_for_workers(1, timeout=10)
        st = coord.stats()
        assert st["workers"] == 1 and st["total_slots"] == 2
        assert st["events"][0] == {"event": "join", "worker": "alpha",
                                   "slots": 2, "workers": 1}
        w.stop()
        t.join(5)
    finally:
        coord.close()


@pytest.mark.parametrize("batch", [False, True])
def test_service_backend_matches_inline(batch):
    """A fixed genome batch scored over the socket transport against the
    inline path — correctness verdicts, per-config TFLOPS and profile
    breakdowns.  With batch scoring off both run scalar rung 0 and agree
    bit for bit; with it on the worker scores each frame columnar, which
    folds its sums in another order: relative 1e-12."""
    from repro_torch.core.evals import set_batch_scoring
    suite = [BenchConfig("c2k", 1, 4, 4, 2048, causal=True)]
    genomes = [seed_genome(),
               seed_genome().with_(block_q=512, kv_in_grid=True),
               seed_genome().with_(mask_mode="block_skip",
                                   rescale_mode="branchless"),
               seed_genome().with_(acc_dtype="bf16")]   # fails correctness
    set_batch_scoring(batch)
    svc = ServiceBackend(suite=suite, workers=0, device="cpu")
    w, t = _inproc_worker(svc.address, slots=2)
    try:
        assert svc.coordinator.wait_for_workers(1, timeout=10)
        got = svc.map(genomes)
    finally:
        set_batch_scoring(True)
        svc.close()
        w.stop()
        t.join(5)
    want = make_backend("inline", suite=suite, device="cpu").map(genomes)
    close = (lambda x: x) if not batch else \
        (lambda x: pytest.approx(x, rel=1e-12, abs=0))
    for a, b in zip(got, want):
        assert a.correct == b.correct
        assert a.values == close(b.values)
        assert a.config_names == b.config_names
        assert a.failure == b.failure
        assert a.profiles.keys() == b.profiles.keys()
        for n in a.profiles:
            pa, pb = a.profiles[n].breakdown(), b.profiles[n].breakdown()
            assert pa.keys() == pb.keys()
            for k in pa:
                assert pa[k] == (close(pb[k]) if isinstance(pb[k], float)
                                 else pb[k])
    assert not want[-1].correct                  # the bf16 trap really fired


def test_service_backend_dedup_and_parent_cache():
    svc = ServiceBackend(suite=FAST_SUITE, check_correctness=False, workers=0,
                         device="cpu")
    w, t = _inproc_worker(svc.address, slots=2)
    try:
        assert svc.coordinator.wait_for_workers(1, timeout=10)
        g1, g2 = seed_genome(), seed_genome().with_(block_q=256)
        svs = svc.map([g1, g2, g1, g2, g1])      # duplicates share one task
        assert svc.n_evaluations == 2
        assert [sv.values for sv in svs[:2]] == [svs[2].values, svs[3].values]
        before = svc.n_evaluations
        again = svc.map([g1, g2])                # parent cache: no new tasks
        assert svc.n_evaluations == before
        assert svc.cache_hits >= 2
        assert [a.values for a in again] == [svs[0].values, svs[1].values]
        assert svc.in_flight == ()
    finally:
        svc.close()
        w.stop()
        t.join(5)


def test_remote_evaluation_failure_propagates_and_is_not_cached():
    """A deterministic evaluation failure must propagate (never requeue —
    retrying a poisoned genome elsewhere would loop forever) and must not
    poison the cache for a later valid spec."""
    coord = EvalCoordinator()
    w, t = _inproc_worker(coord.address)
    try:
        assert coord.wait_for_workers(1, timeout=10)
        bad_spec = EvalSpec(suite=("not-a-config",), check_correctness=False,
                            device="cpu")
        bad = ServiceBackend(spec=bad_spec, coordinator=coord)
        fut = bad.submit(seed_genome())
        with pytest.raises(RuntimeError, match="remote evaluation failed"):
            fut.result(20)
        assert bad.in_flight == ()               # evicted, retry possible
        good = ServiceBackend(suite=FAST_SUITE, check_correctness=False,
                              coordinator=coord, device="cpu")
        assert good(seed_genome()).values        # fleet still healthy
        bad.close(); good.close()
    finally:
        coord.close()
        w.stop()
        t.join(5)


def test_shared_coordinator_serves_multiple_suites():
    """One worker fleet, many suites: each task carries its spec, so the
    island engine's per-suite backends share a single coordinator."""
    coord = EvalCoordinator()
    w, t = _inproc_worker(coord.address, slots=2)
    try:
        assert coord.wait_for_workers(1, timeout=10)
        a = ServiceBackend(suite=FAST_SUITE, check_correctness=False,
                           coordinator=coord, device="cpu")
        b = ServiceBackend(suite="decode", check_correctness=False,
                           coordinator=coord, device="cpu")
        g = seed_genome()
        sva, svb = a(g), b(g)
        assert sva.config_names != svb.config_names
        assert sva.values == Scorer(suite=FAST_SUITE,
                                    check_correctness=False, device="cpu")(g).values
        a.close()
        b.close()                                # coordinator stays shared
        assert coord.n_workers == 1
        with pytest.raises(ValueError, match="owned-coordinator only"):
            ServiceBackend(suite=FAST_SUITE, coordinator=coord, workers=2)
    finally:
        coord.close()
        w.stop()
        t.join(5)


def test_coordinator_close_cancels_pending_and_rejects_submit():
    coord = EvalCoordinator()
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    fut = coord.submit(spec, seed_genome())      # no workers: stays queued
    coord.close()
    assert fut.cancelled()
    coord.close()                                # idempotent
    with pytest.raises(RuntimeError, match="closed EvalCoordinator"):
        coord.submit(spec, seed_genome())


def test_garbage_frames_do_not_kill_the_coordinator():
    """A listener bound for remote workers will meet stray clients: garbage
    bytes at the handshake must be rejected quietly, and a corrupt frame
    from a REGISTERED worker must take the synchronous death path (eviction
    with a leave event), never leave a zombie registration behind."""
    import struct
    coord = EvalCoordinator()
    try:
        stray = socket.create_connection(coord.address)
        stray.sendall(b"GET / HTTP/1.1\r\n\r\n")   # not a frame at all
        stray.close()
        corrupt = socket.create_connection(coord.address)
        protocol.send_msg(corrupt, {**HELLO, "name": "bad"})
        assert coord.wait_for_workers(1, timeout=10)
        corrupt.sendall(struct.pack(">I", 4) + b"junk")  # unpicklable frame
        deadline = time.monotonic() + 10
        while coord.n_workers and time.monotonic() < deadline:
            time.sleep(0.05)
        assert coord.n_workers == 0
        assert any(e["event"] == "leave" and "protocol error" in e["why"]
                   for e in coord.stats()["events"])
        corrupt.close()
        w, t = _inproc_worker(coord.address)      # fleet still serviceable
        assert coord.wait_for_workers(1, timeout=10)
        w.stop()
        t.join(5)
    finally:
        coord.close()


# -- fault tolerance ------------------------------------------------------------


def test_missed_heartbeats_evict_worker_and_requeue_onto_survivor():
    """The asynchronous death path: a registered worker that goes silent
    (hang/partition — the socket stays open) is evicted after dead_after_s
    and its in-flight task completes on a later-joining live worker."""
    coord = EvalCoordinator(heartbeat_s=0.1, dead_after_s=0.4)
    zombie = socket.create_connection(coord.address)
    try:
        protocol.send_msg(zombie, {**HELLO, "name": "zombie"})
        assert coord.wait_for_workers(1, timeout=10)
        spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
        fut = coord.submit(spec, seed_genome())  # dispatched to the zombie
        deadline = time.monotonic() + 10
        while coord.n_workers and time.monotonic() < deadline:
            time.sleep(0.05)
        assert coord.n_workers == 0              # evicted, not still trusted
        events = coord.stats()["events"]
        assert any(e["event"] == "leave" and "heartbeat" in e["why"]
                   for e in events)
        assert any(e["event"] == "requeue" for e in events)
        w, t = _inproc_worker(coord.address, name="live")
        assert fut.result(30).values             # survivor finished the task
        w.stop()
        t.join(5)
    finally:
        zombie.close()
        coord.close()


def test_worker_kill_mid_batch_requeues_onto_survivor():
    """The synchronous death path, with real processes: SIGKILL one of two
    workers while both are mid-evaluation; every future must still complete,
    bit-identical to inline, and the registry must record leave+requeue."""
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False,
                            service_latency_s=0.5, device="cpu")
    svc = ServiceBackend(spec=spec, workers=2)
    try:
        genomes = [seed_genome().with_(block_q=bq, block_k=bk)
                   for bq in (64, 128, 256, 512) for bk in (64, 128)]
        futs = [svc.submit(g) for g in genomes]
        time.sleep(0.6)                          # both workers mid-evaluation
        svc._procs[0].kill()
        got = [f.result(60) for f in futs]
        inline = Scorer(suite=FAST_SUITE, check_correctness=False, device="cpu")
        assert [sv.values for sv in got] == [inline(g).values for g in genomes]
        st = svc.coordinator.stats()
        assert st["tasks_requeued"] >= 1
        assert any(e["event"] == "leave" for e in st["events"])
        assert any(e["event"] == "requeue" for e in st["events"])
        assert st["workers"] == 1                # the survivor
    finally:
        svc.close()


# -- the port's own: package, stats, device ---------------------------------------


def test_worker_of_another_package_is_refused():
    """A HELLO that names no package (a ``repro`` worker) or another one is
    answered with a REFUSED frame that says why, and never registers."""
    coord = EvalCoordinator()
    try:
        for hello in ({"type": protocol.HELLO, "name": "ref", "slots": 1},
                      {**HELLO, "name": "other", "package": "repro"}):
            sock = socket.create_connection(coord.address)
            try:
                protocol.send_msg(sock, hello)
                msg = protocol.recv_msg(sock)
                assert msg["type"] == protocol.REFUSED
                assert protocol.PACKAGE in msg["error"]
                with pytest.raises(ConnectionError):
                    protocol.recv_msg(sock)          # and the door closes
            finally:
                sock.close()
        assert coord.n_workers == 0
        refused = [e for e in coord.stats()["events"] if e["event"] == "refused"]
        assert [e["worker"] for e in refused] == ["ref", "other"]
        w, t = _inproc_worker(coord.address)      # a port worker registers
        assert coord.wait_for_workers(1, timeout=10)
        w.stop()
        t.join(5)
    finally:
        coord.close()


def test_worker_stats_reply():
    """Every live worker answers a stats request with its own record: pid,
    card-lock record (empty on the CPU), kernel launch counts, peak device
    memory (None before CUDA is initialised)."""
    import os
    svc = ServiceBackend(suite=FAST_SUITE, workers=0, device="cpu")
    workers = [_inproc_worker(svc.address, name=n) for n in ("a", "b")]
    try:
        assert svc.coordinator.wait_for_workers(2, timeout=10)
        svc.map([seed_genome(), seed_genome().with_(block_q=256)])
        stats = svc.coordinator.worker_stats(timeout=10)
        assert set(stats) == {"a", "b"}
        for st in stats.values():
            assert st["pid"] == os.getpid()
            assert st["card_locks"] == {} and st["peak_memory_bytes"] is None
            assert set(st["launches_by_body"]) == {"wgmma", "mma_sync", "fp32"}
            assert st["launches"] == 0             # the plain path on the CPU
    finally:
        svc.close()
        for w, t in workers:
            w.stop()
            t.join(5)


def test_worker_refuses_a_task_for_another_device():
    """A CPU worker handed a spec for the card fails the task with a clear
    error; it never scores it on the CPU."""
    coord = EvalCoordinator()
    w, t = _inproc_worker(coord.address)
    try:
        assert coord.wait_for_workers(1, timeout=10)
        card = ServiceBackend(suite=FAST_SUITE, check_correctness=False,
                              coordinator=coord)
        with pytest.raises(RuntimeError, match="scores on cpu"):
            card.submit(seed_genome()).result(20)
        assert len(card.cache) == 0
        card.close()
    finally:
        coord.close()
        w.stop()
        t.join(5)
