"""The port's search frontier on the CPU: the counterparts of
``tests/test_frontier.py`` (job lifecycle, determinism against a direct
engine run, multi-tenant weighted-fair grants on one fleet, budget /
deadline / cancel, the wire client, the scheduler itself), plus: a
frontier job's lineage equals the same seed through the JAX package's
frontier, ``SearchJob`` carries ``device`` and ``machine`` over the wire,
and importing the frontier pulls in no JAX and nothing of the JAX package.

Workers are spawned with ``device="cpu"`` (the gate runs the kernel's plain
version), 2 at most.  Rung 0 runs on the reference's TPU v5e model with
batch scoring off in both packages (scalar and columnar rung 0 differ by
an ulp on some hosts).  No assertion rests on wall-clock pacing: the
concurrent-tenants test checks grant accounting."""
import os
import pathlib
import socket
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

import repro.core as J
from repro.core.evals.scorer import set_batch_scoring as jax_set_batch_scoring
from repro.core.perfmodel import register_suite as jax_register_suite
from repro.core.perfmodel import unregister_suite as jax_unregister_suite
from repro_torch.core import (EngineConfig, EvalConfig, FrontierClient,
                              IslandEvolution, MigrationConfig, SearchFrontier,
                              SearchJob, lineage_fingerprint, seed_genome)
from repro_torch.core.evals import (EvalCoordinator, EvalSpec, backend_info,
                                    protocol, set_batch_scoring)
from repro_torch.core.perfmodel import (BenchConfig, register_suite,
                                        unregister_suite)
from repro_torch.core.search_space import KernelGenome

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
FAST = [("c4k", 8, 16, 16, 4096, True), ("n4k", 8, 16, 16, 4096, False)]
FAST_SUITE = [BenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST]
SPAWN_S = 300.0        # registration timeout of spawned workers (a loaded host)
WAIT_S = 600.0


@pytest.fixture(scope="module", autouse=True)
def _fast_suite_scalar_rung0():
    register_suite("frontier-fast", lambda: FAST_SUITE, overwrite=True)
    jax_register_suite("frontier-fast", lambda: [
        J.BenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST],
        overwrite=True)
    jax_set_batch_scoring(False)
    set_batch_scoring(False)
    yield
    jax_set_batch_scoring(True)
    set_batch_scoring(True)
    unregister_suite("frontier-fast")
    jax_unregister_suite("frontier-fast")


def _fast_job(**kw):
    base = dict(suite="frontier-fast", steps=4, migration_interval=2,
                check_correctness=False, n_islands=2, device="cpu")
    base.update(kw)
    return SearchJob(**base)


def _frontier(workers, **kw):
    return SearchFrontier(workers=workers, device="cpu",
                          worker_timeout_s=SPAWN_S, **kw)


def _terminal(frontier, job_id):
    events = frontier.job_events(job_id)
    assert events, "job emitted no events"
    return events[-1]


# -- determinism ------------------------------------------------------------------


def _direct(seed, check_correctness):
    eng = IslandEvolution(config=EngineConfig(
        n_islands=2, suite=FAST_SUITE, seed=seed,
        evals=EvalConfig(backend="service", service_workers=2,
                         check_correctness=check_correctness, device="cpu"),
        migration=MigrationConfig(interval=2)))
    try:
        eng.run(max_steps=4)
        return lineage_fingerprint(eng)
    finally:
        eng.close()


@pytest.mark.parametrize("check_correctness", [False, True])
def test_frontier_job_equals_direct_service_engine_and_jax_frontier(check_correctness):
    """The headline gate: the same seed through the port's frontier,
    through the port's IslandEvolution(backend='service') directly, and
    through the JAX package's frontier walks the same lineage; with the gate
    on, every genome is gated in a worker (the plain version here)."""
    frontier = _frontier(2)
    try:
        job_id = frontier.submit(_fast_job(seed=3, check_correctness=check_correctness))
        assert frontier.wait(job_id, timeout=WAIT_S) == "done"
        done = _terminal(frontier, job_id)
        assert done.kind == "done"
        via_frontier = done.data["fingerprint"]
    finally:
        frontier.close()
    assert via_frontier and len(via_frontier) == 2
    assert via_frontier == _direct(3, check_correctness)

    theirs = J.SearchFrontier(workers=2)
    try:
        jid = theirs.submit(J.SearchJob(suite="frontier-fast", steps=4,
                                        migration_interval=2, n_islands=2, seed=3,
                                        check_correctness=check_correctness))
        assert theirs.wait(jid, timeout=WAIT_S) == "done"
        assert via_frontier == theirs.job_events(jid)[-1].data["fingerprint"]
    finally:
        theirs.close()


def test_concurrent_unequal_priority_jobs_share_one_fleet():
    """Two jobs with 3:1 priority on a 2-slot fleet: both complete, and
    every grant is accounted for under the job's own tenant: each job's
    paid evaluations are its tenant's grants, all completed, and its
    weight is priority x remaining budget.  The scorer is a deterministic
    function of the genome, so identical jobs end bit-identical."""
    frontier = _frontier(1, worker_slots=2)
    try:
        hi = frontier.submit(_fast_job(seed=7, priority=3.0, budget=500))
        lo = frontier.submit(_fast_job(seed=7, priority=1.0, budget=500))
        assert frontier.wait(hi, timeout=WAIT_S) == "done"
        assert frontier.wait(lo, timeout=WAIT_S) == "done"
        assert _terminal(frontier, hi).data["fingerprint"] == \
            _terminal(frontier, lo).data["fingerprint"]
        st = frontier.stats()
        coord = st["coordinator"]
        tenants = coord["tenants"]
        for jid, prio in ((hi, 3.0), (lo, 1.0)):
            spent = st["jobs"][jid]["spent"]
            assert spent > 0
            assert tenants[jid]["granted"] == tenants[jid]["completed"] == spent
            assert tenants[jid]["weight"] == prio * max(1.0, 500 - spent)
        assert sum(t["granted"] for t in tenants.values()) == coord["tasks_completed"]
        assert sum(t["granted_contended"] for t in tenants.values()) == \
            coord["granted_contended"]
    finally:
        frontier.close()


# -- stopping: budget, deadline, cancel ---------------------------------------------


def test_budget_stops_job_at_chunk_boundary():
    frontier = _frontier(1)
    try:
        job_id = frontier.submit(_fast_job(steps=50, budget=1))
        assert frontier.wait(job_id, timeout=WAIT_S) == "done"
        done = _terminal(frontier, job_id)
        assert done.data["spent"] >= 1
        assert done.data["steps"] < 50      # stopped long before the cap
    finally:
        frontier.close()


def test_deadline_cancels_job():
    frontier = _frontier(1)
    try:
        job_id = frontier.submit(_fast_job(steps=50, deadline_s=0.0))
        assert frontier.wait(job_id, timeout=WAIT_S) == "cancelled"
        assert any(ev.data.get("deadline_exceeded")
                   for ev in frontier.job_events(job_id)
                   if ev.kind == "progress")
    finally:
        frontier.close()


def test_cancel_stops_running_job():
    frontier = _frontier(1)
    try:
        job_id = frontier.submit(_fast_job(steps=500, migration_interval=1))
        assert frontier.cancel(job_id)
        assert frontier.wait(job_id, timeout=WAIT_S) == "cancelled"
        assert not frontier.cancel("job-9999")     # unknown id
    finally:
        frontier.close()


def test_coordinator_incapable_backend_fails_the_job_only():
    """A job naming a registry backend that cannot score against a shared
    fleet fails cleanly — the service itself keeps running."""
    frontier = _frontier(0)
    try:
        job_id = frontier.submit(_fast_job(backend="thread"))
        assert frontier.wait(job_id, timeout=60) == "failed"
        assert "cannot score" in _terminal(frontier, job_id).data["error"]
        assert frontier.submit(_fast_job(backend="thread"))  # still serving
    finally:
        frontier.close()


def test_card_job_without_a_card_fails_the_job_only():
    """A job left on the card (``device=None``) on a host without one fails
    with the port's no-card error; nothing scores on the CPU instead."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    frontier = _frontier(0)
    try:
        job_id = frontier.submit(_fast_job(device=None))
        assert frontier.wait(job_id, timeout=60) == "failed"
        assert "no CUDA device" in _terminal(frontier, job_id).data["error"]
    finally:
        frontier.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchFrontier(workers=1)


def test_submit_after_close_raises():
    frontier = _frontier(0)
    frontier.close()
    with pytest.raises(RuntimeError, match="closed"):
        frontier.submit(_fast_job())
    frontier.close()                                  # idempotent


# -- the wire client ----------------------------------------------------------------


def test_client_submit_stream_cancel_over_the_wire():
    frontier = _frontier(1)
    try:
        with FrontierClient(frontier.address) as client:
            # a full stream, in lifecycle order
            job_id = client.submit(_fast_job(seed=1, steps=2))
            kinds = [ev.kind for ev in client.stream(job_id)]
            assert kinds[0] == "accepted" and kinds[1] == "started"
            assert "commit" in kinds and "progress" in kinds
            assert kinds[-1] == "done"
            done = frontier.job_events(job_id)[-1]
            assert done.data["spent"] > 0 and done.data["fingerprint"]

            # a job that dies in its runner streams a terminal 'failed'
            bad = client.submit(_fast_job(backend="thread"))
            ev = client.wait(bad)
            assert ev.kind == "failed" and "cannot score" in ev.data["error"]

            # cancellation round-trips the wire
            slow = client.submit(_fast_job(steps=500, migration_interval=1))
            client.cancel(slow)
            assert client.wait(slow).kind == "cancelled"
    finally:
        frontier.close()


def test_client_hello_refused_when_nobody_serves_jobs():
    """A bare coordinator (no frontier installed) closes client sessions at
    the door instead of letting jobs queue into a void."""
    coord = EvalCoordinator()
    sock = socket.create_connection(coord.address)
    try:
        protocol.send_msg(sock, {"type": protocol.HELLO, "role": "client",
                                 "name": "lost"})
        with pytest.raises(ConnectionError):
            protocol.recv_msg(sock)
    finally:
        sock.close()
        coord.close()


def test_search_job_wire_round_trip_carries_device_and_machine():
    job = _fast_job(seed=5, priority=2.0, budget=9, machine="h100")
    wire = job.to_wire()
    assert wire["device"] == "cpu" and wire["machine"] == "h100"
    assert SearchJob.from_wire(wire) == job
    card = SearchJob(machine="h100")
    assert SearchJob.from_wire(card.to_wire()) == card and card.device is None
    # a reference client's job (no device, no machine): the card, tpu_v5e
    ref = J.SearchJob(suite="frontier-fast", seed=5).to_wire()
    got = SearchJob.from_wire(ref)
    assert got.device is None and got.machine is None and got.seed == 5
    assert SearchJob.from_wire(dict(wire, unknown=1)) == job


# -- the scheduler itself -----------------------------------------------------------


def test_weighted_fair_grants_follow_granted_over_weight():
    """Drive the coordinator's scheduler directly with a raw fake worker:
    tenants A (weight 3) and B (weight 1) each queue 8 tasks onto one 1-slot
    worker, so every grant is observable as its own tasks frame.  The grant
    sequence must follow argmin(granted/weight) exactly, and the contended-
    grant counters must record the 3:1 apportionment."""
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    ga = seed_genome().with_(block_q=64)
    gb = seed_genome().with_(block_q=256)
    coord = EvalCoordinator()
    sock = None
    try:
        coord.set_tenant_weight("A", 3.0)
        coord.set_tenant_weight("B", 1.0)
        futs = coord.submit_many(spec, [ga] * 8, tenant="A")
        futs += coord.submit_many(spec, [gb] * 8, tenant="B")

        sock = socket.create_connection(coord.address)
        protocol.send_msg(sock, {"type": protocol.HELLO, "name": "fake",
                                 "slots": 1, "compact": True,
                                 "host": "elsewhere", "package": protocol.PACKAGE})
        assert protocol.recv_msg(sock)["type"] == protocol.WELCOME

        order = []
        for _ in range(16):
            msg = protocol.recv_msg(sock)
            while msg["type"] != protocol.TASKS:   # skip warm announcements
                msg = protocol.recv_msg(sock)
            assert len(msg["tasks"]) == 1          # one slot: one grant each
            tid, payload = msg["tasks"][0]
            genome = KernelGenome.from_edits(payload[1])
            order.append("A" if genome == ga else "B")
            protocol.send_msg(sock, {"type": protocol.RESULT, "id": tid,
                                     "ok": True, "value": genome.key()})
        assert [f.result(10) for f in futs]

        # argmin(granted/weight), tenant id breaking ties: A pulls 3 grants
        # per B grant while both queues are non-empty, then B drains alone
        assert order == ["A", "B", "A", "A", "A", "B", "A", "A",
                         "A", "B", "A", "B", "B", "B", "B", "B"]
        tenants = coord.stats()["tenants"]
        assert tenants["A"]["granted"] == 8
        assert tenants["A"]["granted_contended"] == 8
        assert tenants["B"]["granted"] == 8
        assert tenants["B"]["granted_contended"] == 3
        assert coord.stats()["granted_contended"] == 11
    finally:
        if sock is not None:
            sock.close()
        coord.close()


# -- the registry and import hygiene ------------------------------------------------


def test_frontier_registry_entry_is_lazy_and_coordinator_capable():
    info = backend_info("frontier")
    assert info.needs_coordinator and info.name == "frontier"


def test_frontier_import_pulls_in_no_jax_and_no_reference_package():
    code = ("import sys, repro_torch.core.frontier, "
            "repro_torch.core.frontier_client, repro_torch.core.obs.report; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
