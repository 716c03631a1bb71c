"""The port's evaluation wire path, as ``tests/test_frames.py`` holds the JAX
package's: seed-only genome frames, batched task frames, the same-host
shared-memory fast path, cache-hit/dedup contracts shared by every backend,
and the worker-side scorer-table eviction bound.  Workers score on the CPU
(``device="cpu"``)."""
import concurrent.futures as cf
import random
import socket
import struct
import threading
import time

import pytest

from repro_torch.core.evals import (EvalCoordinator, EvalSpec, ProcessBackend,
                                    Scorer, ServiceBackend, intern_spec,
                                    make_backend)
from repro_torch.core.evals import protocol
from repro_torch.core.evals import worker as worker_mod
from repro_torch.core.evals.service_worker import EvalServiceWorker
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.core.search_space import (ACC_DTYPES, BLOCK_K_CHOICES,
                                           BLOCK_Q_CHOICES, DIV_MODES,
                                           KernelGenome, MASK_MODES,
                                           RESCALE_MODES, seed_genome)

FAST_SUITE = [BenchConfig("c4k", 8, 16, 16, 4096, causal=True),
              BenchConfig("n4k", 8, 16, 16, 4096, causal=False)]


def _random_genome(rng: random.Random) -> KernelGenome:
    return KernelGenome(
        block_q=rng.choice(BLOCK_Q_CHOICES),
        block_k=rng.choice(BLOCK_K_CHOICES),
        rescale_mode=rng.choice(RESCALE_MODES),
        mask_mode=rng.choice(MASK_MODES),
        div_mode=rng.choice(DIV_MODES),
        kv_in_grid=rng.choice((False, True)),
        gqa_pack=rng.choice((False, True)),
        acc_dtype=rng.choice(ACC_DTYPES))


def _columnar(inline, genomes):
    """The inline values a worker's columnar frame scoring must give:
    rung 0's batch path folds its sums in another order than the scalar
    path, so to relative 1e-12 (bit for bit with batch scoring off)."""
    return [pytest.approx(inline(g).values, rel=1e-12, abs=0) for g in genomes]


def _inproc_worker(address, slots=1, name="inproc"):
    w = EvalServiceWorker(*address, slots=slots, name=name, device="cpu")
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    return w, t


# -- seed-only genome frames -----------------------------------------------------


@pytest.mark.parametrize("seed", range(20))
def test_edit_list_roundtrip_property(seed):
    """Seeded-random genomes survive the to_edits/from_edits round trip
    bit-exactly — the identity the compact wire format rests on."""
    rng = random.Random(seed)
    for _ in range(25):
        g = _random_genome(rng)
        back = KernelGenome.from_edits(g.to_edits())
        assert back == g and back.key() == g.key()


def test_edit_list_of_seed_is_empty_and_edit_wire_is_small():
    assert seed_genome().to_edits() == ()
    # the satellite gate: compact process-task args at least 5x smaller than
    # the full (genome, spec) payload they replace
    import pickle
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    g = _random_genome(random.Random(3))
    full = len(pickle.dumps((g, spec), protocol=pickle.HIGHEST_PROTOCOL))
    compact = len(pickle.dumps((g.to_edits(), intern_spec(spec)),
                               protocol=pickle.HIGHEST_PROTOCOL))
    assert full >= 5 * compact, (full, compact)


def test_evaluate_frame_bit_identical_to_inline_and_rejects_unknown_spec():
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    sid = intern_spec(spec)
    worker_mod.register_worker_specs([(sid, spec)])
    g = _random_genome(random.Random(7))
    sv = worker_mod.evaluate_frame(g.to_edits(), sid)
    assert sv.values == Scorer(suite=FAST_SUITE,
                               check_correctness=False, device="cpu")(g).values
    with pytest.raises(RuntimeError, match="unknown interned spec id"):
        worker_mod.evaluate_frame(g.to_edits(), 10**9)


def test_evaluate_genome_by_name_keeps_latency_model():
    """A name-addressed evaluation must build the SAME spec (latency model
    included) as the spec-addressed path — the bit-identity hole where the
    keyword was silently dropped."""
    g = seed_genome()
    worker_mod.evaluate_genome(g, "mha", check_correctness=False,
                               service_latency_s=0.125, device="cpu",
                               machine="h100")
    want = EvalSpec.resolve("mha", check_correctness=False,
                            service_latency_s=0.125, device="cpu",
                            machine="h100")
    assert want in worker_mod._WORKER_SCORERS
    scorer = worker_mod._WORKER_SCORERS[want]
    assert scorer.service_latency_s == 0.125
    assert (scorer.device.type, scorer.machine) == ("cpu", "h100")


# -- batched wire frames ---------------------------------------------------------


def test_batched_tasks_frame_roundtrip_and_amortized_size():
    """One tasks frame carries a whole batch; per-task wire cost is >= 5x
    below the legacy one-full-frame-per-task cost."""
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    sid = intern_spec(spec)
    rng = random.Random(11)
    genomes = [_random_genome(rng) for _ in range(8)]
    batched = {"type": protocol.TASKS,
               "tasks": [(i, ("ed", g.to_edits(), sid))
                         for i, g in enumerate(genomes)]}
    legacy = [{"type": protocol.TASK, "id": i, "spec": spec, "genome": g}
              for i, g in enumerate(genomes)]
    assert sum(protocol.frame_size(m) for m in legacy) \
        >= 5 * protocol.frame_size(batched)
    a, b = socket.socketpair()
    try:
        protocol.send_msg(a, batched)
        msg = protocol.recv_msg(b)
        assert [KernelGenome.from_edits(p[1]) for _, p in msg["tasks"]] \
            == genomes
        assert [tid for tid, _ in msg["tasks"]] == list(range(8))
    finally:
        a.close()
        b.close()


def test_oversized_frame_rejected_both_ways(monkeypatch):
    monkeypatch.setattr(protocol, "MAX_FRAME", 4096)
    a, b = socket.socketpair()
    try:
        with pytest.raises(ValueError, match="frame too large"):
            protocol.send_msg(a, {"type": protocol.TASKS,
                                  "blob": bytes(8192)})
        # a peer ANNOUNCING an oversized frame is cut off before any alloc
        a.sendall(struct.pack(">I", protocol.MAX_FRAME))
        with pytest.raises(ConnectionError, match="oversized frame"):
            protocol.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_parse_address_ipv6_brackets():
    assert protocol.parse_address("[::1]:9000") == ("::1", 9000)
    assert protocol.parse_address("[fe80::2]:80") == ("fe80::2", 80)
    assert protocol.parse_address("localhost:80") == ("localhost", 80)
    with pytest.raises(ValueError, match="bracketed"):
        protocol.parse_address("::1:9000")


def test_coordinator_sends_batched_frames_to_capable_worker():
    """A raw socket advertising the compact capability receives ONE tasks
    frame for a submitted batch, with in-frame spec announcements; a legacy
    HELLO receives per-task full-payload frames."""
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    genomes = [seed_genome().with_(block_q=bq) for bq in (64, 256, 512)]
    coord = EvalCoordinator()
    compact = socket.create_connection(coord.address)
    try:
        protocol.send_msg(compact, {"type": protocol.HELLO, "name": "c",
                                    "slots": 4, "compact": True,
                                    "host": "elsewhere",    # no shm: off-host
                                    "package": protocol.PACKAGE})
        assert protocol.recv_msg(compact)["type"] == protocol.WELCOME
        assert coord.wait_for_workers(1, timeout=10)
        coord.submit_many(spec, genomes)
        msg = protocol.recv_msg(compact)
        assert msg["type"] == protocol.TASKS
        assert [KernelGenome.from_edits(p[1]) for _, p in msg["tasks"]] \
            == genomes
        sids = {sid for _, (_, _, sid) in msg["tasks"]}
        assert dict(msg["specs"]) == {sid: spec for sid in sids}
        st = coord.stats()
        assert st["wire_tasks_sent"] == 3
        assert st["wire_task_bytes"] == protocol.frame_size(msg)
    finally:
        compact.close()
        coord.close()

    coord = EvalCoordinator()
    legacy = socket.create_connection(coord.address)
    try:
        protocol.send_msg(legacy, {"type": protocol.HELLO, "name": "old",
                                   "slots": 4, "package": protocol.PACKAGE})
        assert protocol.recv_msg(legacy)["type"] == protocol.WELCOME
        assert coord.wait_for_workers(1, timeout=10)
        coord.submit_many(spec, genomes)
        for g in genomes:
            msg = protocol.recv_msg(legacy)
            assert msg["type"] == protocol.TASK
            assert msg["genome"] == g and msg["spec"] == spec
    finally:
        legacy.close()
        coord.close()


# -- the same-host shared-memory fast path ----------------------------------------


def test_same_host_shm_fast_path_bit_identical():
    """An in-process worker shares the coordinator's hostname, so genome
    payloads travel through the shm arena — and score bit-identically."""
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    svc = ServiceBackend(spec=spec, workers=0)
    w, t = _inproc_worker(svc.address, slots=2, name="samehost")
    try:
        assert svc.coordinator.wait_for_workers(1, timeout=10)
        genomes = [seed_genome().with_(block_q=bq) for bq in (64, 128, 256)]
        got = svc.map(genomes)
        inline = Scorer(suite=FAST_SUITE, check_correctness=False, device="cpu")
        assert [sv.values for sv in got] == _columnar(inline, genomes)
        st = svc.coordinator.stats()
        assert st["shm_genomes"] == 3          # one arena entry per genome
        assert st["shm_bytes"] > 0
        # refs on the socket, payloads in the arena: well under pickle size
        assert st["wire_bytes_per_task"] < 120
    finally:
        w.stop()
        t.join(5)
        svc.close()


def test_shm_attach_failure_degrades_to_edit_frames(monkeypatch):
    """A worker that cannot attach the arena reports shm_failure: the task
    requeues as an ordinary edit-list frame and completes correctly, and the
    coordinator stops sending that worker shm refs."""
    import repro_torch.core.evals.service_worker as sw
    monkeypatch.setattr(sw, "_attach_readonly",
                        lambda name: (_ for _ in ()).throw(OSError("no shm")))
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    svc = ServiceBackend(spec=spec, workers=0)
    w, t = _inproc_worker(svc.address, slots=1, name="noshm")
    try:
        assert svc.coordinator.wait_for_workers(1, timeout=10)
        g = seed_genome().with_(block_q=256)
        sv = svc(g)
        assert sv.values == Scorer(suite=FAST_SUITE,
                                   check_correctness=False, device="cpu")(g).values
        st = svc.coordinator.stats()
        assert any(e["event"] == "requeue" and e.get("why") == "shm"
                   for e in st["events"])
        # the retry (and any later task) goes out as an edit frame
        sv2 = svc(seed_genome().with_(block_k=512))
        assert sv2.values
        assert not any(e.get("why") == "shm"
                       for e in svc.coordinator.stats()["events"][len(st["events"]):])
    finally:
        w.stop()
        t.join(5)
        svc.close()


def test_mid_batch_worker_death_on_batched_wire():
    """A worker SIGKILLed while holding half a batched tasks frame: the
    orphans requeue onto the survivor and every future completes with the
    inline value — batching must not change the fault contract."""
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False,
                            service_latency_s=0.3, device="cpu")
    svc = ServiceBackend(spec=spec, workers=2, worker_slots=2,
                         worker_timeout_s=120.0)
    try:
        genomes = [seed_genome().with_(block_q=bq, block_k=bk)
                   for bq in (64, 128, 256, 512) for bk in (128, 256)]
        futs = svc.submit_many(genomes)          # one batch, both workers
        time.sleep(0.45)                         # mid-evaluation everywhere
        svc._procs[0].kill()
        got = [f.result(60) for f in futs]
        inline = Scorer(suite=FAST_SUITE, check_correctness=False, device="cpu")
        assert [sv.values for sv in got] == _columnar(inline, genomes)
        st = svc.coordinator.stats()
        assert st["tasks_requeued"] >= 1
        assert st["workers"] == 1
    finally:
        svc.close()


# -- cross-backend contracts ------------------------------------------------------


CONTRACT_BACKENDS = ("thread", "process", "service")


def _contract_backend(name):
    """(backend, finalizers) — process uses thread slots (the dedup/cache
    contract under test is parent-side and executor-agnostic; real worker
    processes are covered by the identity tests)."""
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    if name == "service":
        b = ServiceBackend(spec=spec, workers=0)
        w, t = _inproc_worker(b.address, slots=2, name="contract")
        assert b.coordinator.wait_for_workers(1, timeout=10)
        return b, [w.stop, lambda: t.join(5)]
    if name == "process":
        b = ProcessBackend(spec=spec,
                           executor=cf.ThreadPoolExecutor(max_workers=2))
        return b, [b._executor.shutdown]
    return make_backend(name, suite=spec), []


@pytest.mark.parametrize("name", CONTRACT_BACKENDS)
def test_cache_hit_accounting_contract(name):
    """One served request for a cached genome counts exactly one hit on
    EVERY backend (submit, map, __call__); prefetch is speculative and
    counts nothing.  This is what makes cache_hits comparable across
    thread vs process vs service reports."""
    b, finalizers = _contract_backend(name)
    try:
        g = seed_genome().with_(block_q=256)
        b(g)                                   # pay once (miss: no hit)
        hits0 = b.cache_hits
        b.submit(g).result(30)
        assert b.cache_hits == hits0 + 1       # submit: counted
        b.prefetch([g])
        assert b.cache_hits == hits0 + 1       # prefetch: never counted
        b.map([g])
        assert b.cache_hits == hits0 + 2       # map: counted per unique
        b(g)
        assert b.cache_hits == hits0 + 3       # __call__: counted
    finally:
        b.close()
        for fin in finalizers:
            fin()


@pytest.mark.parametrize("name", CONTRACT_BACKENDS)
def test_dedup_exact_under_concurrent_map_submit_prefetch(name):
    """map + submit + prefetch racing from three threads over one genome set
    pay each unique genome exactly once — the satellite bug was map/prefetch
    bypassing the submit dedup table and burning duplicate evaluations."""
    b, finalizers = _contract_backend(name)
    try:
        genomes = [seed_genome().with_(block_q=bq, block_k=bk)
                   for bq in (64, 128, 256) for bk in (128, 256)]
        start = threading.Barrier(3)

        def do_map():
            start.wait(10)
            b.map(genomes)

        def do_submit():
            start.wait(10)
            for f in [b.submit(g) for g in genomes]:
                f.result(30)

        def do_prefetch():
            start.wait(10)
            b.prefetch(genomes)

        threads = [threading.Thread(target=fn)
                   for fn in (do_map, do_submit, do_prefetch)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert b.map(genomes)                  # everything resolves
        assert b.n_evaluations == len(genomes)
    finally:
        b.close()
        for fin in finalizers:
            fin()


# -- worker-side scorer table ------------------------------------------------------


def test_scorer_table_evicts_least_recently_used(monkeypatch):
    """The per-process scorer table is LRU-bounded: a long-lived worker that
    has served many retired specs keeps at most SCORER_CACHE_CAP warm
    scorers, and a re-used spec is refreshed, not evicted."""
    monkeypatch.setattr(worker_mod, "SCORER_CACHE_CAP", 2)
    monkeypatch.setattr(worker_mod, "_WORKER_SCORERS",
                        worker_mod._WORKER_SCORERS.__class__())
    specs = [EvalSpec.resolve(FAST_SUITE, check_correctness=False,
                              rng_seed=i, device="cpu") for i in range(3)]
    s0 = worker_mod._scorer_for(specs[0])
    worker_mod._scorer_for(specs[1])
    worker_mod._scorer_for(specs[0])           # refresh 0: now 1 is LRU
    worker_mod._scorer_for(specs[2])           # evicts 1, not 0
    assert set(worker_mod._WORKER_SCORERS) == {specs[0], specs[2]}
    assert worker_mod._scorer_for(specs[0]) is s0   # survived, still warm
