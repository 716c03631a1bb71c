"""The port's ElasticProcessPool, as ``tests/test_elastic.py`` holds the JAX
package's: queue-depth-driven growth/shrink with hysteresis, executor-surface
correctness (results, exceptions, cancellation, shutdown), in-flight dedup
staying exact across resizes behind the process backend, real spawned
worker slots; and the port's start method per slot (spawn on the card)."""
import concurrent.futures as cf
import threading
import time

import pytest

from repro_torch.core.evals import ElasticProcessPool, EvalSpec, ProcessBackend
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.core.search_space import seed_genome

FAST_SUITE = [BenchConfig("c4k", 8, 16, 16, 4096, causal=True),
              BenchConfig("n4k", 8, 16, 16, 4096, causal=False)]


def thread_slots():
    """Slot factory for tests: one single-thread executor per slot, so
    elasticity is exercised without worker-process spin-up cost."""
    return cf.ThreadPoolExecutor(max_workers=1)


class _SlowSlot:
    """A slot whose every task takes a beat — makes queue build-up (and so
    resize decisions) deterministic instead of timing-lucky."""

    def __init__(self, delay=0.02):
        self.inner = cf.ThreadPoolExecutor(max_workers=1)
        self.delay = delay

    def submit(self, fn, *args, **kw):
        def slow():
            time.sleep(self.delay)
            return fn(*args, **kw)
        return self.inner.submit(slow)

    def shutdown(self, wait=True, **kw):
        self.inner.shutdown(wait=wait)


def test_grows_under_queue_pressure_and_respects_max():
    gate = threading.Event()
    pool = ElasticProcessPool(slot_factory=thread_slots,
                              min_workers=1, max_workers=3,
                              grow_depth=1.0, hysteresis=2)
    try:
        futs = [pool.submit(lambda i=i: (gate.wait(10), i)[1])
                for i in range(12)]
        # every slot is gated, so 12 submissions against cap 3 must have
        # grown the pool to its max and no further
        assert pool.n_workers == 3
        assert pool.stats()["grown"] == 2
        gate.set()
        assert [f.result(10) for f in futs] == list(range(12))
        assert pool.stats()["tasks_completed"] == 12
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def test_shrinks_when_idle_and_respects_min():
    gate = threading.Event()
    pool = ElasticProcessPool(slot_factory=thread_slots,
                              min_workers=1, max_workers=4,
                              grow_depth=0.5, hysteresis=1,
                              shrink_idle_s=0.05)
    try:
        burst = [pool.submit(lambda: gate.wait(10)) for _ in range(8)]
        assert pool.n_workers > 1
        gate.set()
        for f in burst:
            f.result(10)
        # slots idle past shrink_idle_s are reclaimed on later completions
        deadline = time.monotonic() + 10
        while pool.n_workers > 1 and time.monotonic() < deadline:
            time.sleep(0.06)
            pool.submit(lambda: 1).result(10)
        assert pool.n_workers == 1            # back at the floor, never below
        assert pool.stats()["shrunk"] >= 1
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def test_brief_idle_beats_do_not_thrash_workers():
    """An epoch-barrier-length quiet must NOT retire workers — spin-up costs
    seconds, so only an idle period past shrink_idle_s may shrink."""
    gate = threading.Event()
    pool = ElasticProcessPool(slot_factory=thread_slots,
                              min_workers=1, max_workers=3,
                              grow_depth=0.5, hysteresis=1,
                              shrink_idle_s=30.0)
    try:
        burst = [pool.submit(lambda: gate.wait(10)) for _ in range(6)]
        gate.set()
        for f in burst:
            f.result(10)
        grown_to = pool.n_workers
        assert grown_to > 1
        for _ in range(5):                    # quiet beats + trickle work
            time.sleep(0.02)
            pool.submit(lambda: 1).result(10)
        assert pool.n_workers == grown_to     # nothing reclaimed
        assert pool.stats()["shrunk"] == 0
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def test_exceptions_propagate_and_pool_stays_usable():
    pool = ElasticProcessPool(slot_factory=thread_slots,
                              min_workers=1, max_workers=2)
    try:
        def boom():
            raise ValueError("task failure")
        with pytest.raises(ValueError, match="task failure"):
            pool.submit(boom).result(10)
        assert pool.submit(lambda: 41 + 1).result(10) == 42
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def test_shutdown_without_cancel_drains_queue_and_leaks_no_slots():
    """shutdown(wait=True) with work still queued must complete that work
    (the executor drain contract) — and never spawn replacement slots after
    close (a post-shutdown 'replace-broken' grow would leak a worker)."""
    gate = threading.Event()
    pool = ElasticProcessPool(slot_factory=thread_slots,
                              min_workers=1, max_workers=1)
    running = pool.submit(lambda: (gate.wait(10), 1)[1])
    queued = pool.submit(lambda: 2)
    gate.set()
    pool.shutdown(wait=True, cancel_futures=False)
    assert running.result(10) == 1
    assert queued.result(10) == 2              # drained, not errored
    stats = pool.stats()
    assert stats["workers"] == 1               # nothing spawned post-close
    assert not any(e["why"] == "replace-broken"
                   for e in stats["resize_events"])


def test_shutdown_cancels_pending_and_rejects_new_submits():
    gate = threading.Event()
    pool = ElasticProcessPool(slot_factory=thread_slots,
                              min_workers=1, max_workers=1)
    running = pool.submit(lambda: gate.wait(10))
    queued = pool.submit(lambda: 1)
    pool.shutdown(wait=False, cancel_futures=True)
    assert queued.cancelled()
    gate.set()
    running.result(10)
    with pytest.raises(RuntimeError, match="closed ElasticProcessPool"):
        pool.submit(lambda: 1)
    pool.shutdown(wait=True, cancel_futures=True)   # idempotent


def test_resize_events_are_observable():
    gate = threading.Event()
    pool = ElasticProcessPool(slot_factory=thread_slots,
                              min_workers=1, max_workers=2,
                              grow_depth=1.0, hysteresis=1)
    try:
        futs = [pool.submit(lambda: gate.wait(10)) for _ in range(4)]
        gate.set()
        for f in futs:
            f.result(10)
        stats = pool.stats()
        assert stats["peak_workers"] == 2
        assert stats["tasks_submitted"] == 4
        grows = [e for e in stats["resize_events"] if e["event"] == "grow"]
        assert grows and grows[0]["workers"] == 2
        assert all({"event", "workers", "queue_depth", "why"} <= set(e)
                   for e in stats["resize_events"])
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def test_validation():
    with pytest.raises(ValueError, match="min_workers"):
        ElasticProcessPool(slot_factory=thread_slots, min_workers=0)
    with pytest.raises(ValueError, match="max_workers"):
        ElasticProcessPool(slot_factory=thread_slots,
                           min_workers=4, max_workers=2)


# -- the satellite gate: dedup stays exact across an elastic resize -------------


def test_process_backend_dedup_exact_across_elastic_resize():
    """Duplicate submissions must keep collapsing onto one evaluation while
    the pool underneath them grows and shrinks — the in-flight table lives in
    the backend, not in any particular worker slot."""
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    pool = ElasticProcessPool(slot_factory=lambda: _SlowSlot(),
                              min_workers=1, max_workers=3,
                              grow_depth=0.5, hysteresis=1)
    backend = ProcessBackend(spec=spec, executor=pool)
    try:
        genomes = [seed_genome(), seed_genome().with_(block_q=256),
                   seed_genome().with_(block_k=256),
                   seed_genome().with_(kv_in_grid=True)]
        # a burst of heavy duplication: 4 unique genomes, 24 requests
        svs = backend.map(genomes * 6)
        assert backend.n_evaluations == len(genomes)
        assert pool.stats()["grown"] >= 1        # the burst forced growth
        # results identical request-for-request, and the table is clean
        assert [sv.values for sv in svs] == [sv.values for sv in svs[:4]] * 6
        assert backend.in_flight == ()
        # post-resize the dedup still holds for fresh work
        g = seed_genome().with_(block_q=512)
        backend.map([g, g, g])
        assert backend.n_evaluations == len(genomes) + 1
    finally:
        backend.close()
        pool.shutdown(wait=True, cancel_futures=True)


@pytest.mark.parametrize("batch", [False, True])
def test_elastic_pool_with_real_worker_processes(batch):
    """End-to-end: default slot factory, real single-worker process slots
    (spawned, given the parent's batch setting), results equal to the inline
    scorer's: bit for bit with batch scoring off, to relative 1e-12 with it
    on (the worker scores a chunk columnar)."""
    from repro_torch.core.evals import Scorer, set_batch_scoring
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False, device="cpu")
    set_batch_scoring(batch)
    try:
        pool = ElasticProcessPool((spec,), min_workers=1, max_workers=2,
                                  mp_context="spawn")
        backend = ProcessBackend(spec=spec, executor=pool)
        try:
            g1, g2 = seed_genome(), seed_genome().with_(block_q=256)
            got = backend.map([g1, g2, g1])
            inline = Scorer(suite=FAST_SUITE, check_correctness=False,
                            device="cpu")
            want = [inline(g1).values, inline(g2).values, inline(g1).values]
            assert [sv.values for sv in got] == \
                (want if not batch else
                 [pytest.approx(v, rel=1e-12, abs=0) for v in want])
            assert backend.n_evaluations == 2
        finally:
            backend.close()
            pool.shutdown(wait=True, cancel_futures=True)
    finally:
        set_batch_scoring(True)


def test_start_method_follows_the_device(monkeypatch):
    """Pools spawn; an explicit fork is taken for CPU specs from a CUDA-clean
    parent and refused where CUDA rules it out (a card spec, or a parent
    that initialised CUDA): CUDA does not survive fork."""
    import torch

    from repro_torch.core.evals.backends import _resolve_mp_context
    cpu = EvalSpec.resolve(FAST_SUITE, device="cpu")
    card = EvalSpec.resolve(FAST_SUITE)
    assert _resolve_mp_context(None, (cpu,)).get_start_method() == "spawn"
    assert _resolve_mp_context(None, (cpu, card)).get_start_method() == "spawn"
    assert _resolve_mp_context("fork", (cpu,)).get_start_method() == "fork"
    with pytest.raises(ValueError, match="fork"):
        _resolve_mp_context("fork", (card,))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert _resolve_mp_context(None, (cpu,)).get_start_method() == "spawn"
    with pytest.raises(ValueError, match="fork"):
        _resolve_mp_context("fork", (cpu,))
