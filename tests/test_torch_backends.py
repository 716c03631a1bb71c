"""The port's evaluation backends against the JAX package's: the registry,
the backend contract parametrized over every backend (close, in-flight
dedup, failure eviction and retry, parent cache), the spec's device and
machine, the cache key a pooled backend shares with the inline scorer, the
card lock on the CPU, workers asked for a card this host does not have, and
rung-0 lineages identical through inline, thread, process, service and the
elastic pool, and equal to the JAX package's inline lineage.

Worker processes are spawned (at most 2 per backend) and score on the CPU
(``device="cpu"``), where the gate runs the kernel's plain version."""
import concurrent.futures as cf
import contextlib
import pickle
import threading

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch

from repro.core import ContinuousEvolution as JaxContinuousEvolution
from repro.core import Scorer as JaxScorer
from repro.core.evals.scorer import set_batch_scoring as jax_set_batch_scoring
from repro.core.perfmodel import BenchConfig as JaxBenchConfig
from repro_torch.core.evals import (MEASURED, PERFMODEL, BatchScorer,
                                    ElasticProcessPool, EvalSpec,
                                    InlineBackend, ProcessBackend, ScoreCache,
                                    Scorer, ServiceBackend, ThreadBackend,
                                    backend_info, default_worker_count,
                                    evaluate_genome, make_backend,
                                    registered_backends, set_batch_scoring)
from repro_torch.core.evals import worker as worker_mod
from repro_torch.core.evals.backends import ParentCacheBackend
from repro_torch.core.evals.service_worker import EvalServiceWorker
from repro_torch.core.evolution import ContinuousEvolution
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.core.search_space import seed_genome
from repro_torch.device import card_lock, card_lock_stats

FAST = [("c4k", 8, 16, 16, 4096, True), ("n4k", 8, 16, 16, 4096, False)]
FAST_SUITE = [BenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST]
LINEAGE_STEPS = 5
POOLED = ("thread", "process", "elastic", "service")


def _spec(**kw):
    kw.setdefault("check_correctness", False)
    return EvalSpec.resolve(FAST_SUITE, device="cpu", **kw)


def _inproc_worker(address, slots=2, name="inproc"):
    """A service worker on a thread of the test process, on the CPU."""
    w = EvalServiceWorker(*address, slots=slots, name=name, device="cpu")
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    return w, t


def _backend(name, spec, real=False):
    """(backend, finalizers).  ``real``: spawned worker processes (2 at
    most); otherwise the pools run on threads of the test process, which
    exercises the parent-side contract without start-up cost."""
    if name == "inline":
        return make_backend("inline", suite=spec), []
    if name == "thread":
        return make_backend("thread", suite=spec, max_workers=2), []
    if name == "process":
        if real:
            return make_backend("process", suite=spec, max_workers=2,
                                mp_context="spawn"), []
        b = ProcessBackend(spec=spec, executor=cf.ThreadPoolExecutor(2))
        return b, [b._executor.shutdown]
    if name == "elastic":
        pool = (ElasticProcessPool((spec,), min_workers=1, max_workers=2,
                                   mp_context="spawn") if real else
                ElasticProcessPool(slot_factory=lambda: cf.ThreadPoolExecutor(1),
                                   min_workers=1, max_workers=2))
        return ProcessBackend(spec=spec, executor=pool), [
            lambda: pool.shutdown(wait=True, cancel_futures=True)]
    if name == "service":
        if real:
            return ServiceBackend(spec=spec, workers=2), []
        b = ServiceBackend(spec=spec, workers=0)
        w, t = _inproc_worker(b.address)
        assert b.coordinator.wait_for_workers(1, timeout=10)
        return b, [w.stop, lambda: t.join(5)]
    raise AssertionError(name)


@contextlib.contextmanager
def _open(name, spec, real=False):
    b, finalizers = _backend(name, spec, real)
    try:
        yield b
    finally:
        b.close()
        for fin in finalizers:
            fin()


# -- the registry --------------------------------------------------------------


@pytest.mark.parametrize("name,cls", [("inline", InlineBackend),
                                      ("thread", ThreadBackend),
                                      ("process", ProcessBackend),
                                      ("service", ServiceBackend)])
def test_registry_builds_each_backend(name, cls):
    info = backend_info(name)
    assert info.name == name and name in registered_backends()
    with _open(name, _spec()) as b:
        assert isinstance(b, cls)
        assert b(seed_genome()).values == \
            Scorer(suite=FAST_SUITE, check_correctness=False,
                   device="cpu")(seed_genome()).values
    assert ThreadBackend is BatchScorer
    with pytest.raises(ValueError, match="unknown eval backend"):
        make_backend("bogus")


def test_worker_width_defaults():
    import os
    assert default_worker_count() == max(2, min(8, os.cpu_count() or 2))
    assert default_worker_count(on_card=True) == 2
    assert default_worker_count(3, on_card=True) == 3
    b = make_backend("thread", suite=_spec())
    assert b.max_workers == default_worker_count()
    b.close()


# -- the backend contract, over every pooled backend ----------------------------


@pytest.mark.parametrize("name", POOLED)
def test_close_idempotent_and_submit_after_close_raises(name):
    b, finalizers = _backend(name, _spec())
    try:
        assert b(seed_genome()).values
        b.close()
        b.close()
        with pytest.raises(RuntimeError, match="closed"):
            b.submit(seed_genome())
    finally:
        for fin in finalizers:
            fin()


@pytest.mark.parametrize("name", POOLED)
def test_inflight_dedup_shares_one_future(name):
    """Two submits while the evaluation is held open share one future and
    one paid evaluation; a later submit is a completed cache hit."""
    with _open(name, _spec(service_latency_s=0.4)) as b:
        g = seed_genome()
        f1 = b.submit(g)
        assert b.submit(g) is f1
        sv = f1.result(30)
        assert sv.values == Scorer(suite=FAST_SUITE, check_correctness=False,
                                   device="cpu")(g).values
        f3 = b.submit(g)
        assert f3.done() and f3.result().values == sv.values
        assert b.n_evaluations == 1


@pytest.mark.parametrize("name", POOLED)
def test_failed_evaluation_is_evicted_and_retried(name):
    """A failing evaluation propagates, is never cached, leaves nothing in
    flight, and a later request pays it again."""
    bad = EvalSpec(suite=("not-a-config",), check_correctness=False,
                   device="cpu")
    with _open(name, bad) as b:
        for attempt in (1, 2):
            with pytest.raises(Exception):
                b.submit(seed_genome()).result(30)
            assert b.in_flight == ()
            assert b.n_evaluations == attempt
        assert len(b.cache) == 0


@pytest.mark.parametrize("name", ("process", "elastic", "service"))
def test_parent_cache_and_dedup(name):
    with _open(name, _spec()) as b:
        g1, g2 = seed_genome(), seed_genome().with_(block_q=256)
        svs = b.map([g1, g2, g1, g2, g1])
        assert b.n_evaluations == 2
        assert [sv.values for sv in svs[:2]] == [svs[2].values, svs[3].values]
        again = b.map([g1, g2])
        assert b.n_evaluations == 2 and b.cache_hits >= 2
        assert [a.values for a in again] == [svs[0].values, svs[1].values]
        assert b.in_flight == ()


class _FlakyScorer(Scorer):
    """First evaluation raises after a waiter has queued; later ones work."""

    def __init__(self, **kw):
        super().__init__(check_correctness=False, device="cpu", **kw)
        self.calls = 0
        self.first_started = threading.Event()
        self.release_first = threading.Event()

    def score_uncached(self, genome):
        self.calls += 1
        if self.calls == 1:
            self.first_started.set()
            assert self.release_first.wait(10)
            raise RuntimeError("transient evaluator failure")
        return super().score_uncached(genome)


def test_thread_owner_failure_propagates_and_waiter_retries():
    base = _FlakyScorer(suite=FAST_SUITE)
    batch = BatchScorer(base)
    g = seed_genome()
    results = {}

    def call(tag):
        try:
            results[tag] = batch(g)
        except RuntimeError as e:
            results[tag] = e

    t1 = threading.Thread(target=call, args=("owner",))
    t1.start()
    assert base.first_started.wait(10)
    t2 = threading.Thread(target=call, args=("waiter",))
    t2.start()
    base.release_first.set()
    t1.join(10)
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()
    assert isinstance(results["owner"], RuntimeError)
    assert results["waiter"].values == Scorer(
        suite=FAST_SUITE, check_correctness=False, device="cpu")(g).values
    assert base.calls == 2 and batch.in_flight == ()
    batch.close()


# -- the spec, the key, the lock -----------------------------------------------


def test_eval_spec_carries_device_and_machine():
    spec = EvalSpec.resolve("mha", check_correctness=False, device="cpu",
                            machine="h100")
    assert (spec.device, spec.machine) == ("cpu", "h100") and not spec.on_card
    assert pickle.loads(pickle.dumps(spec)) == spec
    moved = spec.with_fidelity(MEASURED)
    assert (moved.fidelity, moved.device, moved.machine) == (MEASURED, "cpu", "h100")
    assert EvalSpec.resolve(spec) is spec
    as_device = EvalSpec.resolve("mha", device=torch.device("cpu"))
    assert as_device.device == "cpu" and isinstance(as_device.device, str)
    assert EvalSpec.resolve("mha").on_card           # None is the card
    assert EvalSpec.resolve("mha", device="cuda:0").on_card
    # a worker builds its scorer from the spec: device and machine included
    sv = evaluate_genome(seed_genome(), spec)
    scorer = worker_mod._WORKER_SCORERS[spec]
    assert scorer.device.type == "cpu" and scorer.machine == "h100"
    assert sv.values == Scorer(check_correctness=False, device="cpu",
                               machine="h100")(seed_genome()).values


@pytest.mark.parametrize("fidelity,device,machine", [
    (PERFMODEL, "cpu", None), (PERFMODEL, "cpu", "h100"),
    (PERFMODEL, "cpu", "tpu_v5e"), (PERFMODEL, None, None),
    (PERFMODEL, "cuda:0", "h100"), (MEASURED, None, None),
    (MEASURED, "cuda", "h100")])
def test_parent_cache_key_is_the_scorers(monkeypatch, fidelity, device, machine):
    """A pooled backend keys its cache exactly as ``Scorer.score_key`` of
    the same spec; on this host the card is only named, never touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    spec = EvalSpec.resolve(FAST_SUITE, check_correctness=False,
                            fidelity=fidelity, device=device, machine=machine)
    scorer = Scorer(suite=FAST_SUITE, check_correctness=False,
                    fidelity=fidelity, device=device, machine=machine)
    backend = ParentCacheBackend(spec)
    for g in (seed_genome(), seed_genome().with_(block_q=512, kv_in_grid=True)):
        assert backend.score_key(g) == scorer.score_key(g)
    assert backend.plan_machine == scorer.plan_machine
    assert backend.device.type == scorer.device.type
    assert backend.fidelity == scorer.fidelity


def test_inline_and_pooled_backend_share_one_cache():
    cache = ScoreCache()
    inline = InlineBackend(suite=FAST_SUITE, check_correctness=False,
                           device="cpu", cache=cache)
    pooled = ProcessBackend(spec=_spec(), cache=cache,
                            executor=cf.ThreadPoolExecutor(1))
    g = seed_genome().with_(block_k=512)
    try:
        sv = inline(g)
        assert pooled(g) is sv and pooled.n_evaluations == 0
        other = ProcessBackend(spec=_spec(machine="h100"), cache=cache,
                               executor=pooled._executor)
        assert other(g).values != sv.values and other.n_evaluations == 1
    finally:
        pooled._executor.shutdown()


def test_card_lock_is_a_noop_on_cpu(monkeypatch):
    import fcntl

    def refuse(*a, **k):
        raise AssertionError("flock taken for a CPU device")
    monkeypatch.setattr(fcntl, "flock", refuse)
    assert isinstance(card_lock("cpu"), contextlib.nullcontext)
    before = card_lock_stats()
    s = Scorer(suite=FAST_SUITE, device="cpu")
    s.warm()
    assert s.score_uncached(seed_genome().with_(block_q=64)).correct
    assert card_lock_stats() == before == {}


# -- no card here: a worker asked for one raises ---------------------------------


def test_worker_asked_for_the_card_raises_without_one(monkeypatch):
    """No worker of any backend scores a card spec on the CPU: the worker
    function, the pools and the service all raise before any score."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    card = EvalSpec.resolve(FAST_SUITE, check_correctness=False)
    n_scorers = len(worker_mod._WORKER_SCORERS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_genome(seed_genome(), card)
    for name in ("process", "service"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_backend(name, suite=card, max_workers=2) if name == "process" \
                else make_backend(name, suite=card, workers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticProcessPool((card.with_fidelity(PERFMODEL),), max_workers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EvalServiceWorker("127.0.0.1", 1)
    assert len(worker_mod._WORKER_SCORERS) == n_scorers


def test_card_kernel_that_cannot_build_raises(monkeypatch):
    """A card that seems present but a kernel that does not build: the
    parent raises the build error and no pool starts on the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        make_backend("process", suite=FAST_SUITE, device="cuda", max_workers=2)


# -- rung-0 lineages: every backend, and the JAX package -------------------------


def _commits(lineage):
    return [(c.genome.key(), c.geomean, c.values, c.note) for c in lineage.commits]


@pytest.fixture(scope="module")
def jax_lineage():
    jax_set_batch_scoring(False)
    try:
        evo = JaxContinuousEvolution(scorer=JaxScorer(
            suite=[JaxBenchConfig(n, b, h, kv, s, causal=c)
                   for n, b, h, kv, s, c in FAST]))
        evo.run(max_steps=LINEAGE_STEPS)
    finally:
        jax_set_batch_scoring(True)
    return _commits(evo.lineage)


@pytest.mark.parametrize("name", ("inline",) + POOLED)
def test_rung0_lineage_identical_across_backends_and_to_jax(name, jax_lineage):
    """Same seed, rung 0 on the TPU v5e model, the gate on: the lineage
    through each backend (real spawned workers for process, elastic and
    service) equals the JAX package's inline lineage.  Batch scoring is off
    in both packages (scalar and columnar rung 0 differ by an ulp on some
    hosts); spawned workers take the parent's setting."""
    set_batch_scoring(False)
    try:
        with _open(name, EvalSpec.resolve(FAST_SUITE, device="cpu",
                                          machine="tpu_v5e"), real=True) as b:
            evo = ContinuousEvolution(scorer=b)
            rep = evo.run(max_steps=LINEAGE_STEPS)
            ours = _commits(evo.lineage)
    finally:
        set_batch_scoring(True)
    assert rep.steps == LINEAGE_STEPS and len(ours) > 1
    assert ours == jax_lineage


def test_continuous_evolution_builds_the_named_backend():
    evo = ContinuousEvolution(device="cpu", eval_backend="thread", workers=2)
    try:
        assert isinstance(evo.scorer, ThreadBackend)
        assert evo.scorer.max_workers == 2
        assert evo.scorer.plan_machine == "tpu_v5e"
        assert evo.kb.facts is not None
    finally:
        evo.close()
    with pytest.raises(ValueError, match="pooled"):
        ContinuousEvolution(device="cpu", workers=2)


def test_cli_through_a_pooled_backend(tmp_path, capsys):
    """``python -m repro_torch.evolve --backend process --workers 2`` at
    rung 0 on the CPU: the opening line names the backend and its width,
    and the lineage is the inline CLI's."""
    from repro_torch import evolve
    from repro_torch.core.population import Lineage
    cli = ["--fidelity", "perfmodel", "--device", "cpu", "--commits", "2",
           "--max-steps", "3"]
    set_batch_scoring(False)
    try:
        evolve.main(cli + ["--out", str(tmp_path / "inline")])
        evolve.main(cli + ["--out", str(tmp_path / "process"),
                           "--backend", "process", "--workers", "2"])
    finally:
        set_batch_scoring(True)
    out = capsys.readouterr().out
    assert "through the inline backend (1 worker)" in out
    assert "through the process backend (2 workers)" in out
    ours, want = (Lineage.load(str(tmp_path / d / "lineage_mha.json"))
                  for d in ("process", "inline"))
    assert _commits(ours) == _commits(want) and len(want) > 1
    with pytest.raises(SystemExit):
        evolve.main(cli + ["--workers", "2"])       # inline takes no workers
