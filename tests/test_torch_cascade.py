"""The port's rung 1 and evaluation cascade against the JAX package's, on the
CPU: the meta-device trace's counts (a hand-computed chain, the block
pairs a walk visits, dense dot FLOPs equal to the reference's HLO count),
rung-1 values exactly those of an independently counted launch, the batch path,
fidelity keys that never alias (also under concurrent submit and map
through the thread, process and service backends), ``CascadeBackend``'s
promotion and calibration (equal to the reference's on identical rung
tables), and the island engine with the cascade: lineages equal with it
off, with promotion off and on, and equal to the JAX package's, promote
fractions, kill and resume, and the parameter checks.

On the CPU a cascade runs rungs 0-1: the measured rung times the card.
Where a test needs a third rung it stands in as a table.  Batch scoring is
off in both packages (scalar and columnar rung 0 differ by an ulp on some
hosts); worker processes are not spawned (the pools run on threads)."""
import concurrent.futures as cf
import functools
import importlib
import threading

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.evals import CascadeBackend as JaxCascadeBackend
from repro.core.evals.scorer import set_batch_scoring as jax_set_batch_scoring
from repro_torch.core.evals import (DEFAULT_ETA, FIDELITIES, HLO, MEASURED,
                                    PERFMODEL, CascadeBackend, EvalSpec,
                                    ProcessBackend, ScoreCache, Scorer,
                                    ServiceBackend, fidelity_key, make_backend,
                                    set_batch_scoring)
from repro_torch.core.evals.cascade import ladder, rung_spec
from repro_torch.core.evals.scorer import LAUNCH_S, PROXY_SEQ
from repro_torch.core.perfmodel import useful_flops
from repro_torch.core.perfmodel_h100 import FP32_OPS, HBM_BW, PEAK_FLOPS
from repro_torch.core.evals.service_worker import EvalServiceWorker
from repro_torch.core.search_space import full_space
from repro_torch.kernels.flash_attention import (chunk_step_plain,
                                                 cta_epilogue_plain,
                                                 flash_attention_plain)
from repro_torch.launch.trace_analysis import trace_summary

FAST = [("c4k", 8, 16, 16, 4096, True), ("n4k", 8, 16, 16, 4096, False)]
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _scalar_rung0():
    jax_set_batch_scoring(False)
    set_batch_scoring(False)
    yield
    jax_set_batch_scoring(True)
    set_batch_scoring(True)


def _suite(pkg=T):
    return [pkg.BenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST]


def _slate(n, pkg=T):
    g = pkg.seed_genome()
    edits = [dict(block_q=256), dict(block_k=256), dict(kv_in_grid=True),
             dict(mask_mode="block_skip"), dict(rescale_mode="branchless"),
             dict(div_mode="deferred"), dict(block_q=64)]
    return [g] + [g.with_(**e) for e in edits[:n - 1]]


def _meta(*shape):
    return torch.empty(shape, device="meta")


# -- the trace -------------------------------------------------------------------


def test_trace_summary_counts_a_hand_computed_chain():
    def chain(a, b):
        c = a @ b                        # mm: 2 * 4 * 3 * 8 = 192 dot FLOPs
        d = torch.exp(c) + 1.0           # 12 + 12 elementwise
        return d[:2].sum(dim=-1)         # a slice of 6, a sum over 6

    s = trace_summary(chain, _meta(4, 8), _meta(8, 3))
    assert s["dot_flops"] == 192 and s["ew_flops"] == 12 + 12 + 6
    assert s["flops"] == 222
    # mm reads 32 + 24 and writes 12 floats; exp and add read and write 12;
    # the slice reads and writes its 6; the sum reads 6 and writes 2
    assert s["bytes_accessed"] == 4 * ((32 + 24 + 12) + 24 + 24 + 12 + 8)
    assert s["collective_total_bytes"] == 0 and s["collective_bytes"] == {}
    with pytest.raises(ValueError, match="meta"):
        trace_summary(chain, torch.zeros(4, 8), _meta(8, 3))


def _pairs(nq, nk, bq, bk, skip):
    """Block pairs a causal walk visits: all of them, or, skipping, those
    whose first key lies at or before the q-block's last row."""
    return sum(min(nk, -(-(i + 1) * bq // bk)) if skip else nk for i in range(nq))


@pytest.mark.parametrize("kv_in_grid", [True, False])
@pytest.mark.parametrize("bq,bk", [(16, 16), (32, 16)])
def test_trace_dot_flops_follow_the_visited_block_pairs(kv_in_grid, bq, bk):
    """At a causal proxy, dense against block_skip: the grid body skips the
    fully masked pairs, the loop body narrows its loop to the same ones."""
    q = _meta(1, 4, PROXY_SEQ, 64)
    nq, nk = PROXY_SEQ // bq, PROXY_SEQ // bk
    per_pair = 2 * (2 * 4 * bq * bk * 64)           # Q K^T and P V, 4 heads
    for mode, skip in (("dense", False), ("block_skip", True)):
        s = trace_summary(flash_attention_plain, q, q, q, causal=True,
                          block_q=bq, block_k=bk, mask_mode=mode,
                          kv_in_grid=kv_in_grid)
        assert s["dot_flops"] == per_pair * _pairs(nq, nk, bq, bk, skip)
    assert _pairs(nq, nk, bq, bk, True) < nq * nk


@pytest.mark.parametrize("kv_in_grid", [True, False])
def test_dense_dot_flops_equal_the_reference_hlo_count(kv_in_grid):
    """A dense walk runs every block pair in both packages: the meta trace
    and the reference's HLO analysis count the same dot FLOPs."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention
    from repro.launch.hlo_analysis import HloAnalysis
    kw = dict(causal=True, window=None, block_q=32, block_k=16,
              mask_mode="dense", kv_in_grid=kv_in_grid)
    shape = jax.ShapeDtypeStruct((1, 4, PROXY_SEQ, 64), jnp.float32)
    fn = functools.partial(flash_attention, interpret=True, **kw)
    ref = HloAnalysis(jax.jit(fn).lower(shape, shape, shape).compile()
                      .as_text()).summary()
    q = _meta(1, 4, PROXY_SEQ, 64)
    assert trace_summary(flash_attention_plain, q, q, q, **kw)["dot_flops"] \
        == ref["dot_flops"] > 0


# -- rung 1 ------------------------------------------------------------------------


def test_rung1_agrees_with_trace_summary_totals():
    """The hlo rung's value is exactly ``useful_flops`` over the rung-1 time
    of an independently counted launch: at a causal config (B 8, 16 heads, S
    4096, D 128: the wgmma body, 32 CTAs of 128 rows and 32 chunks of 128
    keys a head), the seed's single-stage walk visits every chunk and masks
    each; the ring with block_skip visits chunks 0..r in CTA r and masks the
    diagonal one.  Per chunk and per CTA epilogue, independent traces."""
    cfg = _suite()[0]
    heads, n = cfg.batch * cfg.n_heads, cfg.seq_len // 128
    q, kv, acc, row = (torch.empty(shape, dtype=dt, device="meta") for shape, dt in (
        ((128, 128), torch.bfloat16), ((128, 128), torch.bfloat16),
        ((128, 128), torch.float32), ((128,), torch.float32)))
    pos = torch.empty((128, 1), dtype=torch.int64, device="meta")
    compulsory = 2 * 128 * cfg.batch * cfg.seq_len * 2 * (cfg.n_heads + cfg.n_kv_heads)
    seed = T.seed_genome()
    for g, visited, hidden, modes, stage in (
            (seed, heads * n * n, heads * n * n,
             dict(rescale_mode="branchless", div_mode="deferred"), True),
            (seed.with_(kv_in_grid=True, mask_mode="block_skip"),
             heads * n * (n + 1) // 2, heads * n,
             dict(rescale_mode=seed.rescale_mode, div_mode=seed.div_mode), False)):
        step = {masked: trace_summary(
            chunk_step_plain, q, kv, kv, acc, row, row, pos, 0, scale=0.1,
            causal=True, k_limit=128, masked=masked, **modes) for masked in (False, True)}
        epi = trace_summary(cta_epilogue_plain, acc, row, div_mode=modes["div_mode"])
        assert step[True]["dot_flops"] == step[False]["dot_flops"] == 4 * 128 ** 3
        assert step[True]["ew_flops"] > step[False]["ew_flops"] > 0

        def total(key):
            return ((visited - hidden) * step[False][key] + hidden * step[True][key]
                    + heads * n * epi[key])
        compute = (total("dot_flops") / PEAK_FLOPS + total("ew_flops") / FP32_OPS
                   + (visited * 2 * 128 * 128 * 2 if stage else 0) / HBM_BW)
        t = max(compute, compulsory / HBM_BW) + LAUNCH_S
        sv = Scorer(suite=[cfg], check_correctness=False, fidelity=HLO,
                    device="cpu")(g)
        assert sv.values[0] == useful_flops(cfg) / t / 1e12


def test_rung1_score_batch_equals_the_scalar_path():
    scorer = Scorer(suite=_suite(), fidelity=HLO, device="cpu")
    genomes = _slate(4)
    set_batch_scoring(True)
    try:
        batch = scorer.score_batch(genomes)
    finally:
        set_batch_scoring(False)
    scalar = [scorer.score_uncached(g) for g in genomes]
    assert [(s.values, s.correct, s.failure) for s in batch] == \
        [(s.values, s.correct, s.failure) for s in scalar]
    assert scorer.n_evaluations == 2 * len(genomes)


def test_fidelity_keys_never_alias():
    cache = ScoreCache()
    g = T.seed_genome()
    svs = {fid: Scorer(suite=_suite(), check_correctness=False, cache=cache,
                       fidelity=fid, device="cpu")(g) for fid in (PERFMODEL, HLO)}
    assert svs[PERFMODEL].values != svs[HLO].values
    stats = cache.stats()
    assert stats["per_fidelity"] == {PERFMODEL: 1, HLO: 1}
    assert stats["misses"] == 2 and stats["hits"] == 0
    Scorer(suite=_suite(), check_correctness=False, cache=cache, fidelity=HLO,
           device="cpu")(g)                           # a hit, no re-trace
    assert cache.stats()["hits"] == 1
    assert fidelity_key(g.key(), HLO).startswith("hlo::")


def _fidelity_pair(name):
    """(rung 0, rung 1, finalizers) sharing ONE cache on backend ``name``."""
    spec = EvalSpec.resolve(_suite(), check_correctness=False, device="cpu")
    cache = ScoreCache()
    if name == "thread":
        mk = lambda s: make_backend("thread", suite=s, cache=cache,  # noqa: E731
                                    max_workers=2)
        return mk(spec), mk(spec.with_fidelity(HLO)), []
    if name == "process":
        pool = cf.ThreadPoolExecutor(max_workers=2)
        b0 = ProcessBackend(spec=spec, executor=pool, cache=cache)
        b1 = ProcessBackend(spec=spec.with_fidelity(HLO), executor=pool,
                            cache=cache)
        return b0, b1, [lambda: pool.shutdown(wait=True)]
    if name == "service":
        b0 = ServiceBackend(spec=spec, workers=0, cache=cache)
        b1 = ServiceBackend(spec=spec.with_fidelity(HLO),
                            coordinator=b0.coordinator, cache=cache)
        w = EvalServiceWorker(*b0.address, slots=2, name="cascade-test",
                              device="cpu")
        t = threading.Thread(target=w.run, daemon=True)
        t.start()
        assert b0.coordinator.wait_for_workers(1, timeout=10)
        return b0, b1, [w.stop, lambda: t.join(5)]
    raise AssertionError(name)


@pytest.mark.parametrize("name", ("thread", "process", "service"))
def test_rungs_0_and_1_never_alias_under_concurrent_submit_map(name):
    b0, b1, finalizers = _fidelity_pair(name)
    try:
        genomes = _slate(3)
        with cf.ThreadPoolExecutor(max_workers=4) as racers:
            f0 = racers.submit(b0.map, genomes)
            f1 = racers.submit(b1.map, genomes)
            extra = [racers.submit(b.submit, g).result()
                     for b in (b0, b1) for g in genomes]
            svs0, svs1 = f0.result(timeout=120), f1.result(timeout=120)
            for f in extra:
                f.result(timeout=120)
        assert [sv.values for sv in svs0] != [sv.values for sv in svs1]
        cache = b0.cache
        assert cache is b1.cache
        assert cache.stats()["per_fidelity"] == {PERFMODEL: len(genomes),
                                                 HLO: len(genomes)}
        for g, sv in zip(genomes, svs1):
            assert cache.peek(b0.score_key(g)) is not None
            assert cache.peek(b1.score_key(g)).values == sv.values
    finally:
        b1.close()
        b0.close()
        for fin in finalizers:
            fin()


def test_ladder_rung_specs_and_the_registered_factory():
    cpu = EvalSpec.resolve(_suite(), check_correctness=False, device="cpu")
    card = EvalSpec.resolve(_suite(), check_correctness=False)
    assert ladder(cpu) == (PERFMODEL, HLO) and ladder(card) == FIDELITIES
    assert rung_spec(card, MEASURED).machine == "h100"
    assert rung_spec(cpu, HLO) == cpu.with_fidelity(HLO)
    casc = make_backend("cascade", suite=cpu)
    try:
        assert [r.fidelity for r in casc.rungs] == [PERFMODEL, HLO]
        assert casc.rungs[0].cache is casc.rungs[1].cache
        assert casc.eta == DEFAULT_ETA
    finally:
        casc.close()


# -- CascadeBackend --------------------------------------------------------------


def _sv(pkg, values, bottleneck):
    """A ScoreVector of ``pkg`` whose profiles make ``bottleneck`` dominant."""
    perfmodel = importlib.import_module(pkg.__name__ + ".perfmodel")
    terms = dict.fromkeys(("t_mxu", "t_vpu_exposed", "t_dma_exposed",
                           "t_overhead", "t_bubble"), 0.1)
    terms[{"mxu": "t_mxu", "vpu": "t_vpu_exposed", "dma": "t_dma_exposed",
           "overhead": "t_overhead"}[bottleneck]] = 1.0
    names = tuple(n for n, *_ in FAST)
    profiles = {n: perfmodel.Profile(tflops=v, total_s=1.0, vmem_bytes=0,
                                     feasible=True, **terms)
                for n, v in zip(names, values)}
    return pkg.ScoreVector(names, tuple(values), True, "", profiles)


class _Table:
    """A rung that answers from a table: ``key -> (values, bottleneck)``."""

    def __init__(self, pkg, rows):
        self.pkg, self.rows, self.asked = pkg, rows, []

    def map(self, genomes):
        self.asked += [g.key() for g in genomes]
        return [_sv(self.pkg, *self.rows[g.key()]) for g in genomes]

    def close(self):
        pass


def _tables(genomes, seed=7):
    """Three rungs of rows for ``genomes``: rung 0 drawn per genome with a
    bottleneck class, rung 1 a noisy copy, rung 2 rung 0 scaled per class."""
    rng = np.random.default_rng(seed)
    classes = ("mxu", "dma", "vpu", "overhead")
    factor = dict(zip(classes, (0.6, 1.4, 0.9, 2.0)))
    rows = [{}, {}, {}]
    for g in genomes:
        v0 = tuple(float(x) for x in rng.uniform(50, 500, len(FAST)))
        cls = classes[int(rng.integers(len(classes)))]
        rows[0][g.key()] = (v0, cls)
        rows[1][g.key()] = (tuple(v * float(rng.uniform(0.5, 1.5)) for v in v0), cls)
        rows[2][g.key()] = (tuple(v * factor[cls] * float(rng.uniform(0.8, 1.2))
                                  for v in v0), cls)
    return rows


def _inline(fid, cache=None):
    return make_backend("inline", suite=_suite(), check_correctness=False,
                        device="cpu", fidelity=fid, cache=cache)


def test_cascade_promotes_at_most_one_over_eta_per_rung():
    """Real rungs 0 and 1 on the CPU, a table for the card's rung 2."""
    slate, cache = _slate(7), ScoreCache()
    rung2 = _Table(T, _tables(slate)[2])
    casc = CascadeBackend([_inline(PERFMODEL, cache), _inline(HLO, cache),
                           rung2], eta=3)
    log = casc.run_cascade(slate)
    assert log["evals"] == {PERFMODEL: 7, HLO: 7 // 3, MEASURED: 1}
    assert log["promoted"][MEASURED][0] in log["promoted"][HLO]
    assert rung2.asked == log["promoted"][MEASURED]
    assert casc.calibration.observations == 1
    assert casc.cache.stats()["per_fidelity"] == {PERFMODEL: 7, HLO: 2}


def test_cascade_promotion_disabled_is_rung0_only():
    cache = ScoreCache()
    casc = CascadeBackend([_inline(PERFMODEL, cache), _inline(HLO, cache)], eta=2)
    log = casc.run_cascade(_slate(6), promote=False)
    assert log["evals"] == {PERFMODEL: 6, HLO: 0, MEASURED: 0}
    assert casc.cache.stats()["per_fidelity"] == {PERFMODEL: 6}
    assert casc.calibration.observations == 0


def test_cascade_dedups_slate_and_handles_empty():
    casc = CascadeBackend([_inline(PERFMODEL), _inline(HLO)], eta=2)
    g = T.seed_genome()
    assert casc.run_cascade([g, g, g])["slate"] == 1
    assert casc.run_cascade([])["slate"] == 0


def test_cascade_rejects_bad_shape():
    with pytest.raises(ValueError, match="at least"):
        CascadeBackend([], eta=2)
    with pytest.raises(ValueError, match="eta"):
        CascadeBackend([_inline(PERFMODEL)], eta=1)
    with pytest.raises(ValueError, match="at most"):
        CascadeBackend([_inline(PERFMODEL)] * 4, eta=2)


def test_cascade_delegates_backend_surface_to_rung0():
    rungs = [_inline(PERFMODEL), _inline(HLO)]
    casc = CascadeBackend(rungs, eta=2)
    g = T.seed_genome()
    assert casc.suite == rungs[0].suite
    assert casc(g).values == rungs[0](g).values
    assert casc.score_key(g) == rungs[0].score_key(g)
    assert [sv.values for sv in casc.map([g])] == [casc(g).values]
    assert casc.submit(g).result().values == casc(g).values
    assert casc.baselines() == rungs[0].baselines()
    assert casc.n_evaluations == 1 and casc.cache_hits == rungs[0].cache_hits


def _genomes(pkg, n, seed):
    space = [g.kernel_kwargs() for g in full_space()]
    pick = np.random.default_rng(seed).choice(len(space), n, replace=False)
    return [pkg.KernelGenome(**space[i]) for i in pick]


def test_logs_and_calibration_equal_jax_on_identical_rung_tables():
    """Four slates of 9 over one pool, three table rungs: the port's and the
    reference's CascadeBackend promote the same keys and calibrate alike."""
    pool = {pkg: _genomes(pkg, 20, seed=3) for pkg in (T, J)}
    assert [g.key() for g in pool[T]] == [g.key() for g in pool[J]]
    rows = _tables(pool[T])
    rng = np.random.default_rng(5)
    slates = [rng.choice(20, 9, replace=False) for _ in range(4)]
    out = {}
    for pkg, cls in ((T, CascadeBackend), (J, JaxCascadeBackend)):
        casc = cls([_Table(pkg, r) for r in rows], eta=3)
        logs = [casc.run_cascade([pool[pkg][i] for i in s]) for s in slates]
        out[pkg] = (logs, casc.calibration.state())
    assert out[T] == out[J]
    logs, state = out[T]
    assert all(log["evals"] == {PERFMODEL: 9, HLO: 3, MEASURED: 1} for log in logs)
    assert state["observations"] == 4 and len(state["factors"]) > 1


def test_real_rung0_promotes_the_reference_keys_to_rung1():
    """Rung 0 on the TPU v5e model in both packages: the calibrated ranking
    sends the same genomes to rung 1 (a table in both, so only rung 0
    decides)."""
    promoted = {}
    for pkg in (T, J):
        genomes = _genomes(pkg, 9, seed=11)
        rung0 = (_inline(PERFMODEL) if pkg is T else
                 J.make_backend("inline", suite=_suite(J), check_correctness=False))
        casc = (CascadeBackend if pkg is T else JaxCascadeBackend)(
            [rung0, _Table(pkg, _tables(genomes)[1])], eta=3)
        promoted[pkg] = casc.run_cascade(genomes)["promoted"][HLO]
    assert promoted[T] == promoted[J] and len(promoted[T]) == 3


# -- the engine ------------------------------------------------------------------


def _engine(pkg, **kw):
    cfg = dict(n_islands=2, suite=_suite(pkg), migration_interval=2, seed=11,
               backend="thread", check_correctness=False)
    cfg.update(kw)
    if pkg is T:
        cfg.setdefault("device", "cpu")
    return pkg.IslandEvolution(config=pkg.EngineConfig.from_kwargs(**cfg))


def _fingerprints(pkg=T, steps=STEPS, **kw):
    eng = _engine(pkg, **kw)
    try:
        eng.run(max_steps=steps)
    finally:
        eng.close()
    return [[(c.genome.key(), round(c.geomean, 9), c.note)
             for c in i.lineage.commits] for i in eng.islands], eng


def test_engine_lineages_equal_with_cascade_and_equal_to_jax():
    """The cascade — promotion off or on — reproduces the cascade-free
    engine's lineages, and the JAX package's cascade-free lineages."""
    base, _ = _fingerprints()
    off, _ = _fingerprints(cascade_eta=2, cascade_promote=False)
    on, eng = _fingerprints(cascade_eta=2, cascade_slate=3)
    jax_base, _ = _fingerprints(J)
    assert base == off == on == jax_base
    assert sum(len(v) for v in base) > len(base)       # the search moved
    totals = eng.cascade_totals()
    assert totals["epochs"] == 2 * (STEPS // 2)
    assert totals["evals"][HLO] > 0 and totals["evals"][MEASURED] == 0


def test_engine_cascade_report_and_promote_fractions():
    _, eng = _fingerprints(cascade_eta=2, cascade_slate=4)
    assert eng.cascade_log
    for entry in eng.cascade_log:
        n0, n1, n2 = (entry["evals"][f] for f in FIDELITIES)
        assert 0 < n1 <= max(1, n0 // 2) and n2 == 0
    rep = eng.run(max_steps=0)                         # report-only call
    assert rep.cascade["eta"] == 2
    stats = rep.score_caches["default"]["per_fidelity"]
    assert stats[PERFMODEL] > 0 and stats[HLO] > 0


def test_cascade_kill_resume_replays_the_promotion_log(tmp_path):
    """A killed run resumed from its file makes the promotions of an
    uninterrupted run: the slate is a function of persisted state, and on
    the CPU (rungs 0-1) nothing is timed."""
    kw = dict(cascade_eta=2, cascade_slate=3)
    _, solid = _fingerprints(steps=8, **kw)
    path = str(tmp_path / "arch.json")
    first = _engine(T, persist_path=path, **kw)
    try:
        first.run(max_steps=4)
    finally:
        first.close()
    resumed = T.IslandEvolution.resume(path)
    try:
        resumed.run(max_steps=4)
    finally:
        resumed.close()
    strip = lambda log: [  # noqa: E731
        {k: e[k] for k in ("epoch", "island", "evals", "promoted")} for e in log]
    assert strip(resumed.cascade_log) == strip(solid.cascade_log)
    assert resumed.calibration.state() == solid.calibration.state()
    assert [[c.genome.key() for c in i.lineage.commits] for i in resumed.islands] \
        == [[c.genome.key() for c in i.lineage.commits] for i in solid.islands]


def test_engine_rejects_bad_cascade_params():
    with pytest.raises(ValueError, match="cascade_eta"):
        _engine(T, cascade_eta=1)
    with pytest.raises(ValueError, match="cascade_slate"):
        _engine(T, cascade_eta=2, cascade_slate=0)
