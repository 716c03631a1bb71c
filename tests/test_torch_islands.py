"""The port's island engine against the JAX package's, on the CPU: the same
seed and configuration give the same per-island lineages (fingerprints
``(genome key, round(geomean, 9), note)``) and the same migration ledger —
over topologies, migrant policies, barrier and pipelined stepping,
``scenario_specs()`` and the inline, thread, process and service backends —
and the port's persistence resumes a killed run exactly.  Also: the
refused cascade, and no history adopted from another rung-0 machine.

Rung 0 runs on the reference's TPU v5e model in both packages, with batch
scoring off in both (scalar and columnar rung 0 differ by an ulp on some
hosts).  The port scores with ``device="cpu"`` (the gate runs the kernel's
plain version); worker processes are spawned, 2 at most."""
import importlib
import json
import os
import random

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

import repro.core as J
import repro_torch.core as T
from repro.core.evals.scorer import set_batch_scoring as jax_set_batch_scoring
from repro_torch.core.evals import BatchScorer, Scorer, set_batch_scoring
from repro_torch.core.islands import EpochMemoryView, Island
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.knowledge_h100 import HOPPER_FACTS
from repro_torch.core.population import Lineage

FAST = [("c4k", 8, 16, 16, 4096, True), ("n4k", 8, 16, 16, 4096, False)]
BASE = dict(n_islands=3, migration_interval=2, seed=11)
STEPS = 6
WORKERS = 2


@pytest.fixture(autouse=True, scope="module")
def _scalar_rung0():
    jax_set_batch_scoring(False)
    set_batch_scoring(False)
    yield
    jax_set_batch_scoring(True)
    set_batch_scoring(True)


def _suite(pkg):
    return [pkg.BenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST]


def _fp(eng) -> dict:
    return {i.name: [(c.genome.key(), round(c.geomean, 9), c.note)
                     for c in i.lineage.commits] for i in eng.islands}


def _ledger(eng) -> tuple:
    return eng.migration_stats.to_payload(), eng.migrations_accepted


def _engine(pkg, scenario=False, **kw):
    cfg = dict(BASE, **({"specs": pkg.scenario_specs()} if scenario
                        else {"suite": _suite(pkg)}))
    cfg.update(kw)
    if pkg is T:
        cfg.setdefault("device", "cpu")
    return pkg.IslandEvolution(config=pkg.EngineConfig.from_kwargs(**cfg))


def _run(pkg, steps=STEPS, **kw):
    eng = _engine(pkg, **kw)
    try:
        rep = eng.run(max_steps=steps)
    finally:
        eng.close()
    return eng, rep


_JAX_RUNS: dict = {}


def _jax(steps=STEPS, **kw) -> tuple:
    """(fingerprints, migration ledger) of the JAX package's engine, run
    once per configuration in this module."""
    key = (steps, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        eng, _ = _run(J, steps=steps, **kw)
        _JAX_RUNS[key] = (_fp(eng), _ledger(eng))
    return _JAX_RUNS[key]


def _assert_equals_jax(eng, steps=STEPS, **kw):
    fp, ledger = _jax(steps=steps, **kw)
    assert _fp(eng) == fp
    assert _ledger(eng) == ledger
    assert sum(len(v) for v in fp.values()) > len(fp)     # the search moved


# -- the engine: determinism, topologies, migrant policies -----------------------


@pytest.mark.parametrize("topology", ["ring", "star", "adaptive"])
def test_islands_deterministic_and_equal_to_jax(topology):
    kw = {} if topology == "ring" else {"topology": topology}
    a, rep = _run(T, **kw)
    b, _ = _run(T, **kw)
    assert _fp(a) == _fp(b) and _ledger(a) == _ledger(b)
    _assert_equals_jax(a, **kw)
    # migration copies commits, never removes them
    assert rep.best_geomean == max(i.best_geomean() for i in a.islands) > 0
    assert rep.cascade == {} and a.cascade_totals() == {}


@pytest.mark.parametrize("policy,k,same_as", [
    ("best", 3, {}), ("top-k", 1, {}),
    ("top-k", 3, {"migrant_policy": "top-k", "migrant_k": 3})])
def test_migrant_policies_equal_to_jax(policy, k, same_as):
    """'best' is the default; 'top-k' with k=1 donates the same single
    commit, so both equal the default run; k=3 equals the reference's."""
    eng, _ = _run(T, migrant_policy=policy, migrant_k=k)
    _assert_equals_jax(eng, **same_as)


def test_migrant_policy_validation():
    for kw, match in (({"migrant_policy": "diversity"}, "unknown migrant_policy"),
                      ({"migrant_policy": "top-k", "migrant_k": 0}, "migrant_k")):
        with pytest.raises(ValueError, match=match):
            _engine(T, n_islands=2, **kw)


def _island_pair(pkg, donor_suite, recipient_suite):
    kw = {"device": "cpu"} if pkg is T else {}
    evals = importlib.import_module(pkg.__name__ + ".evals")
    sc = [evals.BatchScorer(pkg.Scorer(suite=s, check_correctness=False, **kw))
          for s in (donor_suite, recipient_suite)]
    return sc, pkg.Island("donor", sc[0]), pkg.Island("recipient", sc[1])


def _strict_improvement(pkg):
    sc, strong, weak = _island_pair(pkg, _suite(pkg), _suite(pkg))
    g_good = pkg.KernelGenome(block_q=512, block_k=1024, rescale_mode="branchless",
                              mask_mode="block_skip", div_mode="deferred",
                              kv_in_grid=True)
    strong.lineage.update(g_good, sc[0](g_good), "hand-planted best")
    weak.lineage.update(pkg.seed_genome(), sc[1](pkg.seed_genome()), "seed")
    verdicts = [weak.accept_migrant(strong.lineage.best(), "strong"),
                weak.accept_migrant(strong.lineage.best(), "strong"),
                strong.accept_migrant(weak.lineage.commits[0], "weak")]
    for s in sc:
        s.close()
    return verdicts, [(c.genome.key(), c.geomean, c.note) for c in weak.lineage.commits]


def _cross_suite(pkg, top_k):
    """A donor evolved on mha donates to a decode island: one commit, or
    its top 2 (the recipient re-scores every one on its own suite)."""
    sc, donor, recipient = _island_pair(pkg, pkg.suite_by_name("mha"),
                                        pkg.suite_by_name("decode"))
    g_a = pkg.KernelGenome(block_q=256, block_k=512, rescale_mode="branchless",
                           mask_mode="block_skip", kv_in_grid=True)
    g_b = pkg.seed_genome().with_(block_q=64, block_k=256, kv_in_grid=True)
    for g, note in ((g_a, "donor A"), (g_b, "donor B"))[:1 + top_k]:
        donor.lineage.update(g, sc[0](g), note)
    donated = donor.lineage.top(2) if top_k else [donor.lineage.best()]
    verdicts = [recipient.accept_migrants(donated, "mha"),
                recipient.accept_migrants(donated, "mha")]
    b = recipient.lineage.best()
    out = (verdicts, b.genome.key(), b.values, len(b.values),
           max(sc[1](c.genome).geomean for c in donated) == b.geomean)
    for s in sc:
        s.close()
    return out


def test_migrant_adopted_only_on_strict_improvement():
    ours = _strict_improvement(T)
    assert ours[0] == [True, False, False]
    assert ours == _strict_improvement(J)


@pytest.mark.parametrize("top_k", [0, 1])
def test_cross_suite_rescoring_and_top_k_migrants(top_k):
    """Values come from the recipient's suite, the best survivor is
    adopted, and a re-offer is refused — as in the JAX package."""
    ours = _cross_suite(T, top_k)
    assert ours[0] == [True, False]
    assert ours[3] == len(T.suite_by_name("decode")) and ours[4]
    assert ours == _cross_suite(J, top_k)


# -- speculation: prefetch and pipelined stepping --------------------------------


def test_prefetch_is_pure_cache_warming():
    eng, rep = _run(T, prefetch=4)
    assert rep.cache_hits > 0
    _assert_equals_jax(eng)


@pytest.mark.parametrize("budget", [None, 4])
def test_pipelined_equals_barrier_and_budget_respected(budget):
    eng, rep = _run(T, pipeline=True, prefetch_budget=budget)
    assert rep.proposed > 0 and rep.eval_workers
    if budget is not None:
        assert sum(isl.prefetch_k for isl in eng.islands) <= budget
    _assert_equals_jax(eng)


def test_prefetch_allocator_equals_jax():
    rng = random.Random(5)
    for total in (1, 4, 16):
        profiles = {f"i{n}": sorted((rng.random() for _ in range(rng.randrange(6))),
                                    reverse=True) for n in range(5)}
        ours = T.PrefetchAllocator(total).allocate(profiles)
        assert ours == J.PrefetchAllocator(total).allocate(profiles)
        assert sum(ours.values()) <= max(total, len(profiles))
    with pytest.raises(ValueError, match="prefetch budget"):
        T.PrefetchAllocator(0)


# -- backends ----------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["inline", "thread", "process", "service"])
def test_lineages_identical_through_backends_and_to_jax(backend):
    """Every backend, spawned workers for process and service (2 each, on
    the CPU), commits the JAX package's lineages."""
    kw = {"process": {"max_workers": WORKERS},
          "service": {"service_workers": WORKERS}}.get(backend, {})
    eng, rep = _run(T, backend=backend, **kw)
    _assert_equals_jax(eng)
    if backend in ("process", "service"):
        assert rep.eval_pool or backend == "process"
        assert all(getattr(s, "max_workers", WORKERS) == WORKERS
                   for s in eng.scorers.values())


def test_card_spec_without_a_card_raises():
    """No CUDA device here: an engine left on the card raises rather than
    scoring on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _engine(T, device=None)


# -- scenario specs and the registry ----------------------------------------------


def test_scenario_specs_equal_jax():
    ours, theirs = T.scenario_specs(), J.scenario_specs()
    assert [(s.name, s.operator, s.target_suite, s.agent_kwargs) for s in ours] == \
        [(s.name, s.operator, s.target_suite, s.agent_kwargs) for s in theirs]
    assert [s.init_genome and s.init_genome.to_edits() for s in ours] == \
        [s.init_genome and s.init_genome.to_edits() for s in theirs]
    eng, rep = _run(T, scenario=True, steps=4)
    assert eng.scorers["mha"] is eng.islands[3].scorer is not eng.scorers["gqa"]
    assert len(rep.score_caches) == 3
    _assert_equals_jax(eng, scenario=True, steps=4)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_from_registry_equals_jax_and_takes_new_suites():
    kw = dict(topology="star", seed=2)
    ours = T.IslandEvolution.from_registry(suites=("mha", "decode"), device="cpu",
                                           **kw)
    theirs = J.IslandEvolution.from_registry(suites=("mha", "decode"), **kw)
    try:
        assert ours.topology.name == "star"
        assert [i.name for i in ours.islands] == ["mha", "decode"]
        ours.run(max_steps=2)
        theirs.run(max_steps=2)
        assert _fp(ours) == _fp(theirs) and _ledger(ours) == _ledger(theirs)
    finally:
        ours.close()
        theirs.close()
    T.register_suite("tiny", lambda: _suite(T))
    try:
        eng = T.IslandEvolution.from_registry(suites=["tiny"], device="cpu",
                                              check_correctness=False)
        try:
            assert eng.run(max_steps=2).commits > 0
        finally:
            eng.close()
    finally:
        T.unregister_suite("tiny")


# -- persistence and resume --------------------------------------------------------


def test_save_load_round_trip_and_per_island_files(tmp_path):
    p = str(tmp_path / "arch.json")
    eng, _ = _run(T, persist_path=p)
    with open(p) as f:
        payload = json.load(f)
    assert payload["format"] == "archipelago.v1"
    assert payload["machine"] == "tpu_v5e" and payload["cascade"] == {}
    assert len(payload["islands"]) == len(eng.islands)
    for isl in eng.islands:
        ln = Lineage.load(str(tmp_path / f"arch.{isl.name}.json"))
        assert [c.genome.key() for c in ln.commits] == \
            [c.genome.key() for c in isl.lineage.commits]
    fresh = _engine(T, persist_path=p)
    try:
        fresh.load_state(p)
        assert _fp(fresh) == _fp(eng) and _ledger(fresh) == _ledger(eng)
        assert {i.name: i.supervisor.state() for i in fresh.islands} == \
            {i.name: i.supervisor.state() for i in eng.islands}
        assert fresh.memory.to_payload() == eng.memory.to_payload()
        mem = eng.memory.to_payload()
        if mem:   # the epoch views see restored refutations at once
            entry = (mem[0][0], tuple(tuple(pair) for pair in mem[0][1]))
            assert entry in fresh.islands[0].tools.memory_refuted
    finally:
        fresh.close()
    _assert_equals_jax(eng)


@pytest.mark.parametrize("topology", ["ring", "adaptive"])
def test_killed_run_resumes_identically(tmp_path, topology):
    """Killed after 4 steps and resumed for 2: the same lineages, ledger
    and topology state as an uninterrupted 6-step run, and as the JAX
    package's."""
    kw = {} if topology == "ring" else {"topology": topology}
    full, _ = _run(T, **kw)
    p = str(tmp_path / "arch.json")
    _run(T, steps=4, persist_path=p, **kw)                    # "kill"
    resumed = T.IslandEvolution.resume(p)                     # config from payload
    try:
        resumed.run(max_steps=STEPS - 4)
        assert _fp(resumed) == _fp(full) and _ledger(resumed) == _ledger(full)
        assert resumed.topology.state() == full.topology.state()
    finally:
        resumed.close()
    _assert_equals_jax(resumed, **kw)


def test_resume_prefers_fresher_per_island_file(tmp_path):
    p = str(tmp_path / "arch.json")
    eng, _ = _run(T, persist_path=p)
    victim = eng.islands[0]
    extended = Lineage.from_payload(victim.lineage.to_payload())
    g = T.seed_genome().with_(block_q=64, block_k=1024)
    extended.update(g, Scorer(suite=_suite(T), device="cpu")(g),
                    "post-barrier commit")
    extended.save(str(tmp_path / f"arch.{victim.name}.json"))
    resumed = T.IslandEvolution.resume(p)
    try:
        isl0 = resumed.islands[0]
        assert len(isl0.lineage) == len(victim.lineage) + 1
        assert isl0.lineage.commits[-1].note == "post-barrier commit"
    finally:
        resumed.close()


def test_resume_rejects_history_from_a_different_suite(tmp_path):
    p = str(tmp_path / "arch.json")
    _run(T, steps=2, specs=[T.IslandSpec(name="a", target_suite="mha")],
         persist_path=p, check_correctness=False)
    resumed = T.IslandEvolution.resume(
        p, config=T.EngineConfig.from_kwargs(
            specs=[T.IslandSpec(name="a", target_suite="decode")],
            migration_interval=2, seed=11, device="cpu"))
    try:
        assert len(resumed.islands[0].lineage) == 0
    finally:
        resumed.close()


def test_history_from_another_machine_is_not_adopted(tmp_path):
    """A payload scored under one rung-0 machine restores nothing into an
    engine of the other; the JAX package's payload (no machine: its TPU
    v5e model) loads into a tpu_v5e engine only."""
    p = str(tmp_path / "tpu.json")
    eng, _ = _run(T, steps=2, persist_path=p)
    h100 = _engine(T, machine="h100")
    try:
        h100.load_state(p)
        assert all(len(i.lineage) == 0 for i in h100.islands)
        assert h100.migrations_accepted == 0 and h100.memory.to_payload() == []
        assert all(i.kb.facts == HOPPER_FACTS for i in h100.islands)
    finally:
        h100.close()
    ref = str(tmp_path / "jax.json")
    theirs = _engine(J, persist_path=ref)
    try:
        theirs.run(max_steps=2)
    finally:
        theirs.close()
    for machine, adopted in (("tpu_v5e", True), ("h100", False)):
        ours = _engine(T, machine=machine)
        try:
            ours.load_state(ref)
            assert (_fp(ours) == _fp(theirs)) is adopted
            assert any(len(i.lineage) for i in ours.islands) is adopted
        finally:
            ours.close()
    assert _fp(theirs) == _fp(eng)
    assert all(i.kb.facts == KnowledgeBase().facts for i in eng.islands)


def test_cascade_is_refused_and_a_payload_cascade_kept(tmp_path):
    for build in (lambda: T.IslandEvolution(
                      config=T.EngineConfig(evals=T.EvalConfig(cascade_eta=3))),
                  lambda: _engine(T, cascade_eta=3)):
        with pytest.raises(NotImplementedError, match="item 6"):
            build()
    p = str(tmp_path / "arch.json")
    _run(T, steps=2, persist_path=p, check_correctness=False)
    with open(p) as f:
        payload = json.load(f)
    payload["cascade"] = {"calibration": {"factors": {"mxu": 1.5}}, "log": []}
    with open(p, "w") as f:
        json.dump(payload, f)
    eng = T.IslandEvolution.resume(p)
    try:
        rep = eng.run(max_steps=2)
        assert rep.cascade == {} and eng.cascade_totals() == {}
    finally:
        eng.close()
    with open(p) as f:
        assert json.load(f)["cascade"] == payload["cascade"]
    assert not any("cascade" in m for m in __import__("sys").modules
                   if m.startswith("repro_torch"))


# -- pieces ------------------------------------------------------------------------


def test_epoch_memory_view_isolates_until_publish():
    shared = T.RefutedMemory()
    a, b = EpochMemoryView(shared), EpochMemoryView(shared)
    a.add(("k", ("e",)), "note")
    assert ("k", ("e",)) in a and ("k", ("e",)) not in b
    a.publish()
    assert ("k", ("e",)) not in b
    b.publish()
    assert ("k", ("e",)) in b and len(shared) == 1


def test_coverage_dedupes_islands_sharing_a_suite():
    eng = _engine(T, specs=[T.IslandSpec(name="a"), T.IslandSpec(name="b")],
                  check_correctness=False)
    try:
        shared = eng.islands[0].scorer
        weak, strong = T.seed_genome(), T.KernelGenome(
            block_q=512, block_k=1024, rescale_mode="branchless",
            mask_mode="block_skip", div_mode="deferred", kv_in_grid=True)
        eng.islands[0].lineage.update(weak, shared(weak), "weak")
        eng.islands[1].lineage.update(strong, shared(strong), "strong")
        assert tuple(eng.coverage_values()) == shared(strong).values
    finally:
        eng.close()


def test_propose_is_pure_speculation():
    scorers = [BatchScorer(Scorer(suite=_suite(T), check_correctness=False,
                                  device="cpu")) for _ in range(2)]
    plain = Island("plain", scorers[0], operator=T.make_operator("avo"))
    specd = Island("specd", scorers[1], operator=T.make_operator("avo"))
    for _ in range(4):
        plain.step()
        specd.propose()
        specd.propose()
        specd.harvest()
    assert [c.genome.key() for c in plain.lineage.commits] == \
        [c.genome.key() for c in specd.lineage.commits]
    assert specd.proposed > 0
    specd.prefetch_cap = 0
    assert specd.propose() == 0
    for s in scorers:
        s.close()


# -- the CLI -------------------------------------------------------------------------


def test_cli_islands_resume_and_refusals(tmp_path, capsys):
    from repro_torch import evolve
    cli = ["--islands", "3", "--fidelity", "perfmodel", "--device", "cpu",
           "--max-steps", "4", "--out", str(tmp_path)]
    evolve.main(cli)
    path = tmp_path / "archipelago.json"
    first = {d["name"]: len(d["lineage"]["commits"])
             for d in json.loads(path.read_text())["islands"]}
    evolve.main(cli)
    again = {d["name"]: len(d["lineage"]["commits"])
             for d in json.loads(path.read_text())["islands"]}
    assert all(again[n] >= first[n] > 0 for n in first)
    out = capsys.readouterr().out
    assert "3 islands (island0, island1, island2" in out
    assert "migration acceptance per edge" in out
    assert "scenario coverage geomean" in out and "gates ran on cpu" in out
    assert os.path.exists(tmp_path / "archipelago.island0.json")
    with pytest.raises(ValueError, match="need at least one island"):
        evolve.main(["--islands", "-1", "--device", "cpu", "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        evolve.main(["--islands", "2", "--fidelity", "measured", "--out", str(tmp_path)])
    assert "item 6" in capsys.readouterr().err
