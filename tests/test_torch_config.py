"""The port's engine configuration against the JAX package's: the payload
of equivalent configs equal apart from the port's two fields (``device``,
``machine``), the legacy flat kwargs equal to the config object, one
deprecation warning per alias, and a kwarg-persisted run resumed from its
payload alone."""
import json
import warnings

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch

from repro.core import config as jax_config
from repro.core import islands as jax_islands
from repro.core import search_space as jax_search_space
from repro.core.perfmodel import BenchConfig as JaxBenchConfig
from repro_torch.core import config
from repro_torch.core.config import (EngineConfig, EvalConfig,
                                     MigrationConfig,
                                     engine_config_from_legacy,
                                     reset_deprecation_warnings)
from repro_torch.core.islands import IslandEvolution, IslandSpec
from repro_torch.core.perfmodel import BenchConfig

FAST = [("c4k", 8, 16, 16, 4096, True), ("n4k", 8, 16, 16, 4096, False)]
FAST_SUITE = [BenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST]
PORT_ONLY = ("device", "machine")


def _flat(suite_cls, genome_mod, spec_cls):
    """One set of flat kwargs, built from either package's classes."""
    return [
        dict(n_islands=2, seed=5, check_correctness=False),
        dict(n_islands=3, seed=9, prefetch=2, pipeline=True,
             suite=[suite_cls(n, b, h, kv, s, causal=c)
                    for n, b, h, kv, s, c in FAST],
             backend="process", elastic_workers=4, cascade_eta=3,
             topology="star", migration_interval=3, migrant_policy="top-k",
             migrant_k=2, prefetch_budget=6, max_workers=2),
        dict(specs=[spec_cls(name="a", operator="avo",
                             init_genome=genome_mod.seed_genome().with_(block_q=256)),
                    spec_cls(name="b", operator="single-shot",
                             target_suite="decode")],
             backend="service", service_workers=1,
             service_listen="0.0.0.0:5123", supervisor_patience=5,
             persist_path="results/arch.json")]


@pytest.mark.parametrize("case", range(3))
def test_payload_equals_jax_apart_from_device_and_machine(case):
    from repro_torch.core import search_space
    ours = EngineConfig.from_kwargs(**_flat(BenchConfig, search_space, IslandSpec)[case])
    theirs = jax_config.EngineConfig.from_kwargs(
        **_flat(JaxBenchConfig, jax_search_space, jax_islands.IslandSpec)[case])
    got, want = ours.to_payload(), theirs.to_payload()
    assert {k: got["evals"].pop(k) for k in PORT_ONLY} == \
        dict.fromkeys(PORT_ONLY)
    assert got == want
    json.dumps(got)
    # the reference's payload loads in the port (device and machine default)
    back = EngineConfig.from_payload(json.loads(json.dumps(want)))
    assert back.evals.device is None and back.evals.machine is None
    assert back.to_payload() == ours.to_payload()


def test_device_and_machine_persist_as_strings():
    cfg = EngineConfig(evals=EvalConfig(device=torch.device("cpu"),
                                        machine="h100"),
                       specs=[IslandSpec(name="a"), IslandSpec(name="b")])
    payload = json.loads(json.dumps(cfg.to_payload()))
    assert payload["evals"]["device"] == "cpu"
    assert payload["evals"]["machine"] == "h100"
    back = EngineConfig.from_payload(payload)
    assert (back.evals.device, back.evals.machine) == ("cpu", "h100")
    assert [s.name for s in back.specs] == ["a", "b"]


def test_runtime_only_fields_never_persist():
    payload = EngineConfig(evals=EvalConfig(coordinator=object(),
                                            tenant="job-1")).to_payload()
    assert "coordinator" not in payload["evals"]
    assert "tenant" not in payload["evals"]
    json.dumps(payload)


def test_legacy_kwargs_equal_the_config_object():
    """The flat spelling and the config object build the same config, and
    the same engine commits the same lineages through either."""
    flat = dict(n_islands=2, suite=FAST_SUITE, migration_interval=2, seed=5,
                check_correctness=False, device="cpu", machine="h100",
                topology="adaptive")
    cfg = EngineConfig(
        n_islands=2, suite=FAST_SUITE, seed=5,
        evals=EvalConfig(check_correctness=False, device="cpu",
                         machine="h100"),
        migration=MigrationConfig(topology="adaptive", interval=2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert engine_config_from_legacy(dict(flat)) == cfg
        legacy = IslandEvolution(**flat)
    assert EngineConfig.from_kwargs(**flat) == cfg
    configured = IslandEvolution(config=cfg)
    fps = []
    for eng in (legacy, configured):
        try:
            eng.run(max_steps=4)
            fps.append({i.name: [(c.genome.key(), round(c.geomean, 9), c.note)
                                 for c in i.lineage.commits] for i in eng.islands})
            assert eng.machine == "h100"
            assert all(s.plan_machine == "h100" for s in eng.scorers.values())
        finally:
            eng.close()
    assert fps[0] == fps[1] and any(fps[0].values())


def test_config_and_legacy_kwargs_are_mutually_exclusive_and_checked():
    with pytest.raises(TypeError, match="not both"):
        IslandEvolution(config=EngineConfig(), n_islands=2)
    with pytest.raises(TypeError, match="unknown IslandEvolution arguments"):
        engine_config_from_legacy({"n_isles": 2})
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        cfg = EngineConfig.from_kwargs(backend="thread", topology="star",
                                       n_islands=3, migrant_k=2, device="cpu",
                                       machine="h100")
    assert (cfg.evals.device, cfg.evals.machine) == ("cpu", "h100")
    assert set(config._LEGACY_MAP) - set(jax_config._LEGACY_MAP) == set(PORT_ONLY)


@pytest.mark.parametrize("alias,dest", [
    ("n_islands", "EngineConfig.n_islands"),
    ("migration_interval", "EngineConfig.migration.interval"),
    ("device", "EngineConfig.evals.device"),
    ("machine", "EngineConfig.evals.machine"),
])
def test_deprecation_fires_exactly_once_per_alias(alias, dest):
    value = {"n_islands": 2, "migration_interval": 8, "device": "cpu",
             "machine": "h100"}[alias]
    reset_deprecation_warnings()
    with pytest.deprecated_call(match=dest.replace(".", r"\.")):
        engine_config_from_legacy({alias: value})
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        engine_config_from_legacy({alias: value})
    # another alias still fires once
    with pytest.deprecated_call(match="seed"):
        engine_config_from_legacy({alias: value, "seed": 1})


def test_kwarg_persisted_run_resumes_under_config_path(tmp_path):
    path = str(tmp_path / "arch.json")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        engine = IslandEvolution(persist_path=path, n_islands=2,
                                 suite=FAST_SUITE, migration_interval=2,
                                 seed=5, check_correctness=False,
                                 device="cpu", machine="h100")
    try:
        engine.run(max_steps=4)
        fp = [list(i.lineage.commits) for i in engine.islands]
    finally:
        engine.close()
    resumed = IslandEvolution.resume(path)     # no kwargs: config from payload
    try:
        assert resumed.config.evals.device == "cpu"
        assert resumed.config.evals.machine == resumed.machine == "h100"
        assert resumed.config.migration.interval == 2
        assert resumed.config.suite == FAST_SUITE
        assert [list(i.lineage.commits) for i in resumed.islands] == fp
    finally:
        resumed.close()
