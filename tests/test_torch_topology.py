"""The port's migration topologies against the JAX package's: the edges of
every topology under a seeded MigrationStats history, the acceptance
ledger, and AdaptiveTopology's state round trip across the two packages;
then the topologies inside the port's island engine on the CPU."""
import random

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

from repro.core import topology as jax_topology
from repro_torch.core import topology
from repro_torch.core.config import EngineConfig
from repro_torch.core.islands import IslandEvolution
from repro_torch.core.perfmodel import BenchConfig

FAST_SUITE = [BenchConfig("c4k", 8, 16, 16, 4096, causal=True),
              BenchConfig("n4k", 8, 16, 16, 4096, causal=False)]
EPOCHS = 12


def _walk(mod, name, n, seed, epochs=EPOCHS, topo=None, stats=None, rng=None):
    """Drive one topology of package ``mod`` through ``epochs`` barriers of
    a seeded history: random island bests, a seeded accept / reject for
    every scheduled edge.  Returns (edges per epoch, stats payload, topology
    state, the topology, the stats)."""
    rng = rng if rng is not None else random.Random(seed)
    topo = topo if topo is not None else mod.make_topology(name, seed=seed)
    stats = stats if stats is not None else mod.MigrationStats()
    seq = []
    for _ in range(epochs):
        stats.island_best = [rng.uniform(10.0, 500.0) for _ in range(n)]
        edges = topo.edges(n, stats)
        seq.append(list(edges))
        for src, dst in edges:
            stats.record(src, dst, rng.random() < 0.3)
    return seq, stats.to_payload(), topo.state(), topo, stats


@pytest.mark.parametrize("name", ["ring", "star", "all-to-all", "adaptive"])
@pytest.mark.parametrize("n,seed", [(1, 0), (3, 11), (5, 7)])
def test_edges_under_seeded_history_equal_jax(name, n, seed):
    ours = _walk(topology, name, n, seed)
    theirs = _walk(jax_topology, name, n, seed)
    assert ours[:3] == theirs[:3]
    if n > 1:
        assert any(ours[0])
    else:
        assert all(e == [] for e in ours[0])          # never self-migrates


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_adaptive_state_round_trips_between_packages(direction):
    """Half a history in one package; its state and ledger loaded into the
    other, which must make the same decisions as the uninterrupted run."""
    src, dst = ((topology, jax_topology) if direction == "torch_to_jax"
                else (jax_topology, topology))
    full = _walk(src, "adaptive", 4, 3, epochs=2 * EPOCHS)
    rng = random.Random(3)
    _, stats_p, state, _, _ = _walk(src, "adaptive", 4, 3, rng=rng)
    resumed = dst.AdaptiveTopology(seed=3)
    resumed.load_state(state)
    assert resumed.state() == state
    stats = dst.MigrationStats.from_payload(stats_p)
    assert stats.to_payload() == stats_p
    seq, stats_p, state, _, _ = _walk(dst, "adaptive", 4, 3, topo=resumed,
                                      stats=stats, rng=rng)
    assert seq == full[0][EPOCHS:]
    assert (stats_p, state) == (full[1], full[2])


def test_explicit_topology_and_registry_equal_jax():
    edges = [(0, 1), (1, 1), (5, 0), (1, 2)]
    ours, theirs = topology.ExplicitTopology(edges), jax_topology.ExplicitTopology(edges)
    for t in (ours, theirs):
        t.remove_edge(0, 1)
        t.add_edge(2, 0)
    assert ours.edges(3, topology.MigrationStats()) == \
        theirs.edges(3, jax_topology.MigrationStats()) == [(1, 2), (2, 0)]
    assert ours.state() == theirs.state()
    assert topology.topology_names() == jax_topology.topology_names()
    assert sorted(topology.TOPOLOGIES) == sorted(jax_topology.TOPOLOGIES)
    assert topology.ring_edges(4) == jax_topology.ring_edges(4)
    inst = topology.ExplicitTopology([(0, 1)])
    assert topology.make_topology(inst) is inst
    with pytest.raises(ValueError):
        topology.make_topology("torus")


def test_migration_stats_ema_and_donor_quality_equal_jax():
    got = []
    for mod in (topology, jax_topology):
        s = mod.MigrationStats(alpha=0.5)
        for accepted in (True, False, False, True):
            s.record(0, 1, accepted)
        s.record(0, 2, False)
        got.append((s.ema((0, 1)), s.attempts((0, 1)), s.accepts((0, 1)),
                    s.donor_quality(0), s.donor_quality(3), s.to_payload()))
    assert got[0] == got[1]
    assert got[0][1:3] == (4, 2)


def test_star_hub_is_best_coverage_island():
    stats = topology.MigrationStats()
    stats.island_best = [10.0, 99.0, 50.0]
    assert topology.StarTopology.hub(3, stats) == 1
    assert topology.StarTopology().edges(3, stats) == [(0, 1), (2, 1), (1, 0), (1, 2)]
    assert topology.StarTopology.hub(3, topology.MigrationStats()) == 0


# -- inside the port's engine (CPU) ---------------------------------------------


def _engine(**kw):
    base = dict(n_islands=3, suite=FAST_SUITE, migration_interval=2, seed=11,
                device="cpu", check_correctness=False)
    base.update(kw)
    return IslandEvolution(config=EngineConfig.from_kwargs(**base))


@pytest.mark.parametrize("topo", ["ring", "star", "all-to-all", "adaptive"])
def test_single_island_archipelago_never_self_migrates(topo):
    eng = _engine(n_islands=1, topology=topo)
    try:
        rep = eng.run(max_steps=4)
        assert rep.commits > 0 and rep.migrations_accepted == 0
        assert eng.migration_stats.edges == {}
    finally:
        eng.close()


def test_engine_records_acceptance_per_edge_and_follows_removed_edges():
    eng = _engine(topology="all-to-all")
    try:
        rep = eng.run(max_steps=4)
        edges = eng.migration_stats.edges.values()
        assert sum(st.attempts for st in edges) > 0
        assert sum(st.accepts for st in edges) == rep.migrations_accepted \
            == eng.migrations_accepted
    finally:
        eng.close()
    topo = topology.ExplicitTopology([(0, 1), (1, 0)])
    eng = _engine(n_islands=2, topology=topo)
    try:
        eng.run(max_steps=2)
        frozen = eng.migration_stats.attempts((0, 1))
        assert frozen > 0
        topo.remove_edge(0, 1)
        eng.run(max_steps=4)
        assert eng.migration_stats.attempts((0, 1)) == frozen
        assert eng.migration_stats.attempts((1, 0)) > frozen
    finally:
        eng.close()


def test_topology_state_persisted_and_restored_only_for_its_family(tmp_path):
    p = str(tmp_path / "arch.json")
    eng = _engine(topology="adaptive", persist_path=p)
    try:
        eng.run(max_steps=4)
        state, stats = eng.topology.state(), eng.migration_stats.to_payload()
        assert state["epoch"] > 0
    finally:
        eng.close()
    for name, want in (("adaptive", state), ("ring", {})):
        fresh = _engine(topology=name)
        try:
            fresh.load_state(p)
            assert fresh.topology.state() == want
            assert fresh.migration_stats.to_payload() == stats
        finally:
            fresh.close()
