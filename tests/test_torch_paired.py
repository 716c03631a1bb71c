"""The measured rung's paired commit rule on the CPU: ``PairedAgent`` commits
on the paired gain and not on the ratio of two geomeans scored apart (a
stub stands in for ``Scorer.paired_gain``, which needs a card); the
default ``ScriptedAgent._gain`` leaves rung-0 steps, trace lines included,
equal to the JAX package's; ``paired_gain`` refuses the CPU."""
from types import SimpleNamespace

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

from repro.core import ContinuousEvolution as JaxContinuousEvolution
from repro.core import Scorer as JaxScorer
from repro.core.perfmodel import BenchConfig as JaxBenchConfig
from repro_torch.core.agent import ScriptedAgent
from repro_torch.core.evals import (MEASURED, MEASURED_CALL_SPREAD,
                                    InlineBackend, PairedGain)
from repro_torch.core.evolution import ContinuousEvolution, PairedAgent
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.core.search_space import seed_genome
from repro_torch.core.variation import AgenticVariationOperator

FAST = [("c4k", 8, 16, 16, 4096, True), ("n4k", 8, 16, 16, 4096, False)]
STEPS = 5


def _scorer():
    return InlineBackend(suite=[BenchConfig(n, b, h, kv, s, causal=c)
                                for n, b, h, kv, s, c in FAST], device="cpu")


def _stubbed(gain):
    """A CPU scorer whose ``paired_gain`` answers ``gain`` for every pair
    and records the pairs it was asked about."""
    scorer, asked = _scorer(), []

    def paired_gain(incumbent, candidate):
        asked.append((incumbent, candidate))
        return PairedGain(gain, {c.name: 1.0 + gain for c in scorer.suite}, 0.0,
                          {c.name: [1.0 + gain] for c in scorer.suite})
    scorer.paired_gain = paired_gain
    return scorer, asked


def _run(scorer, agent):
    evo = ContinuousEvolution(scorer=scorer, operator=AgenticVariationOperator(agent))
    evo.run(max_steps=STEPS)
    return evo


def test_paired_agent_commits_on_the_paired_gain_above_the_floor():
    """Floor 2 (+200 %), far above every unpaired gain of the search: the
    stub's paired gain of 2.5 commits, and each commit's record shows the
    paired gain above the floor and the unpaired one below it."""
    scorer, asked = _stubbed(2.5)
    agent = PairedAgent(min_rel_improvement=2.0)
    evo = _run(scorer, agent)
    assert len(evo.lineage) > 1
    committed = [d for d in agent.decisions if d["committed"]]
    assert [d["genome"] for d in committed] == \
        [c.genome.key() for c in evo.lineage.commits[1:]]
    assert all(d["paired"] == 2.5 and d["unpaired"] < 2.0 for d in committed)
    # the incumbent of every pairing is the best commit at the time
    assert all(inc in [c.genome for c in evo.lineage.commits] for inc, _ in asked)
    step = next(t for t in evo.island.traces if "paired +250.00%" in str(t["trace"]))
    assert "unpaired" in str(step["trace"])


def test_paired_agent_refuses_an_unpaired_gain_the_pairing_refutes():
    """The agent's usual floor (1e-4) and a stub that pairs every candidate
    at -1 %: unpaired gains the scripted agent commits on rung 0 are
    refuted, and nothing but the seed commits."""
    plain = _run(_scorer(), ScriptedAgent())
    assert len(plain.lineage) > 1
    scorer, asked = _stubbed(-0.01)
    agent = PairedAgent()
    evo = _run(scorer, agent)
    assert len(evo.lineage) == 1 and asked
    assert any(d["unpaired"] > agent.min_rel for d in agent.decisions)
    assert not any(d["committed"] for d in agent.decisions)
    assert all(d["paired"] in (None, -0.01) for d in agent.decisions)


def test_paired_agent_pairs_only_above_minus_the_call_spread():
    """A candidate whose unpaired gain is at or below minus the unpaired
    spread between calls is refuted on that alone: no card time is spent
    on it; one above it is paired, also below minus the floor.  Started
    from a rung-0 search's best genome, where some edits regress."""
    best = _run(_scorer(), ScriptedAgent()).lineage.best().genome
    scorer, asked = _stubbed(-0.01)
    agent = PairedAgent(min_rel_improvement=1e-4, seed=best)
    _run(scorer, agent)
    skipped = [d for d in agent.decisions if d["paired"] is None]
    paired = [d for d in agent.decisions if d["paired"] is not None]
    assert skipped and paired and len(asked) == len(paired)
    assert all(d["unpaired"] <= -MEASURED_CALL_SPREAD and d["seconds"] is None
               for d in skipped)
    assert all(d["unpaired"] > -MEASURED_CALL_SPREAD for d in paired)
    # at the edges of the threshold, on either side of minus the floor
    g = seed_genome()
    tools = SimpleNamespace(scorer=scorer)
    agent = PairedAgent(min_rel_improvement=0.02)
    for unpaired, pairs in ((-0.5 * MEASURED_CALL_SPREAD, True),
                            (-0.01, True),
                            (-1.01 * MEASURED_CALL_SPREAD, False),
                            (-1.5 * MEASURED_CALL_SPREAD, False)):
        n = len(asked)
        gain = agent._gain(tools, g, SimpleNamespace(geomean=100.0), g,
                           SimpleNamespace(geomean=100.0 * (1.0 + unpaired)))
        assert (len(asked) == n + 1) == pairs
        assert gain == (-0.01 if pairs else pytest.approx(unpaired))


def test_default_gain_leaves_rung0_steps_equal_to_jax():
    """The default ``_gain`` is the reference's expression: rung-0 steps
    through the port, trace lines and all, equal the JAX package's."""
    ours = _run(_scorer(), ScriptedAgent())
    theirs = JaxContinuousEvolution(scorer=JaxScorer(
        suite=[JaxBenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST]))
    ref = theirs.run(max_steps=STEPS)
    assert len(ours.lineage) > 1
    assert [(t["note"], t["trace"]) for t in ours.island.traces] == \
        [(t["note"], t["trace"]) for t in ref.traces]


def test_paired_gain_refuses_the_cpu():
    rung0, g = _scorer(), seed_genome()
    with pytest.raises(ValueError, match="measured rung"):
        rung0.paired_gain(g, g)
    forced = _scorer()
    forced.fidelity = MEASURED            # the rung's wiring, without a card
    with pytest.raises(ValueError, match="CUDA device"):
        forced.paired_gain(g, g)
