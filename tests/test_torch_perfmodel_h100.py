"""The H100 rung 0 (``core/perfmodel_h100.py``) at the real suite shapes: it
runs no tensors, so the whole genome space is modelled here.  Its signs are
those the card read for the port's kernel (PERF.md §6); the scorer, the loop
and the CLI select it by ``machine``."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core.evals.scorer as scorer_mod
from repro_torch.core import perfmodel, perfmodel_h100
from repro_torch.core.evals import MEASURED, InlineBackend, Scorer
from repro_torch.core.evolution import ContinuousEvolution
from repro_torch.core.knowledge import FACTS
from repro_torch.core.knowledge_h100 import HOPPER_FACTS
from repro_torch.core.perfmodel import (BenchConfig, decode_suite, gqa_suite,
                                        mha_suite, useful_flops)
from repro_torch.core.search_space import KernelGenome, full_space, seed_genome

SUITES = {"mha": mha_suite, "gqa": gqa_suite, "decode": decode_suite}
PIPELINED = KernelGenome(128, 128, "branchless", "block_skip", "deferred", True)


@pytest.fixture(scope="module")
def space():
    return list(full_space())


@pytest.fixture(scope="module")
def modelled(space):
    """``{(genome, config name): Profile}`` over the whole space and the
    three suites."""
    configs = [c for fn in SUITES.values() for c in fn()]
    return {(g, c.name): perfmodel_h100.estimate(g, c)
            for g in space for c in configs}


def _configs():
    return [c for fn in SUITES.values() for c in fn()]


def test_every_genome_is_feasible_on_every_suite(space, modelled):
    assert len(modelled) == len(space) * len(_configs())
    bad = [(g, n, p.infeasible_reason) for (g, n), p in modelled.items()
           if not p.feasible]
    assert not bad, bad[:3]


def test_total_never_beats_the_roofline(modelled):
    """total_s >= roofline_s, so no modelled rate exceeds the 989 TFLOP/s
    bf16 peak; the terms add up to the total."""
    for (g, name), p in modelled.items():
        assert p.total_s >= p.roofline_s > 0, (g, name)
        assert p.tflops <= perfmodel_h100.PEAK_FLOPS / 1e12
        parts = (p.t_mxu + p.t_vpu_exposed + p.t_dma_exposed + p.t_overhead
                 + p.t_bubble)
        assert parts == pytest.approx(p.total_s, rel=1e-12)
        assert min(p.t_mxu, p.t_vpu_exposed, p.t_dma_exposed, p.t_overhead,
                   p.t_bubble) >= 0.0


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_model_is_deterministic(suite):
    genomes = [seed_genome(), PIPELINED] + list(full_space())[::97]
    for g in genomes:
        for c in SUITES[suite]():
            assert perfmodel_h100.estimate(g, c) == perfmodel_h100.estimate(g, c)


def _time(modelled, g, name):
    return modelled[g, name].total_s


def test_block_skip_beats_dense_on_causal_configs(space, modelled):
    """Never slower anywhere; strictly faster on causal configs wherever the
    kernel can skip: more than one logical block on each axis, on the ring
    or on the loop body without gqa_pack (whose seq_mod drops its bounds)."""
    for g in space:
        if g.mask_mode != "dense":
            continue
        skip = g.with_(mask_mode="block_skip")
        for c in _configs():
            dense_t, skip_t = _time(modelled, g, c.name), _time(modelled, skip, c.name)
            assert skip_t <= dense_t, (g, c.name)
            packed = g.gqa_pack and c.n_heads > c.n_kv_heads
            can_skip = c.seq_len > max(g.block_q, g.block_k) and (
                g.kv_in_grid or not packed)
            if c.causal and can_skip:
                assert skip_t < dense_t, (g, c.name)


def test_ring_beats_single_stage(space, modelled):
    for g in space:
        if g.kv_in_grid:
            continue
        for c in _configs():
            assert _time(modelled, g.with_(kv_in_grid=True), c.name) < \
                _time(modelled, g, c.name), (g, c.name)


def test_deferred_division_no_slower_than_eager(space, modelled):
    for g in space:
        if g.div_mode != "eager":
            continue
        for c in _configs():
            assert _time(modelled, g.with_(div_mode="deferred"), c.name) <= \
                _time(modelled, g, c.name), (g, c.name)


def test_rescale_mode_is_a_no_op_on_the_loop_body(space, modelled):
    """kv_in_grid=False rescales without a branch whatever the genome says,
    and eager division is the ring's only: both axes leave the profile
    unchanged there."""
    for g in space:
        if g.kv_in_grid:
            continue
        for c in _configs():
            p = modelled[g, c.name]
            assert modelled[g.with_(rescale_mode="branchless"), c.name] == p
            assert modelled[g.with_(rescale_mode="branched"), c.name] == p
            assert modelled[g.with_(div_mode="deferred"), c.name] == p


def test_no_logical_block_above_128_beats_128_on_causal_configs(space, modelled):
    """Over the genomes the gate passes (fp32 accumulators: a bf16 one is
    never timed, and rounds less often under larger blocks)."""
    for g in space:
        if g.mask_mode != "block_skip" or g.acc_dtype != "f32":
            continue
        for c in _configs():
            if not c.causal:
                continue
            t = _time(modelled, g, c.name)
            if g.block_q > 128:
                assert _time(modelled, g.with_(block_q=128), c.name) <= t, (g, c.name)
            if g.block_k > 128:
                assert _time(modelled, g.with_(block_k=128), c.name) <= t, (g, c.name)


def test_tile_geometry_follows_the_kernel():
    """The wgmma body at head_dim 64 and 128, mma_sync elsewhere; shared
    memory as the launch code sizes it; one chunk walk per CTA of 128 rows."""
    cfg = mha_suite()[0]
    assert perfmodel_h100.body_for(cfg) is perfmodel_h100.WGMMA
    assert perfmodel_h100.body_for(dataclasses.replace(cfg, head_dim=64)) \
        is perfmodel_h100.WGMMA
    assert perfmodel_h100.body_for(dataclasses.replace(cfg, head_dim=96)) \
        is perfmodel_h100.MMA_SYNC
    # WLayout<128, 2>::smem and <128, 1>::smem
    assert perfmodel_h100.smem_bytes(PIPELINED, cfg) == 1024 + 2 * 5 * 16384 + 64 + 48
    assert perfmodel_h100.smem_bytes(seed_genome(), cfg) == 1024 + 2 * 3 * 16384 + 64 + 32
    # causal S = 4096 at 128-blocks: CTA m visits m + 1 chunks, the last masked
    chunks, masked, blocks = perfmodel_h100.walk_counts(PIPELINED, cfg,
                                                        perfmodel_h100.WGMMA)
    np.testing.assert_array_equal(chunks, np.arange(1, 33))
    np.testing.assert_array_equal(masked, np.ones(32))
    # dense visits all 32, all masked; a 256-row logical block adds one
    # masked chunk to the first CTA of each pair
    chunks, masked, _ = perfmodel_h100.walk_counts(seed_genome(), cfg,
                                                   perfmodel_h100.WGMMA)
    assert (chunks == 32).all() and (masked == 32).all()
    chunks, masked, _ = perfmodel_h100.walk_counts(PIPELINED.with_(block_q=256), cfg,
                                                   perfmodel_h100.WGMMA)
    np.testing.assert_array_equal(chunks, 2 * (np.arange(32) // 2 + 1))
    np.testing.assert_array_equal(masked, 2 * np.ones(32))


def test_efficiency_constants_give_their_reading():
    """Each body's one efficiency constant is the value at which the model
    gives the card's `times` reading for the pipelined genome at
    mha_causal_s4096 (PERF.md §6): 1.243 ms on wgmma, 3.678 ms on mma_sync."""
    cfg = mha_suite()[0]
    wgmma = perfmodel_h100.estimate_body(PIPELINED, cfg, perfmodel_h100.WGMMA)
    mma = perfmodel_h100.estimate_body(PIPELINED, cfg, perfmodel_h100.MMA_SYNC)
    assert wgmma == perfmodel_h100.estimate(PIPELINED, cfg)
    assert wgmma.total_s == pytest.approx(1.243e-3, rel=2e-3)
    assert mma.total_s == pytest.approx(3.678e-3, rel=2e-3)


def test_infeasible_reason_reads_infeasible():
    """A head_dim past the kernel's 128 is infeasible, with this model's
    reason, in the scalar and the batch path, and the scorer's failure
    keeps the word the agent's repair path looks for."""
    wide = BenchConfig("wide", 1, 4, 4, 1024, head_dim=256)
    p = perfmodel_h100.estimate(PIPELINED, wide)
    assert not p.feasible and p.tflops == 0.0
    assert "head_dim 256" in p.infeasible_reason and "VMEM" not in p.infeasible_reason
    be = perfmodel_h100.estimate_batch([PIPELINED, seed_genome()],
                                       [mha_suite()[0], wide])
    assert be.profile(0, 1) == p
    assert be.profile(1, 0) == perfmodel_h100.estimate(seed_genome(), mha_suite()[0])
    assert be.feasible.tolist() == [[True, False], [True, False]]
    sv = Scorer(suite=[mha_suite()[0], wide], check_correctness=False,
                machine="h100", device="cpu")(PIPELINED)
    assert sv.failure.startswith("infeasible on: wide (infeasible: head_dim 256")


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_score_batch_equals_scalar_scoring(suite):
    """Rung 0 under machine="h100": the batch path equals scalar scoring
    exactly, values and profiles."""
    genomes = list(full_space())[5::151] + [seed_genome(), PIPELINED]
    s = Scorer(suite=SUITES[suite](), check_correctness=False, machine="h100",
               device="cpu")
    batch = s.score_batch(genomes)
    for g, b in zip(genomes, batch):
        a = s.score_uncached(g)
        assert (a.values, a.correct, a.failure) == (b.values, b.correct, b.failure)
        assert a.profiles == b.profiles
        assert a.profiles == {c.name: perfmodel_h100.estimate(g, c)
                              for c in s.suite}


def test_machines_never_share_a_memo_entry():
    g = PIPELINED
    tpu = Scorer(device="cpu")
    h100 = Scorer(device="cpu", machine="h100")
    assert tpu.machine == "tpu_v5e" and h100.machine == "h100"
    assert tpu.score_key(g) != h100.score_key(g)
    assert tpu.structural_key(g) != h100.structural_key(g)
    assert h100.score_key(g).endswith("@cpu")
    assert tpu(g).values != h100(g).values


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_rung0_baselines_follow_the_machine(suite):
    """Under "h100" the reference's expert and FA genomes go through the
    Hopper model; under the default they stay the reference's."""
    cfgs = SUITES[suite]()
    ours = Scorer(suite=cfgs, device="cpu", machine="h100").baselines()
    assert ours == {
        "expert": tuple(perfmodel_h100.estimate(perfmodel.EXPERT_GENOME, c).tflops
                        for c in cfgs),
        "fa_reference": tuple(perfmodel_h100.estimate(
            perfmodel.FA_REFERENCE_GENOME, c).tflops for c in cfgs)}
    assert Scorer(suite=cfgs, device="cpu").baselines()["expert"] == \
        tuple(perfmodel.expert_reference(c) for c in cfgs)


def test_unknown_machine_and_tpu_measured_are_refused():
    with pytest.raises(ValueError, match="unknown machine"):
        Scorer(device="cpu", machine="a100")
    with pytest.raises(ValueError, match="measured rung plans"):
        Scorer(fidelity=MEASURED, device="cpu", machine="tpu_v5e")
    with pytest.raises(ValueError, match="planning A/B"):
        Scorer(device="cpu", _plan_machine="tpu_v5e")


@pytest.fixture
def fake_card(monkeypatch):
    """The measured rung on the CPU: a device that reads as CUDA, inputs and
    the timer stubbed (1 ms a config), so no kernel runs."""
    monkeypatch.setattr(scorer_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(scorer_mod, "time_cuda_ms", lambda fn, **kw: 1.0)
    monkeypatch.setattr(Scorer, "full_inputs", lambda self, cfg: (None,) * 3)


def test_measured_rung_plans_from_the_card_model(fake_card):
    """The measured rung takes feasibility and profiles from the H100 model;
    the planning A/B's private keyword swaps in the TPU profiles alone."""
    s = Scorer(suite=mha_suite(), fidelity=MEASURED, check_correctness=False)
    assert (s.machine, s.plan_machine) == ("h100", "h100")
    sv = s(PIPELINED)
    assert sv.profiles == {c.name: perfmodel_h100.estimate(PIPELINED, c)
                           for c in s.suite}
    assert list(sv.values) == [useful_flops(c) / 1e-3 / 1e12 for c in s.suite]
    ab = Scorer(suite=mha_suite(), fidelity=MEASURED, check_correctness=False,
                _plan_machine="tpu_v5e")
    sv_ab = ab(PIPELINED)
    assert sv_ab.values == sv.values
    assert sv_ab.profiles == {c.name: perfmodel.estimate(PIPELINED, c)
                              for c in s.suite}
    assert ab.score_key(PIPELINED) != s.score_key(PIPELINED)


def test_measured_evolution_consults_hopper_facts(fake_card):
    evo = ContinuousEvolution(fidelity=MEASURED)
    assert evo.scorer.plan_machine == "h100"
    assert evo.kb.facts == HOPPER_FACTS
    ab = ContinuousEvolution(scorer=InlineBackend(fidelity=MEASURED,
                                                  _plan_machine="tpu_v5e"))
    assert ab.kb.facts == FACTS


def test_kb_follows_the_rung0_machine():
    assert ContinuousEvolution(device="cpu").kb.facts == FACTS
    assert ContinuousEvolution(device="cpu", machine="h100").kb.facts == HOPPER_FACTS
    own = ContinuousEvolution(device="cpu", machine="h100",
                              kb=ContinuousEvolution(device="cpu").kb)
    assert own.kb.facts == FACTS


def _lineage(evo):
    return [(c.genome.key(), c.geomean, c.values, c.note) for c in evo.lineage.commits]


def test_h100_rung0_lineage_commits_and_is_deterministic():
    """Rung 0 under the H100 model: the agent plans from it with the Hopper
    facts, commits (the ring, then block_skip from the seed) and gives the
    same lineage twice."""
    runs = []
    for _ in range(2):
        evo = ContinuousEvolution(fidelity="perfmodel", machine="h100", device="cpu")
        rep = evo.run(max_steps=5)
        runs.append((_lineage(evo), [t["note"] for t in rep.traces]))
    assert runs[0] == runs[1]
    lineage, notes = runs[0]
    assert len(lineage) >= 3
    assert "dma-overlap" in lineage[1][3] and "block-skip" in lineage[2][3]
    best = KernelGenome.from_dict(__import__("json").loads(lineage[-1][0]))
    assert best.kv_in_grid and best.mask_mode == "block_skip"


def test_cli_refuses_tpu_model_at_the_measured_rung(capsys):
    from repro_torch.evolve import main
    with pytest.raises(SystemExit):
        main(["--fidelity", "measured", "--machine", "tpu_v5e", "--device", "cpu"])
    assert "--machine must be h100" in capsys.readouterr().err


def test_cli_runs_rung0_on_the_h100_model(tmp_path, capsys):
    from repro_torch.evolve import main
    main(["--fidelity", "perfmodel", "--machine", "h100", "--device", "cpu",
          "--commits", "2", "--max-steps", "3", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "planning from the h100 model" in out
    assert (tmp_path / "lineage_mha.json").exists()


def test_model_is_closed_form_per_config():
    """No Python walk over (q-block, k-block) pairs: the longest config of
    the suites models as fast as the shortest, to within a few times."""
    import time
    short, long_ = mha_suite()[0], mha_suite()[3]
    assert long_.seq_len == 8 * short.seq_len

    def seconds(cfg):
        t0 = time.perf_counter()
        for _ in range(20):
            perfmodel_h100.estimate(PIPELINED.with_(block_q=64, block_k=128), cfg)
        return time.perf_counter() - t0

    seconds(short)
    assert seconds(long_) < 4 * seconds(short) + 0.05
