"""Rung 1 of the port's scorer on the CPU: each suite config's launch, the one
rung 2 times, counted in the kernel's physical walk.  Its dot FLOPs equal the
plain block walk's where the logical blocks are whole chunks, skipping dead
blocks never scores below the dense twin, the score sees the sequence length
and stays under the card's peak, the ranking agrees with the H100 rung 0,
the batch path equals the scalar one, the traced chunk steps chained over a
walk compute attention, and a scoring with the trace memo warm takes
milliseconds.  No JAX: the plain walk is tied to the reference's HLO count
in ``tests/test_torch_cascade.py``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_rung1.py
"""
import statistics
import time

import numpy as np
import pytest
import torch

from repro_torch.core import perfmodel_h100
from repro_torch.core.evals import scorer as scorer_module
from repro_torch.core.evals import HLO, Scorer, set_batch_scoring
from repro_torch.core.evals.scorer import (_TRACE_MEMO, batch_scoring_enabled,
                                           rung1_counts, rung1_tflops)
from repro_torch.core.perfmodel import (BenchConfig, decode_suite, gqa_suite,
                                        mha_suite)
from repro_torch.core.search_space import KernelGenome, full_space, seed_genome
from repro_torch.kernels.flash_attention import (chunk_step_plain,
                                                 cta_epilogue_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.ref import mha_reference
from repro_torch.launch.trace_analysis import trace_summary

SUITES = {"mha": mha_suite, "gqa": gqa_suite}


def _sample() -> list:
    """The card's rank sample: 24 genomes with fp32 accumulators drawn by
    ``numpy.random.default_rng(0).choice``, then the seed."""
    space = [g for g in full_space() if g.acc_dtype == "f32"]
    rng = np.random.default_rng(0)
    genomes = [space[i] for i in rng.choice(len(space), 24, replace=False)]
    return genomes + [g for g in (seed_genome(),) if g not in genomes]


def _scorer(suite) -> Scorer:
    return Scorer(suite=suite, fidelity=HLO, check_correctness=False,
                  device="cpu", machine="h100")


def _spearman(a, b) -> float:
    def ranks(x):
        x = np.asarray(x, dtype=np.float64)
        r = np.empty(len(x))
        r[x.argsort(kind="stable")] = np.arange(len(x), dtype=np.float64)
        for v in np.unique(x):
            r[x == v] = r[x == v].mean()
        return r
    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def _geomean(values) -> float:
    return float(np.exp(np.mean(np.log(values))))


# -- (a) the walk's dot FLOPs --------------------------------------------------


@pytest.mark.parametrize("kv_in_grid", [True, False])
@pytest.mark.parametrize("mask_mode", ["dense", "block_skip"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(128, 128), (256, 128), (128, 256), (512, 256)])
@pytest.mark.parametrize("hkv,gqa_pack", [(4, False), (2, True)])
def test_walk_dot_flops_equal_the_plain_walk(kv_in_grid, mask_mode, causal, bq,
                                             bk, hkv, gqa_pack):
    """Blocks that are multiples of 128 are whole wgmma chunks and tiles, so
    the physical walk multiplies exactly the block pairs the plain walk
    does, at (1, 4, 512, 64) on the wgmma geometry."""
    g = KernelGenome(block_q=bq, block_k=bk, mask_mode=mask_mode,
                     kv_in_grid=kv_in_grid, gqa_pack=gqa_pack)
    cfg = BenchConfig("t", 1, 4, hkv, 512, head_dim=64, causal=causal)
    assert perfmodel_h100.body_for(cfg) is perfmodel_h100.WGMMA
    q = torch.empty((1, 4, 512, 64), device="meta")
    kv = torch.empty((1, hkv, 512, 64), device="meta")
    plain = trace_summary(flash_attention_plain, q, kv, kv, causal=causal,
                          **g.kernel_kwargs())
    assert rung1_counts(g, cfg)["dot_flops"] == plain["dot_flops"] > 0


# -- (b)-(d) the values ------------------------------------------------------------


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_skipping_dead_blocks_never_scores_below_dense(suite):
    cfgs = SUITES[suite]()
    scorer = _scorer(cfgs)
    for g in _sample():
        skip = scorer.score_uncached(g.with_(mask_mode="block_skip")).values
        dense = scorer.score_uncached(g.with_(mask_mode="dense")).values
        for cfg, s, d in zip(cfgs, skip, dense):
            if cfg.causal:
                assert s >= d > 0, (g, cfg.name)


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_rung1_sees_the_sequence_length(suite):
    """The causal configs of one head layout differ only in S (the batch
    keeps S·B fixed): their values differ, where a proxy shape gave them
    one."""
    cfgs = SUITES[suite]()
    for g in (seed_genome(), seed_genome().with_(kv_in_grid=True,
                                                 mask_mode="block_skip")):
        by_layout: dict = {}
        for c, v in zip(cfgs, _scorer(cfgs)(g).values):
            if c.causal:
                by_layout.setdefault(c.n_kv_heads, []).append(v)
        for values in by_layout.values():
            assert len(values) == 4 and len(set(values)) == 4


@pytest.mark.parametrize("suite", ["mha", "gqa", "decode"])
def test_no_value_above_the_cards_peak(suite):
    cfgs = {"decode": decode_suite, **SUITES}[suite]()
    scorer = _scorer(cfgs)
    peak = perfmodel_h100.PEAK_FLOPS / 1e12
    for g in _sample():
        sv = scorer.score_uncached(g)
        assert sv.correct and all(0 < v <= peak for v in sv.values), g


def test_an_infeasible_config_scores_zero_and_a_trace_fault_raises(monkeypatch):
    wide = BenchConfig("d256", 1, 4, 4, 4096, head_dim=256)
    sv = _scorer([wide])(seed_genome())
    assert sv.values == (0.0,) and "head_dim 256" in sv.failure

    def broken(*args, **kwargs):
        raise RuntimeError("trace fault")
    monkeypatch.setattr(scorer_module, "trace_summary", broken)
    _TRACE_MEMO.clear()
    with pytest.raises(RuntimeError, match="trace fault"):
        _scorer(mha_suite()[:1]).score_uncached(seed_genome())
    with pytest.raises(RuntimeError, match="trace fault"):
        rung1_tflops(seed_genome(), mha_suite()[0])


# -- (e) the ranking ------------------------------------------------------------------


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_ranking_agrees_with_the_h100_rung0(suite):
    """Spearman's rho of rung 1's geomeans against the H100 model's over
    the card's rank sample: the proxy walk read -0.30 on mha_suite."""
    cfgs = SUITES[suite]()
    genomes = _sample()
    rung1 = [_scorer(cfgs).score_uncached(g).geomean for g in genomes]
    rung0 = [_geomean([perfmodel_h100.estimate(g, c).tflops for c in cfgs])
             for g in genomes]
    assert _spearman(rung1, rung0) >= 0.5


# -- (f) the batch path and the cost ------------------------------------------------


def test_score_batch_equals_the_scalar_path():
    scorer = _scorer(mha_suite())
    genomes = _sample()[:8]
    was = batch_scoring_enabled()
    set_batch_scoring(True)
    try:
        batch = scorer.score_batch(genomes)
    finally:
        set_batch_scoring(was)
    scalar = [scorer.score_uncached(g) for g in genomes]
    assert [(s.values, s.correct, s.failure) for s in batch] == \
        [(s.values, s.correct, s.failure) for s in scalar]


def test_a_warm_scoring_takes_milliseconds_and_traces_per_tile():
    """With the trace memo warm a mha_suite scoring is a walk count and
    arithmetic: under 0.05 s of host time.  One genome traces four tiles:
    the unmasked chunk, the causal and the non-causal masked chunks, the
    epilogue."""
    _TRACE_MEMO.clear()
    g = seed_genome().with_(kv_in_grid=True, mask_mode="block_skip")
    scorer = _scorer(mha_suite())
    scorer.score_uncached(g)
    assert _TRACE_MEMO.stats()["entries"] == 4
    seconds = []
    for _ in range(5):
        t0 = time.perf_counter()
        scorer.score_uncached(g)
        seconds.append(time.perf_counter() - t0)
    assert statistics.median(seconds) < 0.05
    assert _TRACE_MEMO.stats()["entries"] == 4


# -- the traced steps compute attention ----------------------------------------------


@pytest.mark.parametrize("div_mode,rescale_mode", [
    ("deferred", "branchless"), ("eager", "branched"), ("deferred", "branched")])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 96)])
def test_chunk_steps_chained_over_a_walk_compute_attention(div_mode, rescale_mode,
                                                           causal, window):
    """The chunk step and the epilogue, chained over every chunk of a
    dense walk with CTAs of 64 rows and chunks of 32 keys, give the
    oracle's attention within bf16 rounding (P is rounded for P V), and the
    unmasked step equals the masked one where the mask removes nothing."""
    gen = torch.Generator().manual_seed(0)
    S, D, R, C = 192, 32, 64, 32
    q, k, v = (torch.randn((1, 1, S, D), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    out = torch.empty((S, D))
    for r0 in range(0, S, R):
        acc = torch.zeros((R, D))
        m, l = torch.full((R,), -1e30), torch.zeros(R)
        qpos = torch.arange(r0, r0 + R)[:, None]
        for k0 in range(0, S, C):
            acc, m, l = chunk_step_plain(
                q[0, 0, r0:r0 + R], k[0, 0, k0:k0 + C], v[0, 0, k0:k0 + C], acc,
                m, l, qpos, k0, scale=D ** -0.5, causal=causal, window=window,
                k_limit=S, rescale_mode=rescale_mode, div_mode=div_mode)
        out[r0:r0 + R] = cta_epilogue_plain(acc, l, div_mode=div_mode).float()
    ref = mha_reference(q.float(), k.float(), v.float(), causal=causal,
                        window=window)[0, 0]
    assert (out - ref).abs().max() < 2e-2
    state = (torch.zeros((R, D)), torch.full((R,), -1e30), torch.zeros(R))
    args = (q[0, 0, :R], k[0, 0, :C], v[0, 0, :C], *state,
            torch.arange(R)[:, None], 0)
    kw = dict(scale=D ** -0.5, k_limit=S, rescale_mode=rescale_mode,
              div_mode=div_mode)
    for a, b in zip(chunk_step_plain(*args, masked=True, **kw),
                    chunk_step_plain(*args, masked=False, **kw)):
        assert torch.equal(a, b)
