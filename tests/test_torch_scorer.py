"""The port's Scorer vs the JAX package's: gate verdicts, rung-0 scores, and
the entry points' device rules."""
import random

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.core.evals import Scorer as JaxScorer
from repro_torch.core.evals import (HLO, MEASURED, PERFMODEL, InlineBackend,
                                    Scorer, key_fidelity)
from repro_torch.core.evals.scorer import _CHECK_MEMO
from repro_torch.core.perfmodel import (BenchConfig, decode_suite, gqa_suite,
                                        mha_suite)
from repro_torch.core.search_space import KernelGenome, full_space, seed_genome
from repro_torch.kernels.flash_attention import flash_attention


def _sample(n, seed=0):
    return random.Random(seed).sample(list(full_space()), n)


@pytest.mark.parametrize("suite_fn", [mha_suite, decode_suite])
def test_gate_verdicts_match_jax(suite_fn):
    """A seeded sample of the genome space, bf16-accumulator genomes among
    them: the port's gate (plain version on the CPU) and the JAX gate
    (Pallas interpret mode) pass and fail the same genomes."""
    genomes = _sample(16)
    assert any(g.acc_dtype == "bf16" for g in genomes)
    assert any(g.acc_dtype == "f32" for g in genomes)
    port = Scorer(suite=suite_fn(), device="cpu")
    ref = JaxScorer(suite=suite_fn())
    ours = [port.check(g) for g in genomes]
    theirs = [ref.check(g) for g in genomes]
    assert [ok for ok, _ in ours] == [ok for ok, _ in theirs]
    for g, (ok, why) in zip(genomes, ours):
        assert ok == (g.acc_dtype == "f32"), (g, why)
        if not ok:
            assert "mismatch" in why


def test_gate_proxy_inputs_are_the_reference_inputs():
    port = Scorer(suite=gqa_suite(), device="cpu")
    ref = JaxScorer(suite=gqa_suite())
    for (sh, *ours), (sh_ref, *theirs) in zip(port._proxy_data(), ref._proxy_data()):
        assert sh == sh_ref
        for a, b in zip(ours, theirs):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_measured_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        Scorer(fidelity=MEASURED, device="cpu")


def test_hlo_rung_scores_on_cpu_through_the_trace():
    """Rung 1 scores on the CPU (it was refused before the cascade): one
    value per config at its full shape, so two causal configs of one mask
    but different lengths score apart; keyed apart from rung 0, and an
    infeasible config (the card's model) at 0.0."""
    suite = mha_suite()[:2]
    sv = Scorer(suite=suite, fidelity=HLO, device="cpu")(seed_genome())
    assert sv.correct and all(v > 0 for v in sv.values)
    assert len(set(sv.values)) == len(suite) and {c.causal for c in suite} == {True}
    scorer = Scorer(suite=suite, fidelity=HLO, device="cpu")
    assert key_fidelity(scorer.score_key(seed_genome())) == HLO
    wide = Scorer(suite=[BenchConfig("d256", 1, 4, 4, 4096, head_dim=256)],
                  fidelity=HLO, device="cpu")(seed_genome())
    assert wide.values == (0.0,) and "head_dim 256" in wide.failure


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scorer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InlineBackend(suite=mha_suite())


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q, impl="kernel")


def test_keys_carry_the_device_type():
    """The plain and the kernel gate never answer each other: both memo
    keys name the device type, and the rung stays readable."""
    g = seed_genome().with_(block_q=512)
    s = Scorer(device="cpu")
    assert s.structural_key(g)[0] == "cpu"
    assert s.score_key(g).endswith("@cpu")
    assert key_fidelity(s.score_key(g)) == PERFMODEL
    cuda_like = Scorer(device="cpu")
    cuda_like.device = torch.device("cuda")
    assert cuda_like.structural_key(g) != s.structural_key(g)
    assert cuda_like.score_key(g) != s.score_key(g)


def test_check_is_memoized_per_structure():
    s = Scorer(suite=mha_suite(), device="cpu", rng_seed=7)
    a = seed_genome().with_(block_q=64)
    b = seed_genome().with_(block_q=128)     # both clamp to proxy block 16
    assert s.structural_key(a) == s.structural_key(b)
    hits = _CHECK_MEMO.stats()["hits"]
    assert s.check(a) == s.check(b) == (True, "")
    assert _CHECK_MEMO.stats()["hits"] == hits + 1


def test_cache_and_eval_count():
    s = InlineBackend(suite=mha_suite(), device="cpu")
    g = KernelGenome(block_q=256, block_k=512)
    first = s(g)
    assert s(g) is first
    assert s.n_evaluations == 1 and s.cache_hits == 1
    assert s.map([g, g]) == [first, first]
    assert s.submit(g).result() is first


@pytest.mark.parametrize("suite_fn", [mha_suite, gqa_suite, decode_suite])
def test_rung0_baselines_equal_jax(suite_fn):
    """At rung 0 ``baselines()`` is the reference's: the modelled expert and
    FA genomes (TPU v5e model), the same keys, the same values."""
    ours = Scorer(suite=suite_fn(), device="cpu").baselines()
    theirs = JaxScorer(suite=suite_fn()).baselines()
    assert ours == theirs
    assert set(ours) == {"expert", "fa_reference"}


def _same_vectors(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.config_names == b.config_names
        assert a.values == b.values
        assert (a.correct, a.failure) == (b.correct, b.failure)
        assert set(a.profiles) == set(b.profiles)


@pytest.mark.parametrize("batch", [True, False])
@pytest.mark.parametrize("suite_fn", [mha_suite, gqa_suite, decode_suite])
def test_score_batch_equals_jax(suite_fn, batch):
    """``score_batch`` at rung 0 with batch scoring set the same way in both
    packages: one ``estimate_batch`` per slate (on), the scalar path (off).
    Every genome is paid for; nothing lands in the cache."""
    from repro.core.evals.scorer import set_batch_scoring as jax_set_batch
    from repro_torch.core.evals import batch_scoring_enabled, set_batch_scoring
    genomes = _sample(12, seed=8) + [seed_genome()]
    port = Scorer(suite=suite_fn(), check_correctness=False, device="cpu")
    ref = JaxScorer(suite=suite_fn(), check_correctness=False)
    set_batch_scoring(batch)
    jax_set_batch(batch)
    try:
        assert batch_scoring_enabled() is batch
        ours, theirs = port.score_batch(genomes), ref.score_batch(genomes)
    finally:
        set_batch_scoring(True)
        jax_set_batch(True)
    _same_vectors(ours, theirs)
    assert port.n_evaluations == len(genomes) and len(port.cache) == 0
    assert port.score_batch([]) == []


def test_score_batch_gates_as_jax():
    """With the gate on, failed genomes (bf16 accumulators) score zero with
    the same failure in both packages' batch paths, and the rest score as
    the scalar path does (to relative 1e-12: the columnar model folds its
    sums in another order)."""
    genomes = [seed_genome(), seed_genome().with_(acc_dtype="bf16"),
               KernelGenome(block_q=256, block_k=512, kv_in_grid=True)]
    port = Scorer(suite=mha_suite(), device="cpu")
    ref = JaxScorer(suite=mha_suite())
    ours = port.score_batch(genomes)
    _same_vectors(ours, ref.score_batch(genomes))
    assert [sv.correct for sv in ours] == [True, False, True]
    for a, b in zip(ours, [port.score_uncached(g) for g in genomes]):
        assert (a.correct, a.failure) == (b.correct, b.failure)
        assert a.values == pytest.approx(b.values, rel=1e-12, abs=0)


def test_warm_builds_the_proxy_inputs_once():
    s = Scorer(suite=gqa_suite(), device="cpu", rng_seed=3)
    s.warm()
    built = s._proxy_inputs
    assert built is not None
    s.warm()
    assert s._proxy_inputs is built
    Scorer(suite=gqa_suite(), device="cpu", check_correctness=False).warm()
