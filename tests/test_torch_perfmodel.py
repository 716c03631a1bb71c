"""The port's rung 0 vs the JAX package's: the TPU v5e model is copied
verbatim, so scores (and the lineages built on them) agree bit for bit.
Scalar ``estimate`` is held against the JAX scalar ``estimate``, the
columnar ``estimate_batch`` against the JAX ``estimate_batch`` (which
differs from the scalar model by an ulp on some hosts, so the two paths meet
at relative 1e-12).  The modelled measured timer, its calibration and the
reference genomes equal the JAX package's too."""
import dataclasses
import random

import numpy as np
import pytest

from repro.core.perfmodel import estimate as jax_estimate
from repro.core.perfmodel import useful_flops as jax_useful_flops
from repro.core.perfmodel import vmem_usage as jax_vmem_usage
from repro_torch.core.evals import Scorer
from repro_torch.core.perfmodel import (decode_suite, gqa_suite, mha_suite,
                                        suite_by_name, useful_flops, vmem_usage)
from repro_torch.core.search_space import KernelGenome, full_space, seed_genome


def _sample(n, seed=0):
    return random.Random(seed).sample(list(full_space()), n)


@pytest.mark.parametrize("suite_fn", [mha_suite, gqa_suite, decode_suite])
def test_rung0_scores_identical_to_jax_scalar_estimate(suite_fn):
    """Rung 0 is the reference's TPU model verbatim: every value and every
    profile field equals JAX's scalar ``estimate`` exactly."""
    suite = suite_fn()
    port = Scorer(suite=suite, check_correctness=False, device="cpu")
    for g in _sample(10, seed=1) + [seed_genome()]:
        sv = port(g)
        assert sv.correct
        for cfg, value in zip(suite, sv.values):
            ref = jax_estimate(g, cfg)
            assert value == (ref.tflops if ref.feasible else 0.0)
            assert dataclasses.asdict(sv.profiles[cfg.name]) == \
                dataclasses.asdict(ref)


def test_suites_and_helpers_match_jax():
    from repro.core.perfmodel import suite_by_name as jax_suite_by_name
    for name in ("mha", "gqa", "decode", "mha+gqa+decode"):
        ours, theirs = suite_by_name(name), jax_suite_by_name(name)
        assert [dataclasses.asdict(c) for c in ours] == \
            [dataclasses.asdict(c) for c in theirs]
        for g in _sample(4, seed=2):
            for a, b in zip(ours, theirs):
                assert useful_flops(a) == jax_useful_flops(b)
                assert vmem_usage(g, a) == jax_vmem_usage(g, b)
    with pytest.raises(ValueError):
        suite_by_name("bogus")


_BATCH_COLUMNS = ("tflops", "total_s", "t_mxu", "t_vpu", "t_dma", "t_overhead",
                  "t_bubble", "vmem", "feasible")


def _slate(seed):
    """A seeded sample of the space with the seed genome, the two reference
    genomes and two genomes past the model's 128 MiB of VMEM (blocks of 8192:
    a 256 MiB score tile), so infeasible lanes and every mode occur."""
    from repro_torch.core.perfmodel import EXPERT_GENOME, FA_REFERENCE_GENOME
    return _sample(24, seed=seed) + [
        seed_genome(), EXPERT_GENOME, FA_REFERENCE_GENOME,
        KernelGenome(block_q=8192, block_k=8192),
        KernelGenome(block_q=8192, block_k=8192, kv_in_grid=True, gqa_pack=True)]


@pytest.mark.parametrize("suite_fn", [mha_suite, gqa_suite, decode_suite])
def test_estimate_batch_equals_jax_and_scalar(suite_fn):
    """The columnar model is the reference's verbatim: every column equals
    the JAX package's ``estimate_batch`` exactly, and every lane the scalar
    ``estimate`` at relative 1e-12 (the two fold sums in other orders)."""
    from repro.core.perfmodel import estimate_batch as jax_estimate_batch
    from repro.core.search_space import KernelGenome as JaxKernelGenome
    from repro_torch.core.perfmodel import estimate, estimate_batch
    suite = suite_fn()
    genomes = _slate(seed=3)
    ours = estimate_batch(genomes, suite)
    theirs = jax_estimate_batch([JaxKernelGenome(**dataclasses.asdict(g))
                                 for g in genomes], suite_by_name_jax(suite_fn))
    assert ours.config_names == theirs.config_names
    assert ours.rooflines == theirs.rooflines
    for col in _BATCH_COLUMNS:
        assert np.array_equal(getattr(ours, col), getattr(theirs, col)), col
    assert not ours.feasible.all()
    for gi, g in enumerate(genomes):
        for ci, cfg in enumerate(suite):
            lane, scalar = ours.profile(gi, ci), estimate(g, cfg)
            assert lane.feasible == scalar.feasible
            assert lane.infeasible_reason == scalar.infeasible_reason
            assert lane.vmem_bytes == scalar.vmem_bytes
            for f in ("tflops", "total_s", "t_mxu", "t_vpu_exposed",
                      "t_dma_exposed", "t_overhead", "t_bubble", "roofline_s"):
                assert getattr(lane, f) == pytest.approx(getattr(scalar, f),
                                                         rel=1e-12, abs=0), f


def suite_by_name_jax(suite_fn):
    from repro.core import perfmodel as jax_perfmodel
    return getattr(jax_perfmodel, suite_fn.__name__)()


def test_estimate_batch_of_nothing():
    from repro_torch.core.perfmodel import estimate_batch
    be = estimate_batch([], mha_suite())
    assert len(be) == 0 and be.tflops.shape == (0, len(mha_suite()))


@pytest.mark.parametrize("suite_fn", [mha_suite, gqa_suite, decode_suite])
def test_measured_estimate_equals_jax(suite_fn):
    """The modelled measured timer (TPU v5e, ``MEASURED_TERM_FACTORS``)
    equals the JAX package's, field for field."""
    from repro.core.perfmodel import MEASURED_TERM_FACTORS as JAX_FACTORS
    from repro.core.perfmodel import measured_estimate as jax_measured_estimate
    from repro_torch.core.perfmodel import (MEASURED_TERM_FACTORS,
                                            measured_estimate)
    assert MEASURED_TERM_FACTORS == JAX_FACTORS
    for g in _slate(seed=4):
        for cfg in suite_fn():
            assert dataclasses.asdict(measured_estimate(g, cfg)) == \
                dataclasses.asdict(jax_measured_estimate(g, cfg))


def test_calibration_state_equals_jax():
    """The same observations (failed ones among them) give the same EMA
    state, corrections and round trip in both packages."""
    from repro.core.perfmodel import PerfModelCalibration as JaxCalibration
    from repro_torch.core.perfmodel import PerfModelCalibration
    rng = np.random.default_rng(5)
    ours, theirs = PerfModelCalibration(alpha=0.3), JaxCalibration(alpha=0.3)
    classes = ("mxu", "vpu", "dma", "overhead", "bubble")
    for _ in range(40):
        obs = (classes[int(rng.integers(len(classes)))],
               float(rng.choice([0.0, rng.uniform(1, 300)])),
               float(rng.choice([0.0, rng.uniform(1, 300)], p=[0.1, 0.9])))
        ours.observe(*obs)
        theirs.observe(*obs)
    assert ours.state() == theirs.state()
    assert ours.observations == theirs.observations > 0
    for c in classes + ("vmem",):
        assert ours.corrected(c, 123.0) == theirs.corrected(c, 123.0)
    again = PerfModelCalibration()
    again.load_state(theirs.state())
    assert again.state() == ours.state()
    with pytest.raises(ValueError):
        PerfModelCalibration(alpha=0.0)


def test_reference_genomes_equal_jax():
    from repro.core import perfmodel as jax_perfmodel
    from repro_torch.core import perfmodel
    for name in ("EXPERT_GENOME", "FA_REFERENCE_GENOME"):
        assert getattr(perfmodel, name).key() == getattr(jax_perfmodel, name).key()
    for suite_fn in (mha_suite, gqa_suite, decode_suite):
        for cfg in suite_fn():
            assert perfmodel.expert_reference(cfg) == jax_perfmodel.expert_reference(cfg)
            assert perfmodel.fa_reference(cfg) == jax_perfmodel.fa_reference(cfg)
