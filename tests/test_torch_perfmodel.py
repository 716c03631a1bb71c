"""The port's rung 0 vs the JAX package's scalar ``estimate``: the TPU v5e
model is copied verbatim, so scores (and the lineages built on them) agree
bit for bit.  Held against scalar ``estimate``, not ``estimate_batch``, which
differs from it by an ulp on some hosts."""
import dataclasses
import random

import pytest

from repro.core.perfmodel import estimate as jax_estimate
from repro.core.perfmodel import useful_flops as jax_useful_flops
from repro.core.perfmodel import vmem_usage as jax_vmem_usage
from repro_torch.core.evals import Scorer
from repro_torch.core.perfmodel import (decode_suite, gqa_suite, mha_suite,
                                        suite_by_name, useful_flops, vmem_usage)
from repro_torch.core.search_space import full_space, seed_genome


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
