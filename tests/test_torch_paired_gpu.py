"""The paired commit rule on the card: a genome paired against itself gains
no more than the commit floor.  Needs a CUDA device and skips without one.
This file imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_paired_gpu.py -m gpu -q
"""
import pytest
import torch

from repro_torch.core.evals import MEASURED, MEASURED_MIN_REL, Scorer
from repro_torch.core.evals.scorer import PAIRED_REPS
from repro_torch.core.perfmodel import mha_suite
from repro_torch.core.search_space import KernelGenome
from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME


@pytest.mark.gpu
def test_a_genome_paired_against_itself_stays_within_the_floor():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paired timing launches the sm_90a kernel")
    g = KernelGenome(**DEFAULT_ATTN_GENOME)
    scorer = Scorer(suite=mha_suite(), fidelity=MEASURED)
    pg = scorer.paired_gain(g, g)
    assert set(pg.ratios) == {c.name for c in scorer.suite}
    assert all(r > 0 for r in pg.ratios.values())
    assert all(len(rs) == PAIRED_REPS for rs in pg.rounds.values())
    assert abs(pg.gain) <= MEASURED_MIN_REL
    assert pg.seconds > 0
