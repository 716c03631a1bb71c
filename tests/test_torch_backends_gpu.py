"""The process backend on the card: a slate of three genomes through two
spawned workers at the measured rung, against inline.  Needs a CUDA device
and skips without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_backends_gpu.py -m gpu -q
"""
import pytest
import torch

from repro_torch.core.evals import MEASURED, EvalSpec, Scorer, make_backend
from repro_torch.core.perfmodel import mha_suite
from repro_torch.core.search_space import KernelGenome, seed_genome
from repro_torch.device import card_lock_stats
from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the measured rung times the sm_90a kernel")


@pytest.mark.gpu
def test_process_slate_on_card_matches_inline_one_timer_at_a_time():
    """Gate verdicts equal inline's, and no two locked sections of the
    workers and this process overlap on the card."""
    _need_card()
    genomes = [seed_genome(), KernelGenome(**DEFAULT_ATTN_GENOME),
               seed_genome().with_(block_q=64, kv_in_grid=True)]
    inline = Scorer(suite=mha_suite(), fidelity=MEASURED)
    want = [inline(g) for g in genomes]
    del inline
    torch.cuda.empty_cache()
    pool = make_backend("process", suite=EvalSpec.resolve(mha_suite(),
                                                          fidelity=MEASURED),
                        max_workers=2)
    try:
        got = pool.map(genomes)
        stats = pool.worker_stats()
    finally:
        pool.close()
    assert len(stats) == 2
    assert [sv.correct for sv in got] == [sv.correct for sv in want] == [True] * 3
    assert all(sv.geomean > 0 for sv in got)
    spans = sorted(span for st in list(stats.values()) + [{"card_locks": card_lock_stats()}]
                   for rec in st["card_locks"].values() for span in rec["spans"])
    assert len(spans) >= 2 * len(genomes)
    assert all(b[0] >= a[1] for a, b in zip(spans, spans[1:]))
    assert sum(st["launches_by_body"]["wgmma"] for st in stats.values()) > 0
