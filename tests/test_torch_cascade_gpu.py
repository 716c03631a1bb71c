"""Rung 1 and the evaluation cascade on the card: rung 1 scored on the card
equals rung 1 on the CPU, and an island engine with the cascade on the card
commits the CPU engine's lineages while its rung 2 times the kernel's wgmma
body.  Needs a CUDA device and skips without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cascade_gpu.py -m gpu -q
"""
import pytest
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.evals import HLO, MEASURED, Scorer
from repro_torch.core.evals.scorer import _TRACE_MEMO
from repro_torch.core.islands import IslandEvolution
from repro_torch.core.perfmodel import BenchConfig, gqa_suite
from repro_torch.core.search_space import seed_genome
from repro_torch.kernels.flash_attention import flash_attention

FAST_SUITE = [BenchConfig("c4k", 8, 16, 16, 4096, causal=True),
              BenchConfig("n4k", 8, 16, 16, 4096, causal=False)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cascade's rung 2 times the sm_90a kernel")


@pytest.mark.gpu
def test_rung1_on_the_card_equals_rung1_on_the_cpu():
    _need_card()
    genomes = [seed_genome(), seed_genome().with_(mask_mode="block_skip",
                                                   kv_in_grid=True)]
    card = [Scorer(suite=gqa_suite(), fidelity=HLO)(g) for g in genomes]
    _TRACE_MEMO.clear()                  # the CPU scorer traces anew
    cpu = [Scorer(suite=gqa_suite(), fidelity=HLO, device="cpu")(g) for g in genomes]
    assert [sv.values for sv in card] == [sv.values for sv in cpu]
    assert all(sv.correct and sv.geomean > 0 for sv in card)


def _run(device):
    eng = IslandEvolution(config=EngineConfig.from_kwargs(
        n_islands=2, suite=FAST_SUITE, migration_interval=2, seed=11,
        device=device, machine="h100", cascade_eta=2, cascade_slate=3))
    try:
        eng.run(max_steps=4)
    finally:
        eng.close()
    return eng, [[c.genome.key() for c in i.lineage.commits] for i in eng.islands]


@pytest.mark.gpu
def test_cascade_on_the_card_commits_the_cpu_lineages_and_times_wgmma():
    _need_card()
    before = flash_attention.launches_by_body["wgmma"]
    card, card_prints = _run(None)
    timed = flash_attention.launches_by_body["wgmma"] - before
    cpu, cpu_prints = _run("cpu")
    assert card_prints == cpu_prints
    totals = card.cascade_totals()
    assert totals["evals"][MEASURED] > 0 and timed > 0
    assert cpu.cascade_totals()["evals"][MEASURED] == 0
    assert totals["calibration"]["observations"] > 0
