"""The island engine on the card: three islands at rung 0 with every gate
on the hand-written kernel, against the same engine on the CPU.  Needs a
CUDA device and skips without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_islands_gpu.py -m gpu -q
"""
import pytest
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.islands import IslandEvolution
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.kernels.flash_attention import flash_attention

FAST_SUITE = [BenchConfig("c4k", 8, 16, 16, 4096, causal=True),
              BenchConfig("n4k", 8, 16, 16, 4096, causal=False)]


def _run(device):
    eng = IslandEvolution(config=EngineConfig.from_kwargs(
        n_islands=3, suite=FAST_SUITE, migration_interval=2, seed=11,
        device=device, machine="h100"))
    try:
        eng.run(max_steps=6)
    finally:
        eng.close()
    return ({i.name: [(c.genome.key(), round(c.geomean, 9), c.note)
                      for c in i.lineage.commits] for i in eng.islands},
            eng.migration_stats.to_payload())


@pytest.mark.gpu
def test_three_islands_on_the_card_equal_the_cpu_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gate runs the sm_90a kernel")
    before = flash_attention.launches_by_body["fp32"]
    card = _run(None)
    launched = flash_attention.launches_by_body["fp32"] - before
    cpu = _run("cpu")
    assert flash_attention.launches_by_body["fp32"] - before == launched > 0
    assert card == cpu
    assert sum(len(v) for v in card[0].values()) > 3
