"""The evaluation path of the port: scoring function, cache, score vector.

Layout (a subset of ``repro.core.evals``):
  vector.py   ScoreVector — the value of f(x)
  cache.py    ScoreCache + the fidelity ladder (FIDELITIES / fidelity_key)
  scorer.py   Scorer / InlineBackend — the correctness gate on the card, the
              perfmodel (rung 0: the TPU v5e or the H100 model) and
              measured (rung 2) rungs, the batch
              path, the paper's baselines and the measured commit floor

The thread, process, service and cascade backends are later slices.
"""
from repro_torch.core.evals.cache import (FIDELITIES, HLO, MEASURED, PERFMODEL,
                                          ScoreCache, fidelity_key, key_fidelity)
from repro_torch.core.evals.scorer import (CORRECTNESS_TOL, MACHINES,
                                           MEASURED_MIN_REL, InlineBackend,
                                           Scorer,
                                           batch_scoring_enabled,
                                           correctness_memo_stats,
                                           set_batch_scoring)
from repro_torch.core.evals.vector import ScoreVector

__all__ = [
    "CORRECTNESS_TOL", "FIDELITIES", "HLO", "InlineBackend", "MACHINES",
    "MEASURED",
    "MEASURED_MIN_REL", "PERFMODEL", "ScoreCache", "ScoreVector", "Scorer",
    "batch_scoring_enabled", "correctness_memo_stats", "fidelity_key",
    "key_fidelity", "set_batch_scoring",
]
