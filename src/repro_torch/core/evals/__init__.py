"""The evaluation service of the port: scoring function, cache, and parallel
backends.

Layout (``repro.core.evals``):
  vector.py          ScoreVector — the value of f(x), picklable
  cache.py           ScoreCache — the explicit memo API every backend shares —
                     + the fidelity ladder (FIDELITIES / fidelity_key)
  scorer.py          Scorer / InlineBackend — the correctness gate on the card,
                     the perfmodel (rung 0: the TPU v5e or the H100 model),
                     hlo (rung 1: the full-shape launch counted per chunk)
                     and measured (rung 2) rungs, the batch path, the paper's
                     baselines and the measured commit floor, in-process
  worker.py          evaluate_genome / EvalSpec — the pure picklable worker fn
                     (the spec names the device and rung 0's machine)
  backends.py        EvalBackend protocol + the backend registry
                     (register_backend); thread (BatchScorer) + process ship
                     here, service/cascade self-register
  cascade.py         CascadeBackend — successive-halving promotion across
                     rungs (0-1 on the CPU, 0-2 on the card)
  elastic.py         ElasticProcessPool — worker count follows queue depth
  protocol.py        length-prefixed socket frames (spec+genome out, scores
                     back; the HELLO names the package)
  service.py         EvalCoordinator + ServiceBackend — cross-host scoring on
                     one asyncio event loop: live worker registry, heartbeats,
                     fault-tolerant requeue, weighted-fair tenant scheduling
  service_worker.py  the remote worker entrypoint (python -m ... --connect)

Every backend exposes the same sync (``__call__``/``map``) and async
(``submit`` -> Future, with per-genome dedup) surfaces.  Caches, dedup
tables, and wire frames are all keyed per ``(genome, spec, fidelity)`` — a
genome scored at one rung re-scores (never aliases) at another.  On a card,
every worker's gate and timing hold the card's lock (``device.card_lock``):
one timer per card, however many workers share it.
"""
from repro_torch.core.evals.backends import (BackendInfo, BatchScorer,
                                             EvalBackend, ProcessBackend,
                                             ThreadBackend, backend_info,
                                             default_worker_count,
                                             make_backend,
                                             make_process_executor,
                                             register_backend,
                                             registered_backends,
                                             unregister_backend)
from repro_torch.core.evals.cascade import DEFAULT_ETA, CascadeBackend
from repro_torch.core.evals.cache import (FIDELITIES, HLO, MEASURED, PERFMODEL,
                                          ScoreCache, fidelity_key, key_fidelity)
from repro_torch.core.evals.elastic import ElasticProcessPool
from repro_torch.core.evals.scorer import (CORRECTNESS_TOL, MACHINES,
                                           MEASURED_CALL_SPREAD,
                                           MEASURED_MIN_REL, InlineBackend,
                                           PairedGain, Scorer,
                                           batch_scoring_enabled,
                                           correctness_memo_stats,
                                           set_batch_scoring)
from repro_torch.core.evals.service import (ClientSession, EvalCoordinator,
                                            ServiceBackend,
                                            spawn_local_workers,
                                            stop_local_workers)
from repro_torch.core.evals.vector import ScoreVector
# importable for tests/internal callers, deliberately NOT in __all__ —
# wire-level helpers are implementation detail, not supported surface
from repro_torch.core.evals.worker import (EvalSpec, evaluate_frame,  # noqa: F401
                                           evaluate_frame_many,
                                           evaluate_genome, intern_spec,
                                           warm_worker, worker_stats)

__all__ = [
    "BackendInfo", "BatchScorer", "CORRECTNESS_TOL", "CascadeBackend",
    "DEFAULT_ETA",
    "ClientSession", "ElasticProcessPool", "EvalBackend", "EvalCoordinator",
    "EvalSpec", "FIDELITIES", "HLO", "InlineBackend", "MACHINES", "MEASURED",
    "MEASURED_CALL_SPREAD", "MEASURED_MIN_REL", "PERFMODEL", "PairedGain",
    "ProcessBackend", "ScoreCache", "ScoreVector", "Scorer", "ServiceBackend",
    "ThreadBackend", "backend_info", "default_worker_count",
    "evaluate_genome", "make_backend", "make_process_executor",
    "register_backend", "registered_backends", "spawn_local_workers",
    "stop_local_workers", "unregister_backend",
    "batch_scoring_enabled", "correctness_memo_stats", "fidelity_key",
    "key_fidelity", "set_batch_scoring",
]
