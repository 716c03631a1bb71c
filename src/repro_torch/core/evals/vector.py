"""ScoreVector — the value of the AVO scoring function ``f`` at one genome.

``f(x) = (f_1(x), ..., f_n(x))`` — one entry per benchmark configuration
(paper §3.1).  A candidate failing *numerical correctness* scores zero on
every configuration regardless of throughput; a candidate that is infeasible
on a configuration (VMEM overflow — the TPU analogue of a launch failure)
scores zero on that configuration.

The vector is a plain picklable dataclass: the process evaluation backend
ships it across worker boundaries verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ScoreVector:
    config_names: tuple
    values: tuple                 # TFLOPS per config (0 = failed/infeasible)
    correct: bool
    failure: str = ""
    profiles: dict = field(default_factory=dict)   # name -> Profile

    @property
    def geomean(self) -> float:
        vals = [v for v in self.values]
        if not vals or any(v <= 0 for v in vals):
            return 0.0
        return float(np.exp(np.mean(np.log(vals))))

    def dominant_bottleneck(self) -> str:
        """Aggregate bottleneck across configs, weighted by modelled time."""
        agg: dict[str, float] = {}
        for p in self.profiles.values():
            if not p.feasible:
                agg["vmem"] = agg.get("vmem", 0.0) + 1.0
                continue
            for term, t in (("mxu", p.t_mxu), ("vpu", p.t_vpu_exposed),
                            ("dma", p.t_dma_exposed), ("overhead", p.t_overhead),
                            ("bubble", p.t_bubble)):
                agg[term] = agg.get(term, 0.0) + t
        return max(agg, key=agg.get) if agg else "mxu"
