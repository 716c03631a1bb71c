"""Lineage / population management.

``P_{t+1} = Update(P_t, (x_{t+1}, f(x_{t+1})))`` — this module is the
population side of Eq. (1).  The paper's study instantiates AVO in a
single-lineage regime (§3.3): every member is a *committed version* (passed
correctness AND matched-or-improved the running-best benchmark score); failed
internal attempts stay in the agent's trajectory, not here.  The structure is
operator-agnostic: archive-based or island-based regimes can reuse it.

Commits persist as JSON (the analogue of the paper's git-commit-per-version),
so a killed evolution resumes exactly where it stopped.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.evals import ScoreVector
from repro_torch.core.search_space import KernelGenome


@dataclass
class Commit:
    version: int
    genome: KernelGenome
    values: tuple                 # f(x) vector (TFLOPS per config)
    geomean: float
    note: str = ""                # the agent's commit message
    parent: Optional[int] = None
    internal_attempts: int = 0    # directions explored before this commit

    def to_json(self) -> dict:
        return {
            "version": self.version, "genome": json.loads(self.genome.key()),
            "values": list(self.values), "geomean": self.geomean,
            "note": self.note, "parent": self.parent,
            "internal_attempts": self.internal_attempts,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Commit":
        return cls(d["version"], KernelGenome.from_dict(d["genome"]),
                   tuple(d["values"]), d["geomean"], d.get("note", ""),
                   d.get("parent"), d.get("internal_attempts", 0))


class Lineage:
    def __init__(self, config_names: tuple = ()):
        self.commits: list[Commit] = []
        self.config_names = tuple(config_names)

    # -- Update ----------------------------------------------------------------
    def update(self, genome: KernelGenome, sv: ScoreVector, note: str = "",
               internal_attempts: int = 0) -> Commit:
        c = Commit(
            version=len(self.commits), genome=genome, values=sv.values,
            geomean=sv.geomean, note=note,
            parent=(self.commits[-1].version if self.commits else None),
            internal_attempts=internal_attempts)
        self.commits.append(c)
        if not self.config_names and sv.config_names:
            self.config_names = tuple(sv.config_names)
        return c

    # -- queries ----------------------------------------------------------------
    def __len__(self):
        return len(self.commits)

    def best(self) -> Optional[Commit]:
        return max(self.commits, key=lambda c: c.geomean) if self.commits else None

    def top(self, k: int) -> list[Commit]:
        """The ``k`` best commits with pairwise-distinct genomes, geomean
        descending (ties broken by commit version, so the order — and
        anything built on it, like the top-k migrant payload — is
        deterministic).  ``top(1)`` is ``[best()]``."""
        out, seen = [], set()
        for c in sorted(self.commits, key=lambda c: (-c.geomean, c.version)):
            key = c.genome.key()
            if key in seen:
                continue
            seen.add(key)
            out.append(c)
            if len(out) == k:
                break
        return out

    def head(self) -> Optional[Commit]:
        return self.commits[-1] if self.commits else None

    def running_best(self) -> list[float]:
        out, best = [], 0.0
        for c in self.commits:
            best = max(best, c.geomean)
            out.append(best)
        return out

    def trajectory(self) -> dict:
        """Per-config + running-best series (Fig. 5/6 data)."""
        per_cfg = {name: [c.values[i] for c in self.commits]
                   for i, name in enumerate(self.config_names)}
        return {"geomean": [c.geomean for c in self.commits],
                "running_best": self.running_best(),
                "per_config": per_cfg,
                "notes": [c.note for c in self.commits]}

    # -- persistence --------------------------------------------------------------
    def to_payload(self) -> dict:
        return {"config_names": list(self.config_names),
                "commits": [c.to_json() for c in self.commits]}

    @classmethod
    def from_payload(cls, payload: dict) -> "Lineage":
        ln = cls(tuple(payload["config_names"]))
        ln.commits = [Commit.from_json(c) for c in payload["commits"]]
        return ln

    def save(self, path: str) -> None:
        atomic_write_json(path, self.to_payload())

    @classmethod
    def load(cls, path: str) -> "Lineage":
        with open(path) as f:
            return cls.from_payload(json.load(f))


def atomic_write_json(path: str, payload: dict) -> None:
    """Write-to-temp + rename, so a killed writer never leaves a torn file
    (the islands engine and Lineage both persist through this)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)     # atomic commit
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
