"""Explicit score-cache API shared by every evaluation backend.

One :class:`ScoreCache` memoizes ``score key -> ScoreVector``.  It is the
*only* supported way to read or seed memoized scores: backends, the island
engine, and tests all go through this API instead of poking scorer
internals.  All access is thread-safe; hit/miss accounting is built in so
shared-cache savings are observable (``IslandReport.cache_hits``).

Score keys carry the evaluation *fidelity* (:func:`fidelity_key`): the
baseline ``perfmodel`` rung keys by the bare ``genome.key()`` — every
existing call site and persisted payload stays valid — and the higher rungs
of the evaluation cascade (``hlo``, ``measured``) prefix the genome key, so
one shared cache can hold a genome's score at several fidelities without the
rungs ever aliasing each other.
"""
from __future__ import annotations

import itertools
import threading
from typing import Optional

from repro_torch.core import obs
from repro_torch.core.evals.vector import ScoreVector

# the evaluation-cascade fidelity ladder, cheapest rung first.  Defined here
# (the dependency floor of repro_torch.core.evals) so the scorer, the worker spec,
# and the backends all share one source of truth without import cycles.
PERFMODEL, HLO, MEASURED = "perfmodel", "hlo", "measured"
FIDELITIES = (PERFMODEL, HLO, MEASURED)

_FID_SEP = "::"


def fidelity_key(genome_key: str, fidelity: str = PERFMODEL) -> str:
    """The cache/dedup key for scoring ``genome_key`` at ``fidelity``.

    Rung 0 (``perfmodel``) keys are the bare genome key — bit-compatible
    with every pre-cascade call site (engine peeks, test seeding, persisted
    caches).  Higher rungs prefix, so a genome scored at rung 0 re-scores at
    rung 2 instead of aliasing onto the cheap result."""
    if fidelity == PERFMODEL:
        return genome_key
    if fidelity not in FIDELITIES:
        raise ValueError(
            f"unknown fidelity {fidelity!r}; known: {FIDELITIES}")
    return f"{fidelity}{_FID_SEP}{genome_key}"


def key_fidelity(key: str) -> str:
    """Inverse of :func:`fidelity_key`: which rung a cache key belongs to.
    Genome keys are sorted JSON over identifier-ish field values, so a
    recognized ``fidelity::`` prefix is unambiguous."""
    fid, sep, _rest = key.partition(_FID_SEP)
    return fid if sep and fid in FIDELITIES else PERFMODEL


# per-instance registry label: the metrics registry is process-global and
# caches are many (one per suite per engine), so each cache gets a distinct
# label instead of all aliasing one counter
_CACHE_IDS = itertools.count()


class ScoreCache:
    """Thread-safe ``key -> ScoreVector`` memo with hit/miss accounting.

    The hit/miss counters live in the process metrics registry
    (``obs.REGISTRY``) labelled per cache instance; ``self.hits`` /
    ``self.misses`` stay readable (and settable) exactly as before — the
    legacy surface is now a view of the registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, ScoreVector] = {}
        cid = f"c{next(_CACHE_IDS)}"
        self._m_hits = obs.REGISTRY.counter("score_cache_hits", cache=cid)
        self._m_misses = obs.REGISTRY.counter("score_cache_misses", cache=cid)
        self._eval_seconds: dict[str, float] = {}

    @property
    def hits(self) -> int:
        return self._m_hits.value

    @hits.setter
    def hits(self, v: int) -> None:
        self._m_hits.value = v

    @property
    def misses(self) -> int:
        return self._m_misses.value

    @misses.setter
    def misses(self, v: int) -> None:
        self._m_misses.value = v

    def get(self, key: str) -> Optional[ScoreVector]:
        """Counted lookup: increments ``hits`` or ``misses``."""
        with self._lock:
            sv = self._data.get(key)
            if sv is None:
                self._m_misses.inc()
            else:
                self._m_hits.inc()
            return sv

    def peek(self, key: str) -> Optional[ScoreVector]:
        """Uncounted lookup — for speculative checks (prefetch) that should
        not inflate the hit statistics."""
        with self._lock:
            return self._data.get(key)

    def put(self, key: str, sv: ScoreVector) -> None:
        with self._lock:
            self._data[key] = sv

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def record_eval_seconds(self, fidelity: str, seconds: float) -> None:
        """Accumulate paid-evaluation wall time against a fidelity rung.
        Scorers call this on every uncached evaluation, so the cascade's
        per-rung cost claims are measured, not modelled.  The accounting
        lives where the scores land: a process/service parent whose workers
        pay evaluation elsewhere records ~0 here, while in-process backends
        (inline/thread, the cascade smoke) record real wall time."""
        with self._lock:
            self._eval_seconds[fidelity] = (
                self._eval_seconds.get(fidelity, 0.0) + seconds)

    def stats(self) -> dict:
        """Hit/miss counters plus per-fidelity entry counts and paid-eval
        wall time — how cascade savings are observed per island
        (``Toolbelt.stats``/``IslandReport.score_caches``): the entry split
        shows how many genomes paid which rung, ``eval_seconds`` what each
        rung actually cost."""
        with self._lock:
            per_fidelity: dict[str, int] = {}
            for key in self._data:
                fid = key_fidelity(key)
                per_fidelity[fid] = per_fidelity.get(fid, 0) + 1
            return {
                "hits": self.hits,
                "misses": self.misses,
                "entries": len(self._data),
                "per_fidelity": per_fidelity,
                "eval_seconds": dict(self._eval_seconds),
            }
