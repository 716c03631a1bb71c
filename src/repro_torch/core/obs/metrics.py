"""Process-wide metrics registry: counters, gauges, histograms with labels.

One registry (``REGISTRY``) owns every instrument.  Call sites hold the
instrument object itself — ``self._hits = REGISTRY.counter("cache_hits",
cache="c3")`` — so the hot path is a plain attribute increment, not a
registry lookup.  Instruments are get-or-create keyed by
``(name, sorted(labels))``: two call sites asking for the same name+labels
share one instrument, which is how the legacy ``stats()`` dicts and the
registry stay in agreement without double counting.

Everything here is stdlib-only and cheap: a Counter increment is one
``+=`` under the GIL (int ``+=`` on an attribute is not strictly atomic
across threads, so the instruments take a lock only where a read-modify-
write races — Counter/Gauge use a plain lock-free add because every
producer call site in this codebase already increments under its own
structure lock or from a single thread; Histogram locks because it
updates four fields together).
"""
from __future__ import annotations

import threading
from typing import Iterator


class Counter:
    """Monotonic counter.  ``value`` is readable and (for absorption of
    legacy mutable-int attributes like ``ScoreCache.hits``) settable."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Counter({self.name}{dict(self.labels)} = {self.value})"


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Gauge({self.name}{dict(self.labels)} = {self.value})"


class Histogram:
    """Count/total/min/max summary (no buckets — the report CLI derives
    means; full distributions belong in the journal, not in memory)."""

    __slots__ = ("name", "labels", "count", "total", "min", "max", "_lock")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Histogram({self.name}{dict(self.labels)} "
                f"n={self.count} mean={self.mean:.4g})")


class MetricsRegistry:
    """Get-or-create instrument allocator keyed by (name, sorted labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict = {}

    def _get(self, cls, name: str, labels: dict):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, key[1])
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(f"{name}{labels} already registered as "
                                f"{type(inst).__name__}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def instruments(self) -> Iterator:
        with self._lock:
            return iter(list(self._instruments.values()))

    def snapshot(self) -> list[dict]:
        """Serializable dump of every instrument (journal epilogue, report
        CLI, tests)."""
        out = []
        for inst in self.instruments():
            row = {"kind": type(inst).__name__.lower(), "name": inst.name,
                   "labels": dict(inst.labels)}
            if isinstance(inst, Histogram):
                row.update(count=inst.count, total=inst.total,
                           min=(None if inst.count == 0 else inst.min),
                           max=(None if inst.count == 0 else inst.max))
            else:
                row["value"] = inst.value
            out.append(row)
        return out

    def reset(self) -> None:
        """Drop every instrument (tests only — live objects holding an
        instrument keep their reference, so reset between engines, not
        mid-run)."""
        with self._lock:
            self._instruments.clear()


# the process-wide registry; modules grab instruments at object-construction
# time, not import time, so tests can reset() between engines
REGISTRY = MetricsRegistry()
