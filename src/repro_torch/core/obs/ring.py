"""Bounded event ring: the in-memory sink behind every event list.

``EventRing`` replaces the unbounded ``list`` accumulators
(``EvalCoordinator.events``, ``IslandEvolution.commit_events``) that grew
without limit on long frontier runs.  It keeps the last ``cap`` events in a
``collections.deque`` and counts what it sheds, so ``stats()`` surfaces can
report both the window and how much history fell off the back.

The ring deliberately quacks like the list it replaces — ``len``,
iteration, indexing (int and slice), ``append``, truthiness — so existing
reads like ``sum(1 for e in events if ...)`` and ``list(events)`` keep
working unchanged.
"""
from __future__ import annotations

import os
import threading
from collections import deque

# default window; REPRO_OBS_RING_CAP resizes it process-wide (tests and
# memory-tight deployments shrink it, forensic runs grow it)
DEFAULT_CAP = int(os.environ.get("REPRO_OBS_RING_CAP", "4096"))


class EventRing:
    """A bounded, thread-safe, list-alike event window.

    ``dropped`` counts events shed off the back — the forensic "you are
    looking at a window, not the whole run" signal for stats surfaces.
    """

    def __init__(self, cap: int = DEFAULT_CAP):
        if cap < 1:
            raise ValueError(f"ring cap must be >= 1, got {cap}")
        self.cap = cap
        self.dropped = 0
        self._dq: deque = deque(maxlen=cap)
        self._lock = threading.Lock()

    def append(self, event) -> None:
        with self._lock:
            if len(self._dq) == self.cap:
                self.dropped += 1
            self._dq.append(event)

    def snapshot(self) -> list:
        """A consistent copy of the current window (oldest first)."""
        with self._lock:
            return list(self._dq)

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()
            self.dropped = 0

    # -- list-alike views ------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def __iter__(self):
        return iter(self.snapshot())

    def __getitem__(self, i):
        with self._lock:
            if isinstance(i, slice):
                return list(self._dq)[i]
            return self._dq[i]

    def __bool__(self) -> bool:
        return len(self) > 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"EventRing(cap={self.cap}, len={len(self)}, "
                f"dropped={self.dropped})")
