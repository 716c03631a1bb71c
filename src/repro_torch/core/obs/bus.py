"""The event bus: one bounded ring + pluggable sinks.

``EventBus.publish`` stamps the event dict with a monotonic-ish wall time
relative to bus construction, appends it to the bounded ring, and fans it
out to every attached sink.  Sinks are fire-and-forget: a sink that raises
is disabled for the event (exception swallowed) — telemetry must never take
the run down.

Built-in sinks:

- ``ConsoleSink`` prints ``narrate`` events (the old ``verbose=True``
  ``print()`` lines) so console output and the journal can't disagree.
- ``JournalSink`` appends every event as one JSON line to a run journal
  (``results/runs/<run_id>/journal.jsonl``); non-JSON values degrade to
  ``repr`` so a weird payload can't kill the writer.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path

from .ring import DEFAULT_CAP, EventRing


class ConsoleSink:
    """Prints narration lines — the replacement for engine ``print()``s."""

    def emit(self, event: dict) -> None:
        if event.get("event") == "narrate":
            print(event.get("msg", ""))


class JournalSink:
    """Append-only JSONL writer for the run journal."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, event: dict) -> None:
        line = json.dumps(event, default=repr, separators=(",", ":"))
        with self._lock:
            if self._fh.closed:  # pragma: no cover - emit-after-close race
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


class EventBus:
    """Ring + sinks.  ``publish`` is the single entry point; callers gate
    on ``obs.enabled()`` themselves so a disabled run never reaches here
    from a hot path (``narrate`` is the exception — it replaces prints
    that only fired under ``verbose=True`` anyway)."""

    def __init__(self, cap: int = DEFAULT_CAP):
        self.ring = EventRing(cap)
        self._sinks: list = []
        self._sink_lock = threading.Lock()
        self._t0 = time.time()

    def add_sink(self, sink) -> None:
        with self._sink_lock:
            self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._sink_lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def publish(self, event: str, **fields) -> dict:
        ev = {"event": event, "t": round(time.time() - self._t0, 6)}
        ev.update(fields)
        self.ring.append(ev)
        with self._sink_lock:
            sinks = tuple(self._sinks)
        for sink in sinks:
            try:
                sink.emit(ev)
            except Exception:   # telemetry must never take the run down
                pass
        return ev
