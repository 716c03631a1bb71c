"""repro_torch.core.obs — the unified telemetry plane.

One process-wide event bus (:data:`BUS`), a metrics registry
(:data:`REGISTRY`), trace-id propagation for the evaluation lifecycle, and
a JSONL run journal with a report CLI
(``python -m repro_torch.core.obs.report``).  A copy of ``repro.core.obs``:
the journal format is the same, so either package's report reads the
other's journals.

Telemetry is **off by default** and gated by the ``REPRO_OBS`` env var or
:func:`set_enabled`.  The contract
every producer call site honours:

- **zero-cost when disabled** — hot paths guard with ``if obs.enabled():``
  before building any event dict, so a disabled run pays one truthy check;
- **lineage-inert when enabled** — telemetry reads state, it never feeds
  back into scoring, scheduling order, or RNG draws, so lineages are
  bit-identical obs off vs on.

``narrate`` is the one unconditional publisher: it replaces the engines'
``verbose=True`` ``print()``s, so it fires exactly where those prints
fired (the console sink renders it; the journal records it when enabled).
"""
from __future__ import annotations

import os
import time as _time

from .bus import ConsoleSink, EventBus, JournalSink
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .ring import DEFAULT_CAP, EventRing
from .trace import current_trace, new_trace, use_trace

__all__ = [
    "BUS", "REGISTRY", "ConsoleSink", "Counter", "DEFAULT_CAP", "EventBus",
    "EventRing", "Gauge", "Histogram", "JournalSink", "MetricsRegistry",
    "close_journal", "current_trace", "enabled", "ensure_journal",
    "journal_path", "narrate", "new_trace", "publish", "set_enabled",
    "span", "use_trace",
]

# env seeds the module default, set_enabled() flips it at runtime
_ENABLED = os.environ.get("REPRO_OBS", "0") != "0"

BUS = EventBus()
BUS.add_sink(ConsoleSink())

_JOURNAL: JournalSink | None = None


def enabled() -> bool:
    """Is telemetry on?  The one check every hot-path call site makes."""
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Runtime toggle (the env var only seeds the default)."""
    global _ENABLED
    _ENABLED = bool(on)


def publish(event: str, **fields) -> None:
    """Publish iff enabled — the convenience form for call sites that
    don't need to skip dict construction (cold paths)."""
    if _ENABLED:
        BUS.publish(event, **fields)


def narrate(msg: str, **fields) -> None:
    """Verbose-line replacement: publishes unconditionally (call sites are
    already gated on ``verbose=True``), so the console sink prints exactly
    what ``print()`` used to and the journal keeps the same line."""
    BUS.publish("narrate", msg=msg, **fields)


def span(name: str, trace, dur_s=None, **fields) -> None:
    """Publish one lifecycle span (iff enabled).  ``trace`` may be None for
    spans recorded outside any trace — they still land in the journal but
    stitch to nothing."""
    if _ENABLED:
        BUS.publish("span", span=name, trace=trace,
                    **({} if dur_s is None else {"dur_s": round(dur_s, 6)}),
                    **fields)


# -- run journal ---------------------------------------------------------------

def ensure_journal(run_id=None, root="results/runs"):
    """Attach the JSONL journal sink (idempotent).  Returns the journal
    path, or None when telemetry is disabled — engines call this at run
    start so an enabled run always journals without any extra setup."""
    global _JOURNAL
    if not _ENABLED:
        return None
    if _JOURNAL is None:
        rid = run_id or os.environ.get("REPRO_OBS_RUN_ID") \
            or f"run-{os.getpid()}-{int(_time.time())}"
        _JOURNAL = JournalSink(os.path.join(root, str(rid), "journal.jsonl"))
        BUS.add_sink(_JOURNAL)
        BUS.publish("journal_open", run_id=str(rid), pid=os.getpid())
    return _JOURNAL.path


def journal_path():
    """Path of the attached journal, or None."""
    return None if _JOURNAL is None else _JOURNAL.path


def close_journal() -> None:
    """Detach and close the journal sink (tests; end-of-run flush)."""
    global _JOURNAL
    if _JOURNAL is not None:
        BUS.remove_sink(_JOURNAL)
        _JOURNAL.close()
        _JOURNAL = None
