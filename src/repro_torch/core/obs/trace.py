"""Trace-id minting and thread-local propagation.

A *trace* ties every span of one evaluation lifecycle together: minted at
``Island.propose``, carried through the backend submit path (thread-local,
so the synchronous ``Toolbelt.submit_evaluations`` call inherits it without
plumbing a parameter through every signature), attached to service TASKS
frames for capable workers, and stitched back by the coordinator.

Ids are ``t<host-token><counter>`` — the host token (pid-derived) keeps ids
from colliding when several engine processes append to journals under the
same run directory; the counter keeps them ordered and deterministic
*within* a process, which is what the tests stitch on.
"""
from __future__ import annotations

import itertools
import os
import threading

_TLS = threading.local()
_COUNTER = itertools.count()


def new_trace() -> str:
    """Mint a fresh trace id (cheap: one counter tick + a format)."""
    return f"t{os.getpid() % 100000:05d}-{next(_COUNTER):06d}"


def current_trace():
    """The trace bound to this thread, or None outside any trace."""
    return getattr(_TLS, "trace", None)


class use_trace:
    """Context manager binding ``trace`` to the current thread, restoring
    the previous binding on exit (re-entrant: harvest nests inside the
    engine loop which may itself run under a job trace)."""

    __slots__ = ("trace", "_prev")

    def __init__(self, trace):
        self.trace = trace

    def __enter__(self):
        self._prev = getattr(_TLS, "trace", None)
        _TLS.trace = self.trace
        return self.trace

    def __exit__(self, *exc):
        _TLS.trace = self._prev
        return False
