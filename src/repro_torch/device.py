"""Device resolution for the port's entry points.

The port's entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and on a host without a CUDA device it
raises instead of quietly running the CPU path.  Tests and CPU tooling pass
``device="cpu"``.

A CUDA device also gets IEEE fp32 matrix products: the correctness gate holds
fp32 results to ``CORRECTNESS_TOL = 2e-5``, which TF32 (about three decimal
digits) fails, so the fp32 oracle must not run in TF32.

One timer per card: :func:`card_lock` serialises the CUDA work of every
process and thread that scores on one card (the correctness gate, the timed
section, the baselines).  Two timings at once on one card would perturb each
other past the measured rung's commit floor, and so would a gate running
beside a timing.  The lock is an ``fcntl.flock`` on a file named by the
card's UUID under ``build/locks/`` (listed in ``.gitignore``); flock locks
belong to an open file, so two threads of one process exclude each other as
two processes do.  Each process records the seconds it waited and the
``time.monotonic()`` span of every section it held (``CLOCK_MONOTONIC`` is
system-wide on Linux, so spans of different processes compare):
:func:`card_lock_stats`.
"""
from __future__ import annotations

import collections
import contextlib
import fcntl
import threading
import time
from pathlib import Path
from typing import ContextManager, Optional, Union

import torch

LOCK_DIR = Path(__file__).resolve().parents[2] / "build" / "locks"
SPANS_KEPT = 4096          # held sections a process remembers, per card


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run its plain PyTorch path")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def device_name(device: torch.device) -> str:
    """The name a result is filed under: the card's, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class CardLock:
    """The inter-process lock of one card, and this process's record of it."""

    def __init__(self, path: Path, device: torch.device):
        self.path = path
        self.device = device
        self._stats = threading.Lock()
        self.wait_s = 0.0
        self.sections = 0
        self.spans: collections.deque = collections.deque(maxlen=SPANS_KEPT)

    @contextlib.contextmanager
    def held(self):
        """Hold the card for the block; its queued work is finished (a
        synchronise) before the lock is let go."""
        t0 = time.monotonic()
        with open(self.path, "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            t1 = time.monotonic()
            try:
                yield
                torch.cuda.synchronize(self.device)
            finally:
                t2 = time.monotonic()
                fcntl.flock(f, fcntl.LOCK_UN)
                with self._stats:
                    self.wait_s += t1 - t0
                    self.sections += 1
                    self.spans.append((t1, t2))

    def stats(self) -> dict:
        with self._stats:
            return {"wait_s": self.wait_s, "sections": self.sections,
                    "spans": list(self.spans)}


_CARD_LOCKS: dict = {}            # card UUID -> CardLock
_CARD_LOCKS_GUARD = threading.Lock()


def card_lock(device: Union[str, torch.device]) -> ContextManager:
    """Hold ``device``'s card for a block of CUDA work; a no-op context on
    any other device type, and where no card is present to be shared."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return contextlib.nullcontext()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    with _CARD_LOCKS_GUARD:
        lock = _CARD_LOCKS.get(uuid)
        if lock is None:
            LOCK_DIR.mkdir(parents=True, exist_ok=True)
            lock = _CARD_LOCKS[uuid] = CardLock(
                LOCK_DIR / f"card-{uuid}.lock", torch.device("cuda", index))
    return lock.held()


def card_lock_stats() -> dict:
    """``{card UUID: {"wait_s", "sections", "spans"}}`` of this process."""
    with _CARD_LOCKS_GUARD:
        locks = dict(_CARD_LOCKS)
    return {uuid: lock.stats() for uuid, lock in locks.items()}
