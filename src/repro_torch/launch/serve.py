"""Serving: prefill and batched decode-step factories, and a static-batch
request server.  The counterpart of ``repro.launch.serve`` on one device.

PyTorch runs eagerly, so the factories return plain closures where the JAX
package jits; the decode cache is updated in place instead of donated.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode_step, prefill


def make_serve_step(cfg: ArchConfig, compute_dtype=torch.bfloat16,
                    impl: Optional[str] = None):
    """One decode step for the whole batch."""

    def serve_step(params, cache, token):
        return decode_step(params, cfg, cache, token, compute_dtype=compute_dtype,
                           impl=impl)

    return serve_step


def make_prefill(cfg: ArchConfig, max_len: int, compute_dtype=torch.bfloat16,
                 impl: Optional[str] = None, genome: Optional[dict] = None):
    def prefill_step(params, tokens, **extras):
        return prefill(params, cfg, tokens, max_len, compute_dtype=compute_dtype,
                       impl=impl, genome=genome, **extras)

    return prefill_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    output: list = field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Static-batch server: groups pending requests to the batch size,
    prefills together (right-aligned, padded on the left with token 0, which
    the prompts attend to, as in the JAX package), then decodes greedily in
    lockstep, on the device the parameters lie on.

    ``timings`` gets one entry per group: the prefill's milliseconds (prompt
    to first token) and each decode step's, read from CUDA events on the card
    (so they include the host's time between steps) and from the host clock
    on the CPU."""

    def __init__(self, cfg: ArchConfig, params, batch_size: int = 4,
                 max_len: int = 256, compute_dtype=torch.float32,
                 impl: Optional[str] = None):
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self._compute_dtype = compute_dtype
        self._impl = impl
        self._device = params["embed"].device
        self._serve = make_serve_step(cfg, compute_dtype, impl=impl)
        self.timings: list = []

    def _mark(self):
        if self._device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def _ms(a, b) -> float:
        return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else 1e3 * (b - a)

    def run(self, requests: list) -> list:
        for i in range(0, len(requests), self.batch_size):
            self.run_group(requests[i:i + self.batch_size])
        return requests

    def run_group(self, group: list) -> None:
        B = len(group)
        plen = max(len(r.prompt) for r in group)
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(group):
            toks[i, plen - len(r.prompt):] = r.prompt     # right-align
        marks = [self._mark()]
        logits, cache = prefill(
            self.params, self.cfg, torch.from_numpy(toks).to(self._device),
            self.max_len, compute_dtype=self._compute_dtype,
            cache_dtype=self._compute_dtype, impl=self._impl)
        token = torch.argmax(logits, -1)
        marks.append(self._mark())
        steps = max(r.max_new_tokens for r in group)
        for _ in range(steps):
            host = token.tolist()
            for i, r in enumerate(group):
                if not r.done and len(r.output) < r.max_new_tokens:
                    r.output.append(int(host[i]))
                    r.done = len(r.output) >= r.max_new_tokens
            if all(r.done for r in group):
                break
            logits, cache = self._serve(self.params, cache, token)
            token = torch.argmax(logits, -1)
            marks.append(self._mark())
        if isinstance(marks[-1], torch.cuda.Event):
            marks[-1].synchronize()
        self.timings.append({
            "batch": B, "prompt_len": plen,
            "prefill_ms": self._ms(marks[0], marks[1]),
            "decode_ms": [self._ms(a, b) for a, b in zip(marks[1:], marks[2:])]})
