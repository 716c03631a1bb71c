"""Serving: prefill and batched decode-step factories, and a static-batch
request server.  The counterpart of ``repro.launch.serve``.

The factories return plain closures: PyTorch runs them eagerly, about 200
operations a decode step.  Where the JAX package compiles the step once
(``jax.jit`` with the cache donated), ``BatchedServer`` on a CUDA device
captures it once in a CUDA graph and replays it (``graph``): the cache,
its position (a 0-d device tensor, as the JAX package's int32 array) and
the token are the graph's static inputs, written in place by each replay,
and the greedy choice runs inside the graph, so a step is one launch and
the host only copies the new token out.  On the CPU, and under a process
group, the step runs eagerly, the cache updated in place instead of
donated.

Under a mesh (``distributed.context.set_mesh``, parameters placed by
``distributed.sharding.distribute_params``) the server runs the same loop,
eagerly: every rank passes the whole group's tokens, and the logits, a
DTensor, are gathered before the greedy choice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import context as ctx
from repro_torch.distributed import spmd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.models import attention, decode_step, prefill, ssm, transformer
from repro_torch.tree import tree_leaves, tree_map


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


def _whole(t):
    """The full tensor of a DTensor (every rank gets it); a tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


# The port's host counters: each kernel wrapper's launches (an attribute,
# and its tallies by body and by rep), and the models' route counts.  A
# captured step moves them once, at capture, where nothing is launched;
# each replay adds that move again.
_KERNELS = (fa.flash_attention, fd.flash_decode, ssd_mod.ssd_chunked)
_ROUTES = (attention, ssm, transformer, ref, spmd)        # modules with ``counts``


def _tally() -> dict:
    t = {}
    for fn in _KERNELS:
        t[fn, "launches", None] = fn.launches
        for attr in ("launches_by_body", "launches_by_rep"):
            t.update(((fn, attr, k), n) for k, n in getattr(fn, attr, {}).items())
    for mod in _ROUTES:
        t.update(((mod, "counts", k), n) for k, n in mod.counts.items())
    return t


def _bump(delta: dict, times: int) -> None:
    for (owner, attr, key), n in delta.items():
        if key is None:
            setattr(owner, attr, getattr(owner, attr) + times * n)
        else:
            tally = getattr(owner, attr)
            tally[key] = tally.get(key, 0) + times * n


def _signature(cache, token) -> tuple:
    """What a captured step fixes: every cache tensor's shape and dtype, the
    cache's host values (``enc_len``) and the token's shape."""
    return tuple((tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
                 for t in tree_leaves(cache)) + (tuple(token.shape),)


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class GraphedStep:
    """One decode step captured in a CUDA graph: the port's counterpart of
    the JAX package's jitted step with its cache donated.  ``step`` is
    ``make_serve_step``'s; its static inputs are ``cache`` (every tensor
    and ``pos``) and ``token`` (B,).  A step decodes, writes the cache,
    advances ``pos`` and puts the greedy choice in ``token``, all in place;
    ``logits`` holds its logits (once captured, the graph's output, which
    each replay overwrites).

    ``warm`` runs the step eagerly on the capturing ``stream``: a real step,
    which also loads the kernels and readies the stream's buffers (cuBLAS's
    workspace, ``flash_decode``'s split counters, keyed by stream).
    ``capture`` records the step; the host counters it moved (launches,
    route counts) go back, since a capture launches nothing, and each
    ``replay`` (on the capturing stream) adds them again.  ``load`` copies
    another cache and token of the same shapes into the static ones.  All
    of them refuse to run under ``ops.checking``, whose check reads values
    on the host; a capture that fails raises."""

    def __init__(self, step, params, cache, token, stream=None):
        self.step, self.params, self.cache, self.token = step, params, cache, token
        self.key = _signature(cache, token)
        self.stream = stream or torch.cuda.Stream(token.device)
        self.graph, self.moved, self.capture_ms, self.logits = None, {}, None, None

    @staticmethod
    def _refuse_checking() -> None:
        if ops.checking_active():
            raise RuntimeError("a graphed decode step cannot hold its launches against "
                               "the plain versions (ops.checking reads values on the host); "
                               "run the step eagerly")

    def _run(self) -> None:
        self.logits, new = self.step(self.params, self.cache, self.token)
        self.cache["pos"].copy_(new["pos"])
        self.token.copy_(torch.argmax(self.logits, -1))

    def _on_stream(self, fn) -> tuple:
        """``fn()`` on the capturing stream, after the current stream's work
        and before its next; the events around it."""
        self._refuse_checking()
        cur = torch.cuda.current_stream(self.token.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            a = _event()
            fn()
            b = _event()
        cur.wait_stream(self.stream)
        return a, b

    def warm(self) -> None:
        self._on_stream(self._run)

    def capture(self) -> None:
        self._refuse_checking()
        torch.cuda.synchronize(self.token.device)
        t0 = time.perf_counter()
        before = _tally()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            self._run()
        after = _tally()
        self.moved = {k: n - before.get(k, 0) for k, n in after.items()
                      if n != before.get(k, 0)}
        _bump(self.moved, -1)
        self.graph = graph
        self.capture_ms = 1e3 * (time.perf_counter() - t0)

    def replay(self) -> tuple:
        span = self._on_stream(self.graph.replay)
        _bump(self.moved, 1)
        return span

    def load(self, cache, token) -> None:
        if _signature(cache, token) != self.key:
            raise ValueError("the cache and token do not have the captured shapes")
        tree_map(lambda dst, src: dst.copy_(src) if isinstance(dst, torch.Tensor) else None,
                 self.cache, cache)
        self.token.copy_(token)


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
    lockstep, on the device the parameters lie on.  An encoder-decoder's
    encoder reads zero frames of the group's prompt length, as in the JAX
    package (the speech frontend is a stub).

    ``graph`` (None: on a CUDA device with no process group) replays the
    decode step as a CUDA graph, the port's ``jax.jit``.  A group whose
    shapes (batch, cache length, cross-cache length) no graph holds runs
    its first step eagerly on a side stream, which warms up the kernels and
    the stream, then captures the step over its own cache and token; a
    later group of those shapes copies its prefill cache and token into
    the captured ones.  Replays run on the capturing stream.  Asking for a
    graph on the CPU or under a process group raises, a failed capture
    raises, and so does a graphed step under ``ops.checking`` (the check
    reads values on the host): nothing falls back to the eager step.
    ``graph_log`` holds each capture's and each copy's milliseconds.

    ``timings`` gets one entry per group: the prefill's milliseconds (prompt
    to first token) and each decode step's, read from CUDA events on the card
    (so they include the host's time between steps, but not a capture) and
    from the host clock on the CPU; on a graph, also each replay's span on
    the card (``replay_ms``)."""

    def __init__(self, cfg: ArchConfig, params, batch_size: int = 4,
                 max_len: int = 256, compute_dtype=torch.float32,
                 impl: Optional[str] = None, graph: Optional[bool] = None):
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self._compute_dtype = compute_dtype
        self._impl = impl
        self._device = params["embed"].device
        self._serve = make_serve_step(cfg, compute_dtype, impl=impl)
        grouped = dist.is_available() and dist.is_initialized() or ctx.get_mesh() is not None
        if graph is None:
            graph = self._device.type == "cuda" and not grouped
        elif graph and grouped:
            raise NotImplementedError("under a process group the decode step runs eagerly: "
                                      "no graph captures its collectives yet")
        elif graph and self._device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the parameters on a CUDA device, not "
                             f"{self._device}")
        self.graph = graph
        self._stream = torch.cuda.Stream(self._device) if graph else None
        self._graphed: Optional[GraphedStep] = None
        self.graph_log = {"capture_ms": [], "copy_ms": []}
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

    def _first_step(self, cache, token, copies: list) -> bool:
        """The group's first decode step on the graph's static tensors;
        whether a capture is due.  Where the held graph has the group's
        shapes, the prefill cache and token are copied into its static
        tensors and the graph replays; else the step runs eagerly (``warm``)
        over the group's own tensors, which the capture then takes as
        static."""
        held = self._graphed
        if held is not None and held.key == _signature(cache, token):
            copies.append(self._mark())
            held.load(cache, token)
            copies.append(self._mark())
            return False
        self._graphed = None                         # its pool goes with it
        held = GraphedStep(self._serve, self.params, cache, token, self._stream)
        held.warm()
        self._graphed = held
        return True

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
        extras = {}
        if self.cfg.enc_dec:            # the JAX package's zero frames
            extras["enc_frames"] = torch.zeros(
                (B, plen, self.cfg.d_model), dtype=self._compute_dtype,
                device=self._device)
        start = self._mark()
        logits, cache = prefill(
            self.params, self.cfg, torch.from_numpy(toks).to(self._device),
            self.max_len, compute_dtype=self._compute_dtype,
            cache_dtype=self._compute_dtype, impl=self._impl, **extras)
        token = torch.argmax(_whole(logits), -1)
        end = self._mark()
        spans, replays, copies = [(start, end)], [], []
        steps = max(r.max_new_tokens for r in group)
        for t in range(steps):
            host = token.tolist()
            for i, r in enumerate(group):
                if not r.done and len(r.output) < r.max_new_tokens:
                    r.output.append(int(host[i]))
                    r.done = len(r.output) >= r.max_new_tokens
            if all(r.done for r in group):
                break
            begin, capture = end, False
            if not self.graph:
                logits, cache = self._serve(self.params, cache, token)
                token = torch.argmax(_whole(logits), -1)
            else:
                capture = t == 0 and self._first_step(cache, token, copies)
                if not capture:
                    replays.append(self._graphed.replay())
                token = self._graphed.token
            end = self._mark()
            spans.append((begin, end))
            if capture:                 # after the step's span, before the next one's
                self._graphed.capture()
                self.graph_log["capture_ms"].append(self._graphed.capture_ms)
                end = self._mark()
        if isinstance(end, torch.cuda.Event):
            end.synchronize()
        if copies:
            self.graph_log["copy_ms"].append(self._ms(*copies))
        entry = {"batch": B, "prompt_len": plen, "prefill_ms": self._ms(*spans[0]),
                 "decode_ms": [self._ms(a, b) for a, b in spans[1:]]}
        if self.graph:
            entry["replay_ms"] = [self._ms(a, b) for a, b in replays]
        self.timings.append(entry)
