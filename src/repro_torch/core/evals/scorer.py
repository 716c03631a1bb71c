"""The inline evaluation path on the card: correctness gate + throughput rung.

Correctness is executed for real: the genome's flash-attention kernel runs on
the seed-derived proxy shapes (``PROXY_SEQ`` tokens, head_dim 64, fp32,
blocks clamped by :meth:`Scorer._clamped_kwargs`) against the oracle
``kernels.ref.mha_reference`` at ``CORRECTNESS_TOL``.  On a CUDA device the
gate runs the hand-written sm_90a kernel in IEEE fp32; on ``device="cpu"`` it
runs the kernel's plain PyTorch version.  Throughput depends on the rung:

- ``perfmodel`` (rung 0): a model of one machine, chosen by ``machine``:
  ``"tpu_v5e"`` (the default) is ``perfmodel.estimate``, the reference's TPU
  v5e model, verbatim, so lineages match the JAX package; ``"h100"`` is
  ``perfmodel_h100.estimate``, the model of this port's kernel on the card.
  Their TFLOP/s are a model's output, not a time on the card.
- ``hlo`` (rung 1): the launch rung 2 times, counted rather than run.  Per
  suite config, at its full shape and window with the genome's own blocks,
  the body a bf16 launch takes at that head_dim is walked in physical CTAs
  and chunks as the kernel's ``Walk`` visits them
  (``perfmodel_h100.walk_counts``); each chunk and each CTA's epilogue
  counts the operations of its plain step (``chunk_step_plain``,
  ``cta_epilogue_plain``) traced once on the meta device
  (``launch/trace_analysis.py``).  The modelled time adds the tensor-core
  and CUDA-core work, and the single stage's chunk loads at
  ``kv_in_grid=False``; the ring's HBM traffic overlaps them; the card's
  launch overhead (:data:`LAUNCH_S`) is added.  The score is
  ``useful_flops(cfg)`` over that time, rung 2's unit.  The counterpart of
  the reference's HLO trace and ``HloAnalysis.summary`` roofline, which
  score the proxy launch its rung 2 times; the port's rung 2 times the full
  shapes, so rung 1 follows it there.  It is a pure function of (genome,
  suite): it takes no card lock and gives the same values on the card and
  on ``device="cpu"``.  A count or trace that raises is a fault of the
  port, never a 0.0 (the reference scores it 0.0).
- ``measured`` (rung 2): times the kernel on the card at each suite config's
  full shape in bf16 with CUDA events (1 warm-up, median of 3) and reports
  ``useful_flops(cfg)`` / time.  It refuses ``device="cpu"``: there is no
  modelled timer filed under a device's name.  Its feasibility and the
  profiles the agent plans from come from the ``"h100"`` model.

Rungs 1 and 2 gate each config on the card's model,
``perfmodel_h100.estimate(g, cfg).feasible``, and attach the profiles of the
planning machine's model.

:meth:`Scorer.score_batch` is the reference's batch path: one
``estimate_batch`` call per slate at rung 0 (the chosen machine's), each
genome in turn at rungs 1 and 2.  :meth:`Scorer.baselines` gives the
paper's yardsticks per suite config: at rungs 0 and 1 the reference's expert
and FA genomes through the chosen machine's model (exactly the reference's
under ``"tpu_v5e"``); at the measured rung the TFLOP/s of PyTorch's
``scaled_dot_product_attention`` under its cuDNN backend (``"expert"``) and
its FlashAttention backend (``"fa_reference"``), timed with this rung's own
timer on this rung's own inputs.  They are yardsticks: nothing on the
evolved path calls them.

The measured rung is a timing, so two scorings of one genome differ, most
of all between calls.  Its commit decision reads :meth:`Scorer.paired_gain`
instead: candidate and incumbent timed in turns in one locked section,
where drift between calls hits both sides alike.  A lineage scored there
commits an edit only when that paired gain exceeds ``MEASURED_MIN_REL``,
set above the spread of a genome paired against itself on the card
(``core/evolution.py::PairedAgent`` applies it; rung 0 keeps the agent's
own 1e-4 and its decision, so its lineages stay equal to the JAX
package's).

Decision, diverging from the reference: the JAX ``_timed_values`` times the
*proxy* shape and counts FLOPs from the compiled HLO.  The port times the
suite's full shapes, where the card does real work, and counts FLOPs with
``useful_flops`` (the FlashAttention convention), so a genome's score is the
rate a user of that shape would see.

On a card, the gate, the timed section and the baselines each hold the
card's lock (``device.card_lock``): any number of scorers, in threads or in
worker processes, time one at a time per card.

:class:`Scorer` is a deterministic function of the genome at rungs 0 and 1:
the proxy inputs are rebuilt from ``rng_seed`` with numpy exactly as the
reference builds them.  :meth:`Scorer.score_key` and
:meth:`Scorer.structural_key` carry the device type and the machine, so the
plain and the kernel gate, and the two models, never answer each other from
the memo.
"""
from __future__ import annotations

import functools
import itertools
import math
import os
import statistics
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import obs
from repro_torch.core.evals.cache import (FIDELITIES, HLO, MEASURED, PERFMODEL,
                                          ScoreCache, fidelity_key)
from repro_torch.core.evals.vector import ScoreVector
from repro_torch.core import perfmodel, perfmodel_h100
from repro_torch.core.perfmodel import BenchConfig, mha_suite, useful_flops
from repro_torch.core.search_space import KernelGenome
from repro_torch.device import card_lock, resolve_device
from repro_torch.launch.trace_analysis import trace_summary

CORRECTNESS_TOL = 2e-5

# rung 0's machines: the reference's TPU v5e model (lineage parity with the
# JAX package) and the model of this port's kernel on the H100
MACHINES = ("tpu_v5e", "h100")
_MODELS = {"tpu_v5e": perfmodel, "h100": perfmodel_h100}


def default_machine(fidelity: str) -> str:
    """The machine rung 0 models when none is named: the card's at the
    measured rung, the reference's TPU v5e otherwise."""
    return "h100" if fidelity == MEASURED else "tpu_v5e"


def rung_key(genome: KernelGenome, fidelity: str, plan_machine: str,
             device_type: str) -> str:
    """The cache/dedup key of a genome scored at ``fidelity``, planned on
    ``plan_machine``, on a device of ``device_type`` (suffixed, so
    ``key_fidelity`` still reads the rung)."""
    return f"{fidelity_key(genome.key(), fidelity)}@{plan_machine}@{device_type}"

# rung 1's launch overhead: seconds per launch of flash_attention's fp32
# body at its smallest shape, (1, 1, 16, 64), 200 back to back through the
# wrapper, CUDA events: 32.48 us on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py's cascade phase, which re-measures it every run; PERF.md).
# What a launch of this port costs its caller, host issue included.
LAUNCH_S = 3.248e-5

# the measured rung: CUDA-event timing, 1 warm-up then the median of 3
TIMING_WARMUP = 1
TIMING_REPS = 3

# the paired commit rule (Scorer.paired_gain): rounds of the candidate and
# the incumbent timed in turns per config, after one warm-up launch each
PAIRED_REPS = 6
# cycles of the spin kernel queued ahead of each round (about 100 us at the
# H100's clocks): the card is still busy with it when the host has issued
# the round's first launch, so neither side's time holds host issue time
PAIRED_SPIN_CYCLES = 200_000

# The commit floor of the measured rung: an edit commits only when its
# paired gain (Scorer.paired_gain) over the incumbent exceeds this.
# Derivation: 8 paired comparisons of a genome against itself, for the seed
# and the pipelined genome on mha_suite and on gqa_suite (chip_smoke.py's
# noise phase, on an NVIDIA H100 80GB HBM3 at 700 W).  The largest |gain|
# over the runs of the paired rule so far is 1.07 % (mha_suite, pipelined
# genome, read with 4 rounds and no synchronise after the warm-ups); the
# floor sits 1.5x above it, the margin the first floor was set with.
# Unpaired scorings of the same genomes spread up to 5.49 %: the floor was
# 7.5 % while commits compared geomeans scored apart.  PERF.md keeps the
# runs.
MEASURED_MIN_REL = 0.0161

# The spread of unpaired scorings: the tolerance of any comparison of
# geomeans scored apart (a slate through a pool against inline, a search's
# best against a reference scored earlier), and the unpaired loss past
# which the paired agent refutes a candidate without pairing it.  It is
# the floor commits read while they compared geomeans scored apart: 1.5x
# the largest spread of 8 unpaired scorings of one genome then measured
# on an NVIDIA H100 80GB HBM3 at 700 W (4.97 %; the noise phase has read
# up to 5.49 % since, and fails above this).  Pairing narrows what a
# commit sees, not what two calls see.
MEASURED_CALL_SPREAD = 0.075

# ---------------------------------------------------------------------------
# batch-path switch
# ---------------------------------------------------------------------------

# One switch degrades Scorer.score_batch to the scalar path, as in the
# reference; seeded from the same environment variable.
_BATCH_SCORING = os.environ.get("REPRO_BATCH_SCORING", "1") != "0"


def set_batch_scoring(enabled: bool) -> None:
    """Globally enable/disable the columnar slate-scoring path (process-wide)."""
    global _BATCH_SCORING
    _BATCH_SCORING = bool(enabled)


def batch_scoring_enabled() -> bool:
    return _BATCH_SCORING

# ---------------------------------------------------------------------------
# structure-keyed correctness memo
# ---------------------------------------------------------------------------

CHECK_MEMO_CAP = 256


class _CorrectnessMemo:
    """Bounded LRU over *structural* correctness keys.

    The gate run in :meth:`Scorer.check` depends only on the genome's
    kernel-structural fields after the proxy block clamp, the proxy shape
    set, the RNG seed and the device type — not on the whole genome.
    Process-wide: every Scorer in the process shares it."""

    def __init__(self, cap: int = CHECK_MEMO_CAP):
        self.cap = cap
        self._lock = threading.Lock()
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return None

    def put(self, key, value) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.cap:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = 0
            self.misses = 0

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._data), "cap": self.cap}


_CHECK_MEMO = _CorrectnessMemo()
# rung 1's trace counts of one chunk step or one CTA epilogue: they depend
# only on the body, the head_dim, the chunk-level genome axes and the mask
# (no shape, no seed, no device)
_TRACE_MEMO = _CorrectnessMemo()


def correctness_memo_stats() -> dict:
    """Hit/miss/size counters of the process-wide correctness memo."""
    return _CHECK_MEMO.stats()

# proxy geometry of the correctness check: small enough to run per genome,
# big enough that blocks/windows survive
PROXY_SEQ = 160


def _proxy_window(window: Optional[int], ref_seq: int) -> Optional[int]:
    """Scale a suite config's window onto the proxy sequence length, clamped
    so it stays a *partial* window on the proxy (floor 16, ceiling
    ``PROXY_SEQ - 32``)."""
    if window is None:
        return None
    ref_seq = max(int(ref_seq), 1)
    return max(16, min(PROXY_SEQ - 32, round(window * PROXY_SEQ / ref_seq)))


def _correctness_proxy_shapes(suite: Sequence[BenchConfig]):
    """Small executable shapes covering the mask/window/GQA space of the
    suite: one shape per distinct ``(causal, proxy window)`` pair."""
    shapes = []
    seen = set()
    has_gqa = any(c.n_heads != c.n_kv_heads for c in suite)
    for causal in sorted({c.causal for c in suite}):
        windows = sorted({c.window for c in suite}, key=lambda w: (w is None, w))
        for window in windows:
            ref_seq = max((c.seq_len for c in suite if c.window == window),
                          default=PROXY_SEQ)
            w = _proxy_window(window, ref_seq)
            if (causal, w) in seen:
                continue
            seen.add((causal, w))
            shapes.append(dict(B=1, Hq=4, Hkv=(2 if has_gqa else 4),
                               S=PROXY_SEQ, D=64, causal=causal, window=w))
    return shapes


def full_shape_inputs(cfg: BenchConfig, device: torch.device, seed: int):
    """bf16 q, k, v at a suite config's full shape, from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape_q = (cfg.batch, cfg.n_heads, cfg.seq_len, cfg.head_dim)
    shape_kv = (cfg.batch, cfg.n_kv_heads, cfg.seq_len, cfg.head_dim)
    return tuple(torch.randn(s, generator=gen, device=device,
                             dtype=torch.bfloat16)
                 for s in (shape_q, shape_kv, shape_kv))


# ---------------------------------------------------------------------------
# rung 1: the launch rung 2 times, counted
# ---------------------------------------------------------------------------

def _chunk_axes(genome: KernelGenome) -> tuple:
    """(rescale_mode, div_mode, acc_dtype) as a chunk step runs them: the
    loop body (kv_in_grid=False) always rescales without a branch and
    divides at the end, as the kernel's ``GRID &&`` guards make it."""
    ring = genome.kv_in_grid
    return (genome.rescale_mode if ring else "branchless",
            genome.div_mode if ring else "deferred", genome.acc_dtype)


def _tile_summary(body, D: int, axes: tuple, mask) -> dict:
    """``trace_summary`` of one chunk step (``mask``: None for an unmasked
    chunk, else (causal, windowed)) or, with ``mask="epilogue"``, of one
    CTA's epilogue, on meta tensors at ``body``'s tile and head_dim ``D``.
    Memoized in ``_TRACE_MEMO``: the counts depend on nothing else."""
    from repro_torch.kernels.flash_attention import (chunk_step_plain,
                                                     cta_epilogue_plain)
    key = (body.name, D, axes, mask)
    summary = _TRACE_MEMO.get(key)
    if summary is None:
        rescale_mode, div_mode, acc_dtype = axes

        def meta(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")
        acc, l = meta(body.rows, D), meta(body.rows)
        if mask == "epilogue":
            summary = trace_summary(cta_epilogue_plain, acc, l, div_mode=div_mode)
        else:
            q, k, v = (meta(n, D, dtype=torch.bfloat16)
                       for n in (body.rows, body.chunk, body.chunk))
            causal, windowed = mask or (False, False)
            summary = trace_summary(
                chunk_step_plain, q, k, v, acc, meta(body.rows), l,
                meta(body.rows, 1, dtype=torch.int64), 0, scale=D ** -0.5,
                causal=causal, window=1 if windowed else None,
                k_limit=body.chunk, masked=mask is not None,
                rescale_mode=rescale_mode, div_mode=div_mode, acc_dtype=acc_dtype)
        _TRACE_MEMO.put(key, summary)
    return summary


def rung1_counts(genome: KernelGenome, cfg: BenchConfig) -> dict:
    """The work of the launch rung 2 times at ``cfg``'s full shape: the
    body a bf16 launch takes at that head_dim, walked in CTAs of
    ``body.rows`` rows over chunks of ``body.chunk`` keys as the kernel's
    ``Walk`` and ``classify`` visit them (``perfmodel_h100.walk_counts``,
    packed rows under ``gqa_pack``), over every head and batch.  Each chunk
    and each CTA's epilogue counts the operations of its traced step
    (:func:`_tile_summary`).  ``bytes`` is the launch's compulsory traffic:
    q and o once, K and V once per (batch, KV head).  ``stage_bytes`` is
    the K and V of every visited chunk where the walk has one stage
    (kv_in_grid=False), else 0."""
    body = perfmodel_h100.body_for(cfg)
    D = perfmodel_h100.kernel_head_dim(cfg.head_dim)
    chunks, masked, _ = perfmodel_h100.walk_counts(genome, cfg, body)
    rep = cfg.n_heads // cfg.n_kv_heads
    heads = cfg.batch * (cfg.n_kv_heads if genome.gqa_pack and rep > 1
                         else cfg.n_heads)
    n_chunks, n_masked = heads * int(chunks.sum()), heads * int(masked.sum())
    n_ctas = heads * int(chunks.size)
    axes = _chunk_axes(genome)
    free = _tile_summary(body, D, axes, None)
    hidden = _tile_summary(body, D, axes, (cfg.causal, cfg.window is not None))
    epilogue = _tile_summary(body, D, axes, "epilogue")

    def total(key):
        return ((n_chunks - n_masked) * free[key] + n_masked * hidden[key]
                + n_ctas * epilogue[key])
    esize = perfmodel_h100.BF16_BYTES
    return {"dot_flops": total("dot_flops"), "other_ops": total("ew_flops"),
            "bytes": esize * D * cfg.batch * cfg.seq_len
            * 2 * (cfg.n_heads + cfg.n_kv_heads),
            "stage_bytes": 0 if genome.kv_in_grid
            else n_chunks * 2 * body.chunk * D * esize}


def rung1_seconds(counts: dict) -> float:
    """The modelled time of a :func:`rung1_counts` launch: the tensor-core
    and CUDA-core work added (a consumer warpgroup issues them in turn);
    the single stage's chunk loads added too (each chunk is loaded only
    after the consumers release the stage); the compulsory HBM traffic
    overlapped under them, as the TMA ring streams it; plus
    :data:`LAUNCH_S`."""
    compute = (counts["dot_flops"] / perfmodel_h100.PEAK_FLOPS
               + counts["other_ops"] / perfmodel_h100.FP32_OPS
               + counts["stage_bytes"] / perfmodel_h100.HBM_BW)
    return max(compute, counts["bytes"] / perfmodel_h100.HBM_BW) + LAUNCH_S


def rung1_tflops(genome: KernelGenome, cfg: BenchConfig) -> float:
    """The rung-1 score of one config: ``useful_flops(cfg)`` over the
    modelled time, in TFLOP/s, the unit rung 2 reports."""
    return useful_flops(cfg) / rung1_seconds(rung1_counts(genome, cfg)) / 1e12


def time_cuda_ms(fn, warmup: int = TIMING_WARMUP, reps: int = TIMING_REPS) -> float:
    """Median milliseconds of ``fn()`` on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_pair_ms(first, second, swap: bool) -> tuple[float, float]:
    """One round of the paired timing: ``first()`` and ``second()`` queued
    back to back on the current stream behind a spin kernel, each between
    its own CUDA events, then one synchronise.  ``swap`` launches
    ``second`` first.  Returns (ms of ``first``, ms of ``second``)."""
    order = (second, first) if swap else (first, second)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda._sleep(PAIRED_SPIN_CYCLES)
    for i, fn in enumerate(order):
        events[2 * i].record()
        fn()
        events[2 * i + 1].record()
    events[3].synchronize()
    ms = (events[0].elapsed_time(events[1]), events[2].elapsed_time(events[3]))
    return ms[::-1] if swap else ms


@dataclass(frozen=True)
class PairedGain:
    """:meth:`Scorer.paired_gain`'s answer: the candidate's gain over the
    incumbent (the geomean of the per-config ratios, minus 1), each timed
    config's ratio t_incumbent / t_candidate (the median over rounds), the
    host seconds the comparison took, and each config's ratio per round
    (the incumbent launched first in rounds 0, 2, ...)."""
    gain: float
    ratios: dict
    seconds: float
    rounds: dict


class Scorer:
    """Callable scoring function with per-genome memoization.

    The memo lives in ``self.cache`` (a :class:`ScoreCache`); pass one in to
    share it, or read it afterwards.  ``device=None`` is the card.
    ``machine`` picks rung 0's model (:data:`MACHINES`; default
    ``"tpu_v5e"``); the measured rung takes ``"h100"`` only.  ``plan_machine``
    is the machine whose model gives the profiles the agent plans from.
    ``_plan_machine`` is for the planning A/B only: at the measured rung it
    attaches that machine's profiles instead of the card's (feasibility stays
    the card's).  ``service_latency_s`` > 0 holds every paid evaluation for
    that long and changes no value, as in the reference.
    """

    def __init__(self, suite: Optional[Sequence[BenchConfig]] = None,
                 check_correctness: bool = True, rng_seed: int = 0,
                 cache: Optional[ScoreCache] = None,
                 service_latency_s: float = 0.0,
                 fidelity: str = PERFMODEL,
                 device: Optional[Union[str, torch.device]] = None,
                 machine: Optional[str] = None,
                 _plan_machine: Optional[str] = None):
        for m in (machine, _plan_machine):
            if m is not None and m not in MACHINES:
                raise ValueError(f"unknown machine {m!r}; known: {MACHINES}")
        if fidelity == MEASURED and machine not in (None, "h100"):
            raise ValueError(
                "the measured rung plans from the card's model: machine must "
                f"be 'h100', got {machine!r}")
        if _plan_machine is not None and fidelity != MEASURED:
            raise ValueError("_plan_machine is for the measured rung's planning A/B")
        if fidelity not in FIDELITIES:
            raise ValueError(f"unknown fidelity {fidelity!r}; "
                             f"known: {FIDELITIES}")
        self.device = resolve_device(device)
        if fidelity == MEASURED and self.device.type != "cuda":
            raise ValueError(
                "fidelity='measured' times the kernel on a CUDA device; "
                f"device={self.device} has nothing to time")
        self.suite = list(suite) if suite is not None else mha_suite()
        self.check_correctness = check_correctness
        self.rng_seed = rng_seed
        self.service_latency_s = service_latency_s
        self.fidelity = fidelity
        self.machine = machine or default_machine(fidelity)
        self.plan_machine = _plan_machine or self.machine
        self._model = _MODELS[self.machine]
        self.cache = cache if cache is not None else ScoreCache()
        # paid-eval counter: itertools.count().__next__ is GIL-atomic
        self._eval_count = itertools.count()
        self._proxy_lock = threading.Lock()
        self._proxy_inputs = None
        self._shape_sig = None
        self._full_inputs: dict = {}
        self._baselines: Optional[dict] = None
        self.baseline_errors: dict = {}

    @property
    def n_evaluations(self) -> int:
        """Paid (uncached) evaluations so far."""
        r = repr(self._eval_count)
        return int(r[r.index("(") + 1:-1])

    # -- correctness ----------------------------------------------------------
    def warm(self) -> None:
        """Build the RNG-derived proxy inputs, and at the measured rung the
        full-shape inputs, eagerly (a no-op once built)."""
        if not (self.check_correctness or self.fidelity == MEASURED):
            return
        with card_lock(self.device):
            if self.check_correctness:
                self._proxy_data()
            if self.fidelity == MEASURED:
                for cfg in self.suite:
                    self.full_inputs(cfg)

    def _proxy_data(self):
        """The reference's proxy inputs, bit for bit: float64 draws from
        ``np.random.default_rng(rng_seed)`` cast to fp32, then moved to the
        device."""
        if self._proxy_inputs is None:
            with self._proxy_lock:
                if self._proxy_inputs is not None:    # lost the build race
                    return self._proxy_inputs
                rng = np.random.default_rng(self.rng_seed)
                data = []
                for sh in _correctness_proxy_shapes(self.suite):
                    arrs = [rng.normal(size=(sh["B"], h, sh["S"], sh["D"]))
                            .astype(np.float32)
                            for h in (sh["Hq"], sh["Hkv"], sh["Hkv"])]
                    q, k, v = (torch.from_numpy(a).to(self.device) for a in arrs)
                    data.append((sh, q, k, v))
                self._proxy_inputs = data
        return self._proxy_inputs

    @staticmethod
    def _clamped_kwargs(genome: KernelGenome) -> dict:
        """Kernel kwargs with blocks scaled down onto the proxy shapes, so
        the structural path (grid/loop/skip/branch) is still exercised."""
        kw = genome.kernel_kwargs()
        kw["block_q"] = max(16, min(kw["block_q"], 2048) // 16)
        kw["block_k"] = max(16, min(kw["block_k"], 2048) // 16)
        return kw

    def structural_key(self, genome: KernelGenome) -> tuple:
        """The correctness-memo key: the device type, the machine, the
        proxy-shape signature, the input seed and the clamped kernel
        kwargs."""
        if self._shape_sig is None:
            self._shape_sig = tuple(sorted(
                (sh["B"], sh["Hq"], sh["Hkv"], sh["S"], sh["D"], sh["causal"],
                 -1 if sh["window"] is None else sh["window"])
                for sh in _correctness_proxy_shapes(self.suite)))
        kw = self._clamped_kwargs(genome)
        return (self.device.type, self.machine, self._shape_sig, self.rng_seed,
                tuple(sorted(kw.items())))

    def check(self, genome: KernelGenome) -> tuple[bool, str]:
        """Run the genome's kernel against the oracle — memoized per kernel
        structure in the process-wide bounded LRU."""
        key = self.structural_key(genome)
        cached = _CHECK_MEMO.get(key)
        if cached is not None:
            return cached
        result = self._check_uncached(genome)
        _CHECK_MEMO.put(key, result)
        return result

    def _check_uncached(self, genome: KernelGenome) -> tuple[bool, str]:
        # No try/except: every genome of the space builds and runs on the
        # kernel and on its plain version, so a raise is a fault of the
        # port to surface, never a verdict on the genome.
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.ref import mha_reference
        kw = self._clamped_kwargs(genome)
        with card_lock(self.device):
            for sh, q, k, v in self._proxy_data():
                o = flash_attention(q, k, v, causal=sh["causal"],
                                    window=sh["window"], **kw)
                r = mha_reference(q, k, v, causal=sh["causal"], window=sh["window"])
                err = float((o - r).abs().max())
                if not math.isfinite(err) or err > CORRECTNESS_TOL:
                    return False, (f"numerical mismatch vs oracle: "
                                   f"max|err|={err:.2e} on {sh}")
        return True, ""

    # -- scoring ----------------------------------------------------------------
    def score_key(self, genome: KernelGenome) -> str:
        """The cache/dedup key for this genome at this scorer's fidelity,
        planned on this machine, on this device type (:func:`rung_key`)."""
        return rung_key(genome, self.fidelity, self.plan_machine,
                        self.device.type)

    def __call__(self, genome: KernelGenome) -> ScoreVector:
        key = self.score_key(genome)
        sv = self.cache.get(key)
        if sv is not None:
            return sv
        sv = self.score_uncached(genome)
        self.cache.put(key, sv)
        return sv

    def score_uncached(self, genome: KernelGenome) -> ScoreVector:
        """Pay the full evaluation cost, bypassing the memo cache."""
        t0 = time.perf_counter()
        try:
            return self._score_uncached_inner(genome)
        finally:
            dur = time.perf_counter() - t0
            self.cache.record_eval_seconds(self.fidelity, dur)
            if obs.enabled():
                obs.span("score", obs.current_trace(), dur_s=dur,
                         rung=self.fidelity, n=1)

    def _score_uncached_inner(self, genome: KernelGenome) -> ScoreVector:
        next(self._eval_count)
        if self.service_latency_s > 0:
            time.sleep(self.service_latency_s)
        if self.check_correctness:
            ok, why = self.check(genome)
            if not ok:
                return ScoreVector(tuple(c.name for c in self.suite),
                                   tuple(0.0 for _ in self.suite), False,
                                   why)
        if self.fidelity == HLO:
            return self._assemble(*self._hlo_values(genome))
        if self.fidelity == MEASURED:
            return self._assemble(*self._measured_values(genome))
        values, profiles = [], {}
        for cfg in self.suite:
            p = self._model.estimate(genome, cfg)
            profiles[cfg.name] = p
            values.append(p.tflops if p.feasible else 0.0)
        return self._assemble(values, profiles)

    def score_batch(self, genomes: Sequence[KernelGenome]) -> list[ScoreVector]:
        """Batched :meth:`score_uncached`: pay the evaluation cost for every
        entry (no cache, no dedup) with one rung-0 model call for the whole
        slate (the machine's ``estimate_batch``) and one structural-memo
        lookup per genome.  Rungs 1 and 2 score each genome in turn.  The
        modelled service latency is held once per batch.  With the batch path
        disabled this *is* the scalar path."""
        genomes = list(genomes)
        if not genomes:
            return []
        if not _BATCH_SCORING:
            return [self.score_uncached(g) for g in genomes]
        t0 = time.perf_counter()
        try:
            for _ in genomes:
                next(self._eval_count)
            if self.service_latency_s > 0:
                time.sleep(self.service_latency_s)
            checks = ([self.check(g) for g in genomes]
                      if self.check_correctness
                      else [(True, "")] * len(genomes))
            out: list = [None] * len(genomes)
            todo = [i for i, (ok, why) in enumerate(checks) if ok]
            for i, (ok, why) in enumerate(checks):
                if not ok:
                    out[i] = ScoreVector(tuple(c.name for c in self.suite),
                                         tuple(0.0 for _ in self.suite),
                                         False, why)
            if self.fidelity == PERFMODEL:
                be = self._model.estimate_batch([genomes[i] for i in todo],
                                                self.suite)
                for k, i in enumerate(todo):
                    profiles = be.profiles(k)
                    values = [profiles[c.name].tflops
                              if profiles[c.name].feasible else 0.0
                              for c in self.suite]
                    out[i] = self._assemble(values, profiles)
            else:                     # rungs 1 and 2 stay scalar per genome
                rung = (self._hlo_values if self.fidelity == HLO
                        else self._measured_values)
                for i in todo:
                    out[i] = self._assemble(*rung(genomes[i]))
            return out
        finally:
            dur = time.perf_counter() - t0
            self.cache.record_eval_seconds(self.fidelity, dur)
            if obs.enabled():
                obs.span("score", obs.current_trace(), dur_s=dur,
                         rung=self.fidelity, n=len(genomes))

    def _assemble(self, values, profiles, gated=None) -> ScoreVector:
        """``gated``: the profiles whose feasibility gated ``values`` (the
        card's model at rungs 1 and 2), when they are not ``profiles``."""
        failure = ""
        gated = profiles if gated is None else gated
        if any(v == 0.0 for v in values):
            bad = [c.name for c, v in zip(self.suite, values) if v == 0.0]
            failure = "infeasible on: " + ", ".join(
                f"{n} ({gated[n].infeasible_reason})" if n in gated
                else n for n in bad)
        return ScoreVector(tuple(c.name for c in self.suite), tuple(values),
                           True, failure, profiles)

    # -- rung 1 -----------------------------------------------------------------
    def _hlo_values(self, genome: KernelGenome):
        """Rung 1: every config's launch scored by :func:`rung1_tflops`.  A
        config the card's model finds infeasible scores 0.0, as at the
        measured rung.  Returns (values, profiles attached, the card's
        profiles)."""
        profiles, card = self._card_profiles(genome)
        values = [rung1_tflops(genome, cfg) if card[cfg.name].feasible else 0.0
                  for cfg in self.suite]
        return values, profiles, card

    def _card_profiles(self, genome: KernelGenome) -> tuple:
        """(the profiles attached for the agent, the card model's profiles
        that gate each config's feasibility at rungs 1 and 2)."""
        profiles = self.measured_profiles(genome)
        card = (profiles if self.plan_machine == "h100" else
                {c.name: perfmodel_h100.estimate(genome, c) for c in self.suite})
        return profiles, card

    # -- the measured rung -----------------------------------------------------
    def full_inputs(self, cfg: BenchConfig):
        """bf16 inputs at ``cfg``'s full shape, made once per config."""
        if cfg.name not in self._full_inputs:
            self._full_inputs[cfg.name] = full_shape_inputs(
                cfg, self.device, self.rng_seed)
        return self._full_inputs[cfg.name]

    def _measured_values(self, genome: KernelGenome):
        """Rung 2: CUDA-event time of the kernel at every config's full
        shape; TFLOP/s = ``useful_flops(cfg)`` / median time.  A config the
        card's model finds infeasible scores 0.0, as in the reference.
        Returns (values, profiles attached, the card's profiles)."""
        from repro_torch.kernels.flash_attention import flash_attention
        kw = genome.kernel_kwargs()
        values = []
        profiles, card = self._card_profiles(genome)
        with card_lock(self.device):
            for cfg in self.suite:
                if not card[cfg.name].feasible:
                    values.append(0.0)
                    continue
                q, k, v = self.full_inputs(cfg)
                ms = time_cuda_ms(lambda: flash_attention(
                    q, k, v, causal=cfg.causal, window=cfg.window, **kw))
                values.append(useful_flops(cfg) / (ms * 1e-3) / 1e12)
        return values, profiles, card

    def paired_gain(self, incumbent: KernelGenome,
                    candidate: KernelGenome) -> PairedGain:
        """The measured rung's commit rule: both genomes timed in turns, in
        one locked section, at every config both are feasible on (the
        card's model), at its full shape on the inputs both share.  Per
        config: one warm-up launch each, a synchronise, then
        :data:`PAIRED_REPS` rounds in the order A B, B A, A B, ... so that a
        linear drift and the launch position cancel; the
        config's ratio is the median over rounds of t_incumbent /
        t_candidate.  ``useful_flops`` is equal on both sides, so the gain
        is the TFLOP/s ratio.  The L2 cache is left as the launches leave
        it: both sides find it in the same state.  Raises off the measured
        rung and off a card."""
        if self.fidelity != MEASURED or self.device.type != "cuda":
            raise ValueError(
                "paired_gain times two genomes on a CUDA device at the measured "
                f"rung; this scorer is at {self.fidelity!r} on {self.device}")
        from repro_torch.kernels.flash_attention import flash_attention
        t0 = time.perf_counter()
        cfgs = [c for c in self.suite
                if all(perfmodel_h100.estimate(g, c).feasible
                       for g in (incumbent, candidate))]
        rounds = {}
        with card_lock(self.device):
            for cfg in cfgs:
                q, k, v = self.full_inputs(cfg)
                inc, cand = (functools.partial(
                    flash_attention, q, k, v, causal=cfg.causal,
                    window=cfg.window, **g.kernel_kwargs())
                    for g in (incumbent, candidate))
                inc()
                cand()
                # every round starts from an idle card: a first round queued
                # behind the warm-ups times its first launch unlike the rest
                torch.cuda.synchronize(self.device)
                rounds[cfg.name] = [a / b for a, b in (
                    time_pair_ms(inc, cand, r % 2 == 1) for r in range(PAIRED_REPS))]
        ratios = {name: statistics.median(rs) for name, rs in rounds.items()}
        gain = math.exp(statistics.fmean(math.log(r) for r in ratios.values())) - 1.0
        return PairedGain(gain, ratios, time.perf_counter() - t0, rounds)

    def measured_profiles(self, genome: KernelGenome) -> dict:
        """``{config name: Profile}`` rungs 1 and 2 attach for the agent to
        plan from: ``plan_machine``'s model (at the measured rung the card's,
        or the planning A/B's)."""
        model = _MODELS[self.plan_machine]
        return {cfg.name: model.estimate(genome, cfg) for cfg in self.suite}

    # -- the paper's yardsticks ------------------------------------------------
    def baselines(self) -> dict:
        """Expert (cuDNN) and FA-reference TFLOP/s per suite config, under the
        keys ``"expert"`` and ``"fa_reference"``.  Rung 0: the reference's
        two genomes modelled by the chosen machine (under ``"tpu_v5e"`` the
        reference's values, exactly).  Measured rung: SDPA under
        ``SDPBackend.CUDNN_ATTENTION`` and ``SDPBackend.FLASH_ATTENTION``,
        timed once per scorer.  A config a backend refuses gets ``None``, its
        error text in ``self.baseline_errors[key][config name]``; no other
        backend stands in."""
        if self.fidelity != MEASURED:
            return {
                "expert": tuple(self._model.expert_reference(c) for c in self.suite),
                "fa_reference": tuple(self._model.fa_reference(c)
                                      for c in self.suite),
            }
        if self._baselines is None:
            from torch.nn.attention import SDPBackend
            with card_lock(self.device):
                self._baselines = {
                    key: tuple(self._sdpa_tflops(cfg, key, backend)
                               for cfg in self.suite)
                    for key, backend in (("expert", SDPBackend.CUDNN_ATTENTION),
                                         ("fa_reference",
                                          SDPBackend.FLASH_ATTENTION))}
        return dict(self._baselines)

    def _sdpa_tflops(self, cfg: BenchConfig, key: str, backend) -> Optional[float]:
        """TFLOP/s of one SDPA backend at ``cfg``'s full shape, or None (the
        reason kept in ``baseline_errors``)."""
        from torch.nn.attention import sdpa_kernel
        from torch.nn.functional import scaled_dot_product_attention
        errors = self.baseline_errors.setdefault(key, {})
        if cfg.window is not None:
            errors[cfg.name] = (f"window {cfg.window}: SDPA takes no sliding "
                                "window without an explicit mask, which changes "
                                "the work")
            return None
        q, k, v = self.full_inputs(cfg)
        kw = dict(is_causal=cfg.causal)
        if cfg.n_heads != cfg.n_kv_heads:
            kw["enable_gqa"] = True
        try:
            with sdpa_kernel(backend):
                ms = time_cuda_ms(lambda: scaled_dot_product_attention(q, k, v, **kw))
        except RuntimeError as e:          # the backend refused this config
            errors[cfg.name] = str(e)[:300]
            return None
        return useful_flops(cfg) / (ms * 1e-3) / 1e12


class InlineBackend(Scorer):
    """The ``inline`` evaluation backend: everything in the calling thread,
    plus the uniform backend surface (``map``/``submit``/``prefetch``/
    ``close``).  ``overlapping`` is False: ``submit`` evaluates at once."""

    overlapping = False
    max_workers = 1

    @property
    def cache_hits(self) -> int:
        return self.cache.hits

    def map(self, genomes: Sequence[KernelGenome]) -> list[ScoreVector]:
        return [self(g) for g in genomes]

    def submit(self, genome: KernelGenome):
        """Evaluate NOW, return a completed future."""
        import concurrent.futures
        fut: concurrent.futures.Future = concurrent.futures.Future()
        try:
            fut.set_result(self(genome))
        except Exception as e:          # pragma: no cover - scorer rarely raises
            fut.set_exception(e)
        return fut

    def prefetch(self, genomes: Sequence[KernelGenome]) -> None:
        """No-op: inline evaluation has no spare capacity to warm with."""

    def close(self) -> None:
        pass
