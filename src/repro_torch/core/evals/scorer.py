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
- ``measured`` (rung 2): times the kernel on the card at each suite config's
  full shape in bf16 with CUDA events (1 warm-up, median of 3) and reports
  ``useful_flops(cfg)`` / time.  It refuses ``device="cpu"``: there is no
  modelled timer filed under a device's name.  Its feasibility and the
  profiles the agent plans from come from the ``"h100"`` model.
- ``hlo`` (rung 1) is not ported yet (ROADMAP Queue 1 item 6).

:meth:`Scorer.score_batch` is the reference's batch path: one
``estimate_batch`` call per slate at rung 0 (the chosen machine's), each
genome in turn at the measured rung.  :meth:`Scorer.baselines` gives the
paper's yardsticks per suite config: at rung 0 the reference's expert and FA
genomes through the chosen machine's model (exactly the reference's under
``"tpu_v5e"``); at the measured rung the TFLOP/s of PyTorch's
``scaled_dot_product_attention`` under its cuDNN backend (``"expert"``) and
its FlashAttention backend (``"fa_reference"``), timed with this rung's own
timer on this rung's own inputs.  They are yardsticks: nothing on the
evolved path calls them.

The measured rung is a timing, so two scorings of one genome differ.  A
lineage scored there commits an edit only when it gains more than
``MEASURED_MIN_REL``, set above the spread of repeated scorings measured on
the card (``core/evolution.py`` applies it; rung 0 keeps the agent's own
1e-4, so its lineages stay equal to the JAX package's).

Decision, diverging from the reference: the JAX ``_timed_values`` times the
*proxy* shape and counts FLOPs from the compiled HLO.  The port times the
suite's full shapes, where the card does real work, and counts FLOPs with
``useful_flops`` (the FlashAttention convention), so a genome's score is the
rate a user of that shape would see.  Each config's value is still gated on
the rung-0 model's feasibility, as in the reference, but on the card's
model: ``perfmodel_h100.estimate(g, cfg).feasible``.

:class:`Scorer` is a deterministic function of the genome at rung 0: the
proxy inputs are rebuilt from ``rng_seed`` with numpy exactly as the
reference builds them.  :meth:`Scorer.score_key` and
:meth:`Scorer.structural_key` carry the device type and the machine, so the
plain and the kernel gate, and the two models, never answer each other from
the memo.
"""
from __future__ import annotations

import itertools
import math
import os
import statistics
import threading
import time
from collections import OrderedDict
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
from repro_torch.device import resolve_device

CORRECTNESS_TOL = 2e-5

# rung 0's machines: the reference's TPU v5e model (lineage parity with the
# JAX package) and the model of this port's kernel on the H100
MACHINES = ("tpu_v5e", "h100")
_MODELS = {"tpu_v5e": perfmodel, "h100": perfmodel_h100}

# the measured rung: CUDA-event timing, 1 warm-up then the median of 3
TIMING_WARMUP = 1
TIMING_REPS = 3

# The commit floor of the measured rung: an edit commits only when its
# geomean beats the parent's by more than this.  Derivation: 8 scorings of
# one genome, each paid anew, for the seed and the pipelined genome on
# mha_suite and on gqa_suite (chip_smoke.py's noise phase, two runs on an
# NVIDIA H100 80GB HBM3 at 700 W).  Two scorings of one genome differed by
# at most max / min - 1 = 3.32 % of the geomean (mha_suite, whose shapes run
# shortest; 0.86-1.10 % on gqa_suite), at a relative standard deviation of
# at most 1.01 %.  The floor sits 1.5x above that spread: were the timings
# normal, a no-op edit would gain more than 5 % in about one comparison in
# 4000 (3.5 standard deviations of a ratio of two scorings).  PERF.md keeps
# the runs.
MEASURED_MIN_REL = 0.05

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


class Scorer:
    """Callable scoring function with per-genome memoization.

    The memo lives in ``self.cache`` (a :class:`ScoreCache`); pass one in to
    share it, or read it afterwards.  ``device=None`` is the card.
    ``machine`` picks rung 0's model (:data:`MACHINES`; default
    ``"tpu_v5e"``); the measured rung takes ``"h100"`` only.  ``plan_machine``
    is the machine whose model gives the profiles the agent plans from.
    ``_plan_machine`` is for the planning A/B only: at the measured rung it
    attaches that machine's profiles instead of the card's (feasibility stays
    the card's).
    """

    def __init__(self, suite: Optional[Sequence[BenchConfig]] = None,
                 check_correctness: bool = True, rng_seed: int = 0,
                 cache: Optional[ScoreCache] = None,
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
        if fidelity == HLO:
            raise NotImplementedError(
                "the hlo rung is not ported to the card yet (ROADMAP Queue 1 "
                "item 6); use fidelity='perfmodel' or 'measured'")
        self.device = resolve_device(device)
        if fidelity == MEASURED and self.device.type != "cuda":
            raise ValueError(
                "fidelity='measured' times the kernel on a CUDA device; "
                f"device={self.device} has nothing to time")
        self.suite = list(suite) if suite is not None else mha_suite()
        self.check_correctness = check_correctness
        self.rng_seed = rng_seed
        self.fidelity = fidelity
        self.machine = machine or ("h100" if fidelity == MEASURED else "tpu_v5e")
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
        """Build the RNG-derived proxy inputs eagerly (a no-op once built)."""
        if self.check_correctness:
            self._proxy_data()

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
        for sh, q, k, v in self._proxy_data():
            o = flash_attention(q, k, v, causal=sh["causal"], window=sh["window"],
                                **kw)
            r = mha_reference(q, k, v, causal=sh["causal"], window=sh["window"])
            err = float((o - r).abs().max())
            if not math.isfinite(err) or err > CORRECTNESS_TOL:
                return False, (f"numerical mismatch vs oracle: max|err|={err:.2e} "
                               f"on {sh}")
        return True, ""

    # -- scoring ----------------------------------------------------------------
    def score_key(self, genome: KernelGenome) -> str:
        """The cache/dedup key for this genome at this scorer's fidelity,
        planned on this machine, on this device type (suffixed, so
        ``key_fidelity`` still reads the rung)."""
        return (f"{fidelity_key(genome.key(), self.fidelity)}"
                f"@{self.plan_machine}@{self.device.type}")

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
        if self.check_correctness:
            ok, why = self.check(genome)
            if not ok:
                return ScoreVector(tuple(c.name for c in self.suite),
                                   tuple(0.0 for _ in self.suite), False,
                                   why)
        if self.fidelity == MEASURED:
            values, profiles = self._measured_values(genome)
        else:
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
        lookup per genome.  The measured rung times each genome in turn.  With the batch path
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
            else:                     # the measured rung stays scalar per genome
                for i in todo:
                    out[i] = self._assemble(*self._measured_values(genomes[i]))
            return out
        finally:
            dur = time.perf_counter() - t0
            self.cache.record_eval_seconds(self.fidelity, dur)
            if obs.enabled():
                obs.span("score", obs.current_trace(), dur_s=dur,
                         rung=self.fidelity, n=len(genomes))

    def _assemble(self, values, profiles) -> ScoreVector:
        failure = ""
        if any(v == 0.0 for v in values):
            bad = [c.name for c, v in zip(self.suite, values) if v == 0.0]
            failure = "infeasible on: " + ", ".join(
                f"{n} ({profiles[n].infeasible_reason})" if n in profiles
                else n for n in bad)
        return ScoreVector(tuple(c.name for c in self.suite), tuple(values),
                           True, failure, profiles)

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
        card's model finds infeasible scores 0.0, as in the reference."""
        from repro_torch.kernels.flash_attention import flash_attention
        kw = genome.kernel_kwargs()
        values, profiles = [], self.measured_profiles(genome)
        card = (profiles if self.plan_machine == "h100" else
                {c.name: perfmodel_h100.estimate(genome, c) for c in self.suite})
        for cfg in self.suite:
            if not card[cfg.name].feasible:
                values.append(0.0)
                continue
            q, k, v = self.full_inputs(cfg)
            ms = time_cuda_ms(lambda: flash_attention(
                q, k, v, causal=cfg.causal, window=cfg.window, **kw))
            values.append(useful_flops(cfg) / (ms * 1e-3) / 1e12)
        return values, profiles

    def measured_profiles(self, genome: KernelGenome) -> dict:
        """``{config name: Profile}`` the measured rung attaches for the
        agent to plan from: the card's model (``plan_machine``'s under the
        planning A/B)."""
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
            self._baselines = {
                key: tuple(self._sdpa_tflops(cfg, key, backend)
                           for cfg in self.suite)
                for key, backend in (("expert", SDPBackend.CUDNN_ATTENTION),
                                     ("fa_reference", SDPBackend.FLASH_ATTENTION))}
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
