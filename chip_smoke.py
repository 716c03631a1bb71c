#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases device,build,kernel

Phases, each printing JSON lines (any failure exits non-zero):
  device         card name, count, and nvidia-smi's name and power limit; the
                 H100 model's SM count, L2 size and shared memory per block
                 held against torch.cuda.get_device_properties
  build          nvcc of the three sm_90a libraries from the checkout, all
                 started together; registers and spills of every kernel
  kernel         flash_attention vs its plain PyTorch version and vs the
                 oracle: every combination of the six non-block genome axes
                 x 3 block pairs on the gate's fp32 proxy shapes, bf16 at
                 every mha_suite shape through the wgmma body (with two
                 wrong versions the bf16 bound must reject), bf16 at the
                 head dims of h2o-danube-3-4b (120, zero-padded to 128) and
                 phi-3-vision-4.2b (96), and the gate's verdicts through
                 kernel and plain version
  decode_kernel  flash_decode vs its plain version walking the same splits:
                 fp32 over split count, rep, head_dim (16, 64, 128), ragged
                 L, per-sequence valid_len and softcap; bf16 at the served
                 Jamba shape under its bounds at several split counts, with
                 a wrong version (valid_len - 1) the bounds must reject; bf16
                 at head_dim 64, 96 and 120 (the last two zero-padded to 128)
  ssd_kernel     ssd_chunked vs its plain version: fp32 on the serial body
                 over (P, N), chunk, ragged L and H; bf16 on the chunked body
                 over the same grid and at the served Jamba shape under its
                 bounds, with a wrong version (the state rounded to bf16
                 between chunks) the bounds must reject
  noise          the measured rung's spread: NOISE_REPS scorings of the seed
                 and the pipelined genome on mha_suite and gqa_suite, each
                 paid anew; the commit floor MEASURED_MIN_REL must not lie
                 below the largest spread (max / min - 1 of the geomean)
  rank           rung 0 against rung 2 on mha_suite: RANK_GENOMES genomes
                 drawn with a fixed numpy seed (fp32 accumulators), the seed
                 and the pipelined genome, each scored once at the measured
                 rung; Spearman's rho of each model's geomeans (H100, TPU
                 v5e) against the card's, and the host seconds per estimate
                 call of each model
  evolve         ContinuousEvolution(fidelity="measured") on mha_suite() for
                 a bounded number of paid evaluations, twice in turn: planned
                 from the H100 model and Hopper facts (the default), and from
                 the TPU v5e model's profiles and facts (the planning A/B);
                 the kernel must launch, and no commit may gain
                 MEASURED_MIN_REL or less; each plan's commits and the paid
                 evaluations it took to come within MEASURED_MIN_REL of the
                 pipelined genome, scored in the same call; the paper's
                 Fig. 3 rows of the H100-planned run: evolved, seed, cuDNN
                 and flash TFLOP/s per config (Scorer.baselines(): SDPA's
                 two backends)
  gqa            paper §4.3: the evolve phase's best genome adapted to
                 gqa_suite at the measured rung for GQA_EVALS paid
                 evaluations, planned from the Hopper facts; launches at
                 rep 8 and rep 4 on the wgmma body;
                 the Fig. 4 rows: adapted, zero-shot (the MHA genome), cuDNN
                 and flash; the adapted genome held to the plain version at
                 a rep-8 and a rep-4 shape
  decode_suite   the pipelined genome scored once on decode_suite at the
                 measured rung (windowed configs at full shape), its rows
                 beside cuDNN and flash (refused where a window is set), and
                 the kernel held to the plain version at two windowed shapes
  serve          jamba-v0.1-52b at full width, 16 of its 32 layers, bf16,
                 random weights from a seeded generator on the card: 8
                 requests through BatchedServer (batch 4, 32 new tokens);
                 launch counts of all three kernels must equal what the path
                 implies; every launch of the first group is held against its
                 plain version; the teacher-forced agreement of kernel and
                 plain paths is printed beside witnesses (blocked vs plain:
                 no kernel; both again with the MoE routing frozen to the
                 plain path's); reduced Jamba's tokens on the card
                 must equal the CPU reference path's, and so must those of
                 reduced h2o-danube-3-4b and phi-3-vision-4.2b at their
                 published head dims (120, 96) with impl="auto"
  times          flash_attention's wgmma body against its mma_sync body, in
                 turns (mma_sync, wgmma, wgmma, mma_sync), for the seed, a
                 fixed pipelined genome and the search's best at every
                 mha_suite shape, and at the served prefill; flash_decode
                 (one split against the wrapper's split count, in turns, and
                 a sweep of split counts) and ssd_chunked (the serial body
                 against the chunked one, in turns) at the served shapes:
                 kernel ms, bound ms, plain
                 ms, and a library yardstick where one PyTorch call computes
                 the same function; both attention kernels at head_dim 120
                 and 96 beside 128
  kernels        the summary line of every ported kernel
The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX and
nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 B/s
TOL_F32 = 1e-5              # kernel vs plain, fp32 inputs and accumulator
EVOLVE_EVALS = 10           # paid evaluations of the evolution phase
NOISE_REPS = 8              # scorings of one genome in the noise phase
GQA_EVALS = 8               # paid evaluations of the GQA adaptation
RANK_GENOMES = 24           # genomes drawn for the rank phase (besides the
RANK_SEED = 0               # seed and the pipelined genome), and their seed
PHASES = ("device", "build", "kernel", "decode_kernel", "ssd_kernel", "serve",
          "noise", "rank", "evolve", "gqa", "decode_suite", "times", "kernels")
SOURCES = ("flash_attention.cu", "flash_decode.cu", "ssd.cu")
TOL_SSD_F32 = 2e-5          # SSD kernel vs plain, fp32: relative to max |y|
SERVE_ARCH, SERVE_LAYERS = "jamba-v0.1-52b", 16
SERVE_BATCH, SERVE_REQUESTS, SERVE_NEW, SERVE_MAX_LEN = 4, 8, 32, 4096
SERVE_PROMPT = (1000, 2049)         # prompt lengths drawn in [lo, hi)
DECODE_SPLITS = (1, 2, 3, 5, 8, None)   # None: the wrapper's split count
DECODE_SWEEP = (2, 3, 5, 8, 9, 10, 16)  # split counts timed at the served shape
TEACHER_STEPS = 8                   # decode steps of the teacher-forced reading
PROFILE_NEW = 4                     # new tokens of the profiled pass

# bf16 kernel vs plain at full width.  Large logical blocks keep the plain
# version's walk short at every shape; both kernel paths and both div modes
# are covered.  The smallest shape also takes the small-block genomes.
BF16_GENOMES = [
    dict(block_q=2048, block_k=2048, rescale_mode="branchless",
         mask_mode="block_skip", div_mode="deferred", kv_in_grid=True),
    dict(block_q=2048, block_k=2048, rescale_mode="branched",
         mask_mode="dense", div_mode="eager", kv_in_grid=True),
    dict(block_q=1024, block_k=2048, rescale_mode="branched",
         mask_mode="dense", div_mode="eager", kv_in_grid=False)]
BF16_GENOMES_SMALL = [
    dict(block_q=128, block_k=128, rescale_mode="branched", mask_mode="dense",
         div_mode="eager", kv_in_grid=False),
    dict(block_q=512, block_k=1024, rescale_mode="branchless",
         mask_mode="block_skip", div_mode="deferred", kv_in_grid=True),
    dict(block_q=2048, block_k=256, rescale_mode="branched",
         mask_mode="block_skip", div_mode="eager", kv_in_grid=True),
    dict(block_q=64, block_k=2048, rescale_mode="branchless",
         mask_mode="block_skip", div_mode="deferred", kv_in_grid=False),
    dict(block_q=128, block_k=256, rescale_mode="branchless",
         mask_mode="block_skip", div_mode="eager", kv_in_grid=True)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_counts(*kernels) -> None:
    """Zero the launch counts of the given kernel wrappers (and
    flash_attention's counts by body) before a path is driven."""
    for fn in kernels:
        fn.launches = 0
        if hasattr(fn, "launches_by_body"):
            fn.launches_by_body = dict.fromkeys(fn.launches_by_body, 0)
        if hasattr(fn, "launches_by_rep"):
            fn.launches_by_rep = {}


def pipelined_genome():
    """The served genome (DEFAULT_ATTN_GENOME): 128-row blocks, pipelined
    K/V, block_skip, branchless, deferred."""
    from repro_torch.core.search_space import KernelGenome
    from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME
    return KernelGenome(**DEFAULT_ATTN_GENOME)


def fa_launch(q, k, v, causal, genome, body):
    """One flash_attention launch; ``body="mma_sync"`` forces the mma.sync
    body for the A/B timing, None takes the routed one."""
    from repro_torch.kernels import flash_attention as fa
    return fa._launch(q, k, v, causal=causal, window=None, softcap=0.0, scale=None,
                      body=body, **genome)


def in_turns(time_fn, a, b) -> dict:
    """Time a, b, b, a in one call; each side's two readings and their mean."""
    got = {a: [], b: []}
    for side in (a, b, b, a):
        got[side].append(time_fn(side))
    return {side: {"ms": sum(t) / len(t), "readings": t} for side, t in got.items()}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def bound(cfg) -> tuple:
    """(ms, "operations" or "bytes"): the larger of the two floors."""
    from repro_torch.core.perfmodel import useful_flops
    n = cfg.batch * cfg.seq_len * cfg.head_dim * cfg.dtype_bytes
    nbytes = 2 * n * cfg.n_heads + 2 * n * cfg.n_kv_heads      # q, o + k, v
    ops_ms = 1e3 * useful_flops(cfg) / PEAK_BF16
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def device_check() -> None:
    """The H100 model's SM count, L2 size and shared memory per block
    against the card's; they must agree."""
    import torch

    from repro_torch.core import perfmodel_h100 as m
    props = torch.cuda.get_device_properties(0)
    card = {"sms": props.multi_processor_count,
            "l2_bytes": getattr(props, "L2_cache_size", None),
            "smem_per_block_optin": getattr(props, "shared_memory_per_block_optin", None)}
    model = {"sms": m.N_SM, "l2_bytes": m.L2_BYTES,
             "smem_per_block_optin": m.SMEM_PER_BLOCK}
    emit({"phase": "device", "check": "h100_model_constants", "card": card,
          "model": model})
    if card != model:
        raise AssertionError(f"the H100 model's constants {model} are not the card's {card}")


def phase_build():
    """One nvcc for each source, all started together, then loaded."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        list(ex.map(_build.build, SOURCES))
    for src in SOURCES:
        _build.load(src)
    wall = time.perf_counter() - t0
    for src in SOURCES:
        emit({"phase": "build", "source": src, "wall_s": wall,
              **_build.BUILD_INFO[src]})


def _proxy(rng, Hkv, causal, window):
    import numpy as np
    import torch
    arrs = [rng.normal(size=(1, h, 160, 64)).astype(np.float32)
            for h in (4, Hkv, Hkv)]
    return [torch.from_numpy(a).cuda() for a in arrs], dict(causal=causal,
                                                            window=window)


def _full_width_bf16() -> float:
    """The kernel against its plain version in bf16 at every mha_suite
    shape, on the inputs the measured rung times.  At the smallest shape two
    wrong versions made from the plain one must fail the same bound: a bf16
    accumulator rounded every 64 keys, and rows past S - S/32 that lose their
    oldest keys (a window).  Every reading prints before any verdict."""
    import torch

    from repro_torch.core.evals.scorer import full_shape_inputs
    from repro_torch.core.perfmodel import mha_suite
    from repro_torch.kernels.flash_attention import (
        BF16_ATOL, BF16_REL_RMS, BF16_ROW_REL_RMS, BF16_RTOL, bf16_agreement,
        bf16_agrees, flash_attention, flash_attention_plain)

    bounds = {"bound_atol": BF16_ATOL, "bound_rtol_of_magnitude": BF16_RTOL,
              "bound_rel_rms": BF16_REL_RMS, "bound_row_rel_rms": BF16_ROW_REL_RMS}
    worst, faults = 0.0, []
    wgmma_before, checked = flash_attention.launches_by_body["wgmma"], 0
    for cfg in mha_suite():
        q, k, v = full_shape_inputs(cfg, torch.device("cuda"), 0)
        small, good = cfg.name == "mha_causal_s4096", None
        mag = flash_attention_plain(q, k, v.abs(), causal=cfg.causal,
                                    **BF16_GENOMES[0])
        for kw in BF16_GENOMES + (BF16_GENOMES_SMALL if small else []):
            o = flash_attention(q, k, v, causal=cfg.causal, impl="kernel", **kw)
            checked += 1
            p = flash_attention_plain(q, k, v, causal=cfg.causal, **kw)
            st = bf16_agreement(o, p, mag)
            emit({"phase": "kernel", "check": "full_width_bf16", "body": "wgmma",
                  "config": cfg.name, "genome": kw, **st, **bounds})
            worst = max(worst, st["max_abs_err"])
            if not bf16_agrees(st):
                faults.append(f"bf16 kernel disagrees at {cfg.name} {kw}: {st}")
            good = p if good is None else good      # the first genome's output
            del o, p
        if small:
            base = BF16_GENOMES[0]
            controls = {
                "bf16_acc_every_64_keys": dict(base, block_k=64, acc_dtype="bf16"),
                "keys_dropped_past_row_S-S/32": dict(
                    base, window=cfg.seq_len - cfg.seq_len // 32)}
            for name, kw in controls.items():
                st = bf16_agreement(flash_attention_plain(
                    q, k, v, causal=cfg.causal, **kw), good, mag)
                emit({"phase": "kernel", "check": "full_width_bf16_control",
                      "config": cfg.name, "control": name, **st, **bounds})
                if bf16_agrees(st):
                    faults.append(f"the bf16 bound let the control {name} pass: {st}")
        del q, k, v, good, mag
        torch.cuda.empty_cache()
    grew = flash_attention.launches_by_body["wgmma"] - wgmma_before
    if grew != checked:
        faults.append(f"{checked} bf16 launches at head_dim 128, but the wgmma body "
                      f"took {grew}")
    if faults:
        raise AssertionError("\n".join(faults))
    return worst


def _padded_head_dims() -> float:
    """flash_attention in bf16 at the registry's head dims off 64 / 128:
    h2o-danube-3-4b's 120 (GQA 32 / 8; zero-padded to 128, the wgmma body)
    and phi-3-vision-4.2b's 96 (MHA; the mma_sync body), causal, B = 2,
    S = 2048, the served genome, a window of 1024 on danube (its own 4096
    lies past S).  One launch each, held to the plain version at the
    original D under the bf16 bounds."""
    import torch

    from repro_torch.kernels.flash_attention import (
        attention_body, bf16_agreement, bf16_agrees, flash_attention,
        flash_attention_plain, kernel_head_dim)
    from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME

    g = torch.Generator(device="cuda").manual_seed(5)
    worst, faults = 0.0, []
    for arch, D, Hkv, window in (("h2o-danube-3-4b", 120, 8, 1024),
                                 ("phi-3-vision-4.2b", 96, 32, None)):
        B, Hq, S = 2, 32, 2048
        q = torch.randn((B, Hq, S, D), generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        kw = dict(DEFAULT_ATTN_GENOME, causal=True, window=window)
        body = attention_body(q.dtype, D)
        before, by_body = flash_attention.launches, dict(flash_attention.launches_by_body)
        o = flash_attention(q, k, v, impl="kernel", **kw)
        took = {b: flash_attention.launches_by_body[b] - by_body[b] for b in by_body}
        st = bf16_agreement(o, flash_attention_plain(q, k, v, **kw),
                            flash_attention_plain(q, k, v.abs(), **kw))
        emit({"phase": "kernel", "check": "padded_head_dim_bf16", "arch": arch,
              "head_dim": D, "runs_at": kernel_head_dim(D), "body": body,
              "shape": f"q ({B}, {Hq}, {S}, {D}), k/v ({B}, {Hkv}, {S}, {D})",
              "window": window, "launches": flash_attention.launches - before,
              "launches_by_body": took, **st})
        worst = max(worst, st["max_abs_err"])
        if flash_attention.launches - before != 1 or took[body] != 1:
            faults.append(f"head_dim {D}: launches {took}, expected one on {body}")
        if o.shape != q.shape or not bf16_agrees(st):
            faults.append(f"head_dim {D}: {tuple(o.shape)}, {st}")
    if faults:
        raise AssertionError("flash_attention: " + "; ".join(faults))
    return worst


def phase_kernel(state):
    import itertools

    import numpy as np
    import torch

    from repro_torch.core.evals import CORRECTNESS_TOL, Scorer
    from repro_torch.core.search_space import full_space
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ref import mha_reference

    rng = np.random.default_rng(0)
    shapes = [_proxy(rng, hkv, causal, w) for hkv in (4, 2)
              for causal, w in ((True, None), (True, 48), (False, None))]
    blocks = ((16, 16), (32, 128), (128, 64))
    worst_f32 = worst_oracle = 0.0
    bf16_min_oracle = float("inf")
    n = 0
    for rm, mm, dm, kig, gp, ad in itertools.product(
            ("branchless", "branched"), ("dense", "block_skip"),
            ("deferred", "eager"), (False, True), (False, True), ("f32", "bf16")):
        for bq, bk in blocks:
            kw = dict(block_q=bq, block_k=bk, rescale_mode=rm, mask_mode=mm,
                      div_mode=dm, kv_in_grid=kig, gqa_pack=gp, acc_dtype=ad)
            for (q, k, v), sh in shapes:
                o = flash_attention(q, k, v, impl="kernel", **sh, **kw)
                p = flash_attention_plain(q, k, v, **sh, **kw)
                r = mha_reference(q, k, v, **sh)
                torch.cuda.synchronize()
                e_plain = float((o - p).abs().max())
                e_ref = float((o - r).abs().max())
                n += 1
                if ad == "f32":
                    if not (e_plain <= TOL_F32 and e_ref <= CORRECTNESS_TOL):
                        raise AssertionError(f"kernel disagrees on {kw} {sh}: "
                                             f"vs plain {e_plain}, vs oracle {e_ref}")
                    worst_f32 = max(worst_f32, e_plain)
                    worst_oracle = max(worst_oracle, e_ref)
                else:
                    bf16_min_oracle = min(bf16_min_oracle, e_ref)
    if not bf16_min_oracle > CORRECTNESS_TOL:
        raise AssertionError("a bf16-accumulator genome passed the gate tolerance")
    emit({"phase": "kernel", "check": "gate_shapes_fp32", "cases": n,
          "max_abs_err_vs_plain_f32acc": worst_f32,
          "max_abs_err_vs_oracle_f32acc": worst_oracle,
          "min_abs_err_vs_oracle_bf16acc": bf16_min_oracle,
          "tol_vs_plain": TOL_F32, "tol_vs_oracle": CORRECTNESS_TOL})

    worst_bf16 = max(_full_width_bf16(), _padded_head_dims())

    # the gate's verdicts: kernel (card) vs plain version (CPU), same genomes
    sample = random.Random(0).sample(list(full_space()), 24)
    sample += [g.with_(acc_dtype="bf16") for g in sample[:4]]
    on_card, on_cpu = Scorer(device="cuda"), Scorer(device="cpu")
    card = [on_card.check(g)[0] for g in sample]
    cpu = [on_cpu.check(g)[0] for g in sample]
    if card != cpu:
        raise AssertionError(f"gate verdicts differ: card {card} cpu {cpu}")
    bf16_card = [ok for g, ok in zip(sample, card) if g.acc_dtype == "bf16"]
    if any(bf16_card):
        raise AssertionError("a bf16-accumulator genome passed the gate on the card")
    emit({"phase": "kernel", "check": "gate_verdicts", "genomes": len(sample),
          "passed": sum(card), "bf16_acc_rejected": len(bf16_card),
          "card_equals_plain": True})
    state["max_abs_err"] = max(worst_f32, worst_bf16)


def _cuda(*arrays):
    import torch
    return [torch.from_numpy(a).cuda() for a in arrays]


def time_cold_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event milliseconds of ``fn()`` with the L2 cache flushed
    before every run: on the served path a decode launch finds its K/V cold
    (the layers between two steps stream gigabytes of weights)."""
    import statistics

    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, ops: float) -> tuple:
    """(ms, "operations" or "bytes"): the larger of the two floors."""
    ops_ms, bytes_ms = 1e3 * ops / PEAK_BF16, 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def decode_bound(B, Hq, Hkv, D, valid, esize=2) -> tuple:
    """Bytes: q and o, the live K/V rows once, valid_len; operations: the
    two products over the live keys."""
    live = sum(int(v) for v in valid)
    nbytes = 2 * B * Hq * D * esize + 2 * live * Hkv * D * esize + 4 * B
    return _bound(nbytes, 4.0 * live * Hq * D)


def ssd_bound(B, L, H, P, N, Q, esize=2) -> tuple:
    """Bytes: x and y, dt, A, B and C, the fp32 final state; operations:
    per (sequence, head, chunk of n live steps) the causal intra-chunk pairs
    (C.B then w.x), the inter-chunk C.state and the state update."""
    nbytes = 2 * B * L * H * P * esize + 4 * B * L * H + 4 * H \
        + 2 * B * L * N * esize + 4 * B * H * P * N
    ops = 0.0
    for t0 in range(0, L, Q):
        n = min(Q, L - t0)
        ops += n * (n + 1) / 2 * (2 * N + 2 * P) + 4.0 * n * P * N
    return _bound(nbytes, ops * B * H)


def attention_bound(B, Hq, Hkv, S, D, esize=2) -> tuple:
    """Causal prefill: the useful half of QK^T and PV; q, k, v, o once."""
    nbytes = 2 * B * Hq * S * D * esize + 2 * B * Hkv * S * D * esize
    return _bound(nbytes, 2.0 * B * Hq * S * S * D)


def phase_decode_kernel(state):
    """flash_decode against its plain version walking the same splits: fp32
    over the axes, bf16 at the served shape under its bounds at several
    split counts, and a wrong version that must fail."""
    import itertools

    import numpy as np
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import decode_reference

    rng = np.random.default_rng(1)
    worst_plain = worst_ref = 0.0
    n = 0
    for rep, D, L, softcap in itertools.product((1, 2, 4, 6, 7, 8), fd.HEAD_DIMS,
                                               (37, 256, 1000), (0.0, 30.0)):
        B, Hkv = 3, 2
        q, k, v = _cuda(*(rng.normal(size=s).astype(np.float32) for s in
                          ((B, rep * Hkv, D), (B, Hkv, L, D), (B, Hkv, L, D))))
        vl = torch.tensor([1, int(rng.integers(1, L + 1)), L], dtype=torch.int32,
                          device="cuda")
        ref = decode_reference(q, k, v, vl, softcap=softcap)
        for splits in DECODE_SPLITS:
            kw = dict(softcap=softcap)
            out = fd.flash_decode(q, k, v, vl, impl="kernel", splits=splits, **kw)
            plain = fd.flash_decode_plain(q, k, v, vl, splits=splits or fd.kernel_splits(q, k),
                                          **kw)
            worst_plain = max(worst_plain, float((out - plain).abs().max()))
            worst_ref = max(worst_ref, float((out - ref).abs().max()))
            n += 1
    emit({"phase": "decode_kernel", "check": "fp32_grid", "cases": n,
          "splits": [s or "wrapper's" for s in DECODE_SPLITS],
          "max_abs_err_vs_plain": worst_plain, "max_abs_err_vs_reference": worst_ref,
          "tol": TOL_F32})

    # bf16 at the served shape: (4, 32, 128) against a (4, 8, 4096, 128) cache
    B, Hq, Hkv, L, D = SERVE_BATCH, 32, 8, SERVE_MAX_LEN, 128
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
               for s in ((B, Hq, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    vl = torch.tensor([1043, 1569, 2048, 2079], dtype=torch.int32, device="cuda")
    auto = fd.kernel_splits(q, k)
    bounds = {"bound_atol": fd.BF16_ATOL, "bound_rtol_of_magnitude": fd.BF16_RTOL,
              "bound_rel_rms": fd.BF16_REL_RMS, "bound_row_rel_rms": fd.BF16_ROW_REL_RMS}
    verdicts, worst_bf16 = [], 0.0
    for softcap in (0.0, 50.0):
        for splits in (auto, 1, 3, 8):
            kw = dict(softcap=softcap, splits=splits)
            plain = fd.flash_decode_plain(q, k, v, vl, **kw)
            mag = fd.flash_decode_plain(q, k, v.abs(), vl, **kw)
            st = fd.bf16_agreement(fd.flash_decode(q, k, v, vl, impl="kernel", **kw),
                                   plain, mag)
            emit({"phase": "decode_kernel", "check": "served_bf16", "softcap": softcap,
                  "splits": splits, "wrapper_splits": splits == auto, **st, **bounds})
            worst_bf16 = max(worst_bf16, st["max_abs_err"])
            verdicts.append((f"kernel, {splits} splits", softcap, fd.bf16_agrees(st), True))
        wrong = fd.flash_decode_plain(q, k, v, vl - 1, softcap=softcap)
        st = fd.bf16_agreement(wrong, fd.flash_decode_plain(q, k, v, vl, softcap=softcap),
                               fd.flash_decode_plain(q, k, v.abs(), vl, softcap=softcap))
        emit({"phase": "decode_kernel", "check": "served_bf16_control",
              "control": "valid_len-1", "softcap": softcap, **st, **bounds})
        verdicts.append(("valid_len-1", softcap, fd.bf16_agrees(st), False))
    # bf16 at the registry's head dims off the served one, each arch's heads:
    # seamless-m4t-medium's 64 (compiled), phi-3-vision-4.2b's 96 and
    # h2o-danube-3-4b's 120 (both zero-padded to 128)
    for arch, D, Hq_d, Hkv_d in (("seamless-m4t-medium", 64, 16, 16),
                                 ("phi-3-vision-4.2b", 96, 32, 32),
                                 ("h2o-danube-3-4b", 120, 32, 8)):
        qd = torch.randn((B, Hq_d, D), generator=g, device="cuda").to(torch.bfloat16)
        kd, vd = (torch.randn((B, Hkv_d, L, D), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        before = fd.flash_decode.launches
        out = fd.flash_decode(qd, kd, vd, vl, impl="kernel")
        n = fd.kernel_splits(qd, kd)
        st = fd.bf16_agreement(out, fd.flash_decode_plain(qd, kd, vd, vl, splits=n),
                               fd.flash_decode_plain(qd, kd, vd.abs(), vl, splits=n))
        emit({"phase": "decode_kernel", "check": "head_dim_bf16", "arch": arch,
              "head_dim": D, "runs_at": fd.kernel_head_dim(D), "splits": n,
              "shape": f"q ({B}, {Hq_d}, {D}), cache ({B}, {Hkv_d}, {L}, {D})",
              "launches": fd.flash_decode.launches - before, **st, **bounds})
        worst_bf16 = max(worst_bf16, st["max_abs_err"])
        verdicts.append((f"kernel at head_dim {D}", 0.0,
                         fd.bf16_agrees(st) and fd.flash_decode.launches == before + 1
                         and out.shape == qd.shape, True))
        del qd, kd, vd
    faults = [f"{who} (softcap {sc}) {'failed' if want else 'passed'} the bf16 bounds"
              for who, sc, ok, want in verdicts if ok != want]
    if worst_plain > TOL_F32 or worst_ref > TOL_F32:
        faults.append(f"fp32: {worst_plain} vs plain, {worst_ref} vs reference")
    if faults:
        raise AssertionError("flash_decode: " + "; ".join(faults))
    state["decode_err"] = max(worst_plain, worst_bf16)
    state["decode_splits"] = auto


def ssd_inputs(gen, B, L, H, P, N, dtype, A=None):
    """x, B, C normal; Mamba-2's dt range (log-uniform in [1e-3, 1e-1]), so
    the state carries across chunks; A = -exp(N(0, 0.25)) unless given."""
    import math

    import torch
    kw = dict(generator=gen, device="cuda")
    x = torch.randn((B, L, H, P), **kw).to(dtype)
    u = torch.rand((B, L, H), **kw)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    if A is None:
        A = -torch.exp(0.5 * torch.randn((H,), **kw))
    Bm = torch.randn((B, L, 1, N), **kw).to(dtype)
    Cm = torch.randn((B, L, 1, N), **kw).to(dtype)
    return x, dt, A, Bm, Cm


def ssd_state_rounded(x, dt, A, Bm, Cm, chunk):
    """A wrong SSD: the carried state rounded to bf16 between chunks."""
    import torch

    from repro_torch.kernels.ref import ssd_chunked_reference
    ys, st = [], None
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        y, st = ssd_chunked_reference(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl],
                                      chunk=min(chunk, x.shape[1] - c0), init_state=st)
        st = st.to(torch.bfloat16).float()
        ys.append(y)
    return torch.cat(ys, dim=1), st


def phase_ssd_kernel(state):
    """ssd_chunked against its plain version: fp32 on the serial body over
    the axes, bf16 on the chunked body over the same axes and at the served
    shape under its bounds, and a wrong version that must fail."""
    import itertools

    import torch

    from repro_torch.kernels import ssd as sm
    from repro_torch.kernels.ref import ssd_reference

    g = torch.Generator(device="cuda").manual_seed(3)
    bounds = {"bound_atol": sm.BF16_ATOL, "bound_rtol_of_magnitude": sm.BF16_RTOL,
              "bound_rel_rms": sm.BF16_REL_RMS, "bound_row_rel_rms": sm.BF16_ROW_REL_RMS,
              "bound_state_rel_rms": sm.STATE_REL_RMS}
    worst = {"y": 0.0, "state": 0.0, "y_ref": 0.0, "abs": 0.0}
    worst_bf16 = dict.fromkeys(("max_abs_err", "tol_ratio", "rel_rms", "max_row_rel_rms",
                                "state_rel_rms"), 0.0)
    faults, n = [], 0
    before = dict(sm.ssd_chunked.launches_by_body)
    for (P, N), chunk, L, H in itertools.product(
            sm.SHAPES, (32, 256), (1, 37, 256, 300), (4, 8)):
        kw = dict(chunk=chunk)
        x, dt, A, Bm, Cm = ssd_inputs(g, 2, L, H, P, N, torch.float32)
        y, st = sm.ssd_chunked(x, dt, A, Bm, Cm, impl="kernel", **kw)
        py, pst = sm.ssd_chunked_plain(x, dt, A, Bm, Cm, **kw)
        ry, _ = ssd_reference(x, dt, A, Bm, Cm)
        scale_y, scale_s = float(py.abs().max()), float(pst.abs().max())
        worst["y"] = max(worst["y"], float((y - py).abs().max()) / scale_y)
        worst["state"] = max(worst["state"], float((st - pst).abs().max()) / scale_s)
        worst["y_ref"] = max(worst["y_ref"], float((y - ry).abs().max()) / scale_y)
        worst["abs"] = max(worst["abs"], float((y - py).abs().max()))

        x, dt, A, Bm, Cm = ssd_inputs(g, 2, L, H, P, N, torch.bfloat16)
        y, st = sm.ssd_chunked(x, dt, A, Bm, Cm, impl="kernel", **kw)
        py, pst = sm.ssd_chunked_plain(x, dt, A, Bm, Cm, **kw)
        mag, _ = sm.ssd_chunked_plain(x.abs(), dt, A, Bm.abs(), Cm.abs(), **kw)
        stb = sm.bf16_agreement(y, st, py, pst, mag)
        for k in worst_bf16:
            worst_bf16[k] = max(worst_bf16[k], stb[k])
        if not sm.bf16_agrees(stb):
            faults.append(f"chunked body fails the bf16 bounds at (P, N) {(P, N)}, "
                          f"chunk {chunk}, L {L}, H {H}: {stb}")
        n += 1
    took = {k: sm.ssd_chunked.launches_by_body[k] - before[k] for k in before}
    emit({"phase": "ssd_kernel", "check": "fp32_grid", "body": "serial", "cases": n,
          "max_rel_err_y_vs_plain": worst["y"], "max_rel_err_state_vs_plain": worst["state"],
          "max_rel_err_y_vs_recurrence": worst["y_ref"], "tol_rel_to_max": TOL_SSD_F32,
          "tol_vs_recurrence": 10 * TOL_SSD_F32})
    emit({"phase": "ssd_kernel", "check": "bf16_grid", "body": "chunked", "cases": n,
          "worst": worst_bf16, "launches_by_body": took, **bounds})
    if took != {"serial": n, "chunked": n}:
        faults.append(f"{n} fp32 and {n} bf16 launches took the bodies {took}")

    # bf16 at the served shape: Jamba's 128 heads of (64, 16), chunk 256, a
    # prompt length that is not a multiple of the chunk, Jamba's A
    B, L, H, P, N, Q = SERVE_BATCH, 2000, 128, 64, 16, 256
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    x, dt, A, Bm, Cm = ssd_inputs(g, B, L, H, P, N, torch.bfloat16, A=A)
    kw = dict(chunk=Q)
    y, st = sm.ssd_chunked(x, dt, A, Bm, Cm, impl="kernel", **kw)
    py, pst = sm.ssd_chunked_plain(x, dt, A, Bm, Cm, **kw)
    mag, _ = sm.ssd_chunked_plain(x.abs(), dt, A, Bm.abs(), Cm.abs(), **kw)
    good = sm.bf16_agreement(y, st, py, pst, mag)
    emit({"phase": "ssd_kernel", "check": "served_bf16", "body": sm.ssd_body(x), "L": L,
          **good, **bounds})
    wy, wst = ssd_state_rounded(x, dt, A, Bm, Cm, Q)
    bad = sm.bf16_agreement(wy, wst, py, pst, mag)
    emit({"phase": "ssd_kernel", "check": "served_bf16_control",
          "control": "state_rounded_to_bf16_between_chunks", **bad, **bounds})
    if worst["y"] > TOL_SSD_F32 or worst["state"] > TOL_SSD_F32 \
            or worst["y_ref"] > 10 * TOL_SSD_F32:
        faults.append(f"fp32 disagreement {worst}")
    if not sm.bf16_agrees(good):
        faults.append("the chunked body failed the bf16 bounds at the served shape")
    if sm.bf16_agrees(bad):
        faults.append("the bf16 bounds let the state-rounding control pass")
    if faults:
        raise AssertionError("ssd_chunked: " + "; ".join(faults))
    state["ssd_err"] = max(worst["abs"], worst_bf16["max_abs_err"], good["max_abs_err"])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@contextlib.contextmanager
def _routing(record, replay=None):
    """Every MoE layer's top-k choice is appended to ``record``; with
    ``replay``, each layer takes the next recorded choice instead of its own
    (the gate values are then its own probabilities at those experts)."""
    import torch

    from repro_torch.models import moe
    own = moe.top_k

    def top_k(probs, k):
        vals, idx = own(probs, k)
        if replay is not None:
            idx = replay.pop(0)
            vals = torch.gather(probs, -1, idx)
        record.append(idx)
        return vals, idx

    moe.top_k = top_k
    try:
        yield
    finally:
        moe.top_k = own


def _dropped(cfg, idx) -> int:
    """(token, slot) pairs past their expert's capacity, as moe_apply ranks them."""
    import torch

    from repro_torch.models.moe import capacity
    eidx = idx.reshape(-1)
    onehot = (eidx[:, None] == torch.arange(cfg.moe.n_experts, device=idx.device)).long()
    pos = torch.gather(torch.cumsum(onehot, 0) - onehot, 1, eidx[:, None])[:, 0]
    return int((pos >= capacity(idx.shape[0], cfg)).sum())


def _teacher_forced(params, cfg, group, max_len, impl, ref_impl, freeze=False):
    """Path ``impl`` against path ``ref_impl`` on one group, both fed the
    tokens the served run generated: logits relative RMS and greedy-token
    agreement at the prefill and at each of TEACHER_STEPS decode steps, and
    how the MoE routing of the two paths differs at the prefill.  With
    ``freeze``, every MoE layer of ``impl`` takes ``ref_impl``'s expert
    choice, so neither top-k flips nor capacity drops can differ."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, prefill
    plen = max(len(r.prompt) for r in group)
    toks = np.zeros((len(group), plen), np.int64)
    for i, r in enumerate(group):
        toks[i, plen - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).cuda()
    kw = dict(compute_dtype=torch.bfloat16)
    out, routes = {}, {}
    for path in (ref_impl, impl):                # the reference path first: it records
        routes[path] = []
        replay = list(routes[ref_impl]) if freeze and path == impl else None
        with _routing(routes[path], replay):
            logits, cache = prefill(params, cfg, toks, max_len,
                                    cache_dtype=torch.bfloat16, impl=path, **kw)
            out[path] = [logits]
            n_prefill = len(routes[path])
            for t in range(TEACHER_STEPS):
                tok = torch.tensor([r.output[t] for r in group], device="cuda")
                logits, cache = decode_step(params, cfg, cache, tok, impl=path, **kw)
                out[path].append(logits)
        del cache
    steps = [{"logits_rel_rms": float((a - b).norm() / b.norm()),
              "greedy_agree": float((a.argmax(-1) == b.argmax(-1)).float().mean())}
             for a, b in zip(out[impl], out[ref_impl])]
    pre = {p: routes[p][:n_prefill] for p in routes}
    routing = {
        "prefill_moe_layers": n_prefill,
        "prefill_choices": sum(r.numel() for r in pre[ref_impl]),
        "prefill_choices_differing_by_layer": [int((a != b).sum()) for a, b in
                                                zip(pre[impl], pre[ref_impl])],
        "decode_choices_differing": sum(int((a != b).sum()) for a, b in
                                        zip(routes[impl][n_prefill:],
                                            routes[ref_impl][n_prefill:])),
        "prefill_dropped": {p: sum(_dropped(cfg, r) for r in pre[p]) for p in pre}}
    return steps, routing


def _profile_group(server, group):
    """torch.profiler over two more passes of a group: the prefill alone (one
    new token) and the prefill with PROFILE_NEW - 1 decode steps.  Device
    time of the kernels (CUDA rows only), the ported kernels' share, the
    device's busy share of the pass's wall time, and by difference the
    device time of one decode step.  A reading, not a check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import Request
    device_ms = {}
    for new in (1, PROFILE_NEW):
        reqs = [Request(r.rid, r.prompt, new) for r in group]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.run_group(reqs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        device_ms[new] = sum(r[1] for r in rows)
        ours = {name: sum(ms for key, ms, _ in rows if any(t in key for t in tags))
                for name, tags in (("flash_attention", ("fa_fwd",)),
                                   ("flash_decode", ("decode_split", "decode_combine")),
                                   ("ssd_chunked", ("ssd_kernel", "ssd_chunk_state",
                                                    "ssd_state_pass", "ssd_chunk_scan")))}
        t = server.timings[-1]
        line = {"phase": "serve", "check": "profile", "gate": False, "new_tokens": new,
                "prompt_len": t["prompt_len"], "wall_ms": wall_ms,
                "device_ms": device_ms[new] or "not measured",
                "device_busy_share": (device_ms[new] / wall_ms if device_ms[new]
                                      else "not measured"),
                "ported_kernels_ms": ours, "prefill_ms": t["prefill_ms"],
                "decode_ms": t["decode_ms"],
                "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:12]]}
        if new > 1 and device_ms[1] and t["decode_ms"]:
            step = (device_ms[new] - device_ms[1]) / (new - 1)
            line["decode_step_device_ms"] = step
            line["decode_step_busy_share"] = step / (sum(t["decode_ms"]) / len(t["decode_ms"]))
        emit(line)


def phase_serve(state):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as sm
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import init_params

    full = get_arch(SERVE_ARCH)
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS)
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "of_layers": full.n_layers, "params_b": cfg.param_count() / 1e9,
          "full_params_b": full.param_count() / 1e9,
          "cut": f"depth {full.n_layers} -> {cfg.n_layers} layers ({cfg.n_periods} of "
                 f"{full.n_periods} periods); every width is the published one",
          "reason": f"all {full.n_layers} layers are {full.param_count() / 1e9:.1f} B "
                    f"parameters, {2 * full.param_count() / 1e9:.0f} GB in bf16, above the "
                    f"card's 80 GB; {cfg.n_layers} layers are "
                    f"{2 * cfg.param_count() / 1e9:.0f} GB and leave room for activations"})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = sum(t.numel() * t.element_size() for t in _leaves(params)) / 2 ** 30

    rng = np.random.default_rng(0)
    lens = rng.integers(*SERVE_PROMPT, size=SERVE_REQUESTS)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (int(n),)), SERVE_NEW)
            for i, n in enumerate(lens)]
    groups = [reqs[i:i + SERVE_BATCH] for i in range(0, len(reqs), SERVE_BATCH)]
    server = BatchedServer(cfg, params, batch_size=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                           compute_dtype=torch.bfloat16)
    checks = {"flash_attention": [], "flash_decode": [], "ssd_chunked": []}
    kernels = {"flash_attention": fa.flash_attention, "flash_decode": fd.flash_decode,
               "ssd_chunked": sm.ssd_chunked}
    torch.cuda.synchronize()
    reset_counts(*kernels.values())
    t0 = time.perf_counter()
    with ops.checking(lambda name, st: checks[name].append(st)):
        server.run_group(groups[0])              # every launch held against plain
    for grp in groups[1:]:
        server.run_group(grp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    by_body = dict(fa.flash_attention.launches_by_body)
    ssd_by_body = dict(sm.ssd_chunked.launches_by_body)

    n_attn = sum(b.kind == "attn" for b in cfg.pattern) * cfg.n_periods
    n_mamba = sum(b.kind == "mamba" for b in cfg.pattern) * cfg.n_periods
    steps = sum(len(t["decode_ms"]) for t in server.timings)
    expected = {"flash_attention": n_attn * len(groups),
                "ssd_chunked": n_mamba * len(groups),
                "flash_decode": n_attn * steps}
    for i, t in enumerate(server.timings):
        dec = sorted(t["decode_ms"])
        med = dec[len(dec) // 2]
        emit({"phase": "serve", "group": i, "checked_against_plain": i == 0,
              "batch": t["batch"], "prompt_len": t["prompt_len"],
              "prompt_lens": [len(r.prompt) for r in groups[i]],
              "prefill_ms": t["prefill_ms"], "decode_steps": len(dec),
              "decode_ms_median": med, "decode_ms_mean": sum(dec) / len(dec),
              "decode_tokens_per_s": t["batch"] / (med * 1e-3)})
    faults = []
    if steps != len(groups) * (SERVE_NEW - 1):
        faults.append(f"{steps} decode steps, expected {len(groups) * (SERVE_NEW - 1)}")
    if launches != expected:
        faults.append(f"launches {launches}, the path implies {expected}")
    if by_body["wgmma"] != launches["flash_attention"]:
        faults.append(f"flash_attention launches by body {by_body}: the served bf16 "
                      f"prefill at head_dim 128 must take the wgmma body")
    if ssd_by_body["chunked"] != launches["ssd_chunked"]:
        faults.append(f"ssd_chunked launches by body {ssd_by_body}: the served bf16 "
                      f"prefill must take the chunked body")
    for r in reqs:
        if len(r.output) != SERVE_NEW or not all(0 <= t < cfg.vocab_size for t in r.output):
            faults.append(f"request {r.rid} output {r.output}")
    agree = {"flash_attention": fa.bf16_agrees, "flash_decode": fd.bf16_agrees,
             "ssd_chunked": sm.bf16_agrees}
    for name, rows in checks.items():
        bad = [st for st in rows if not agree[name](st)]
        worst = {k: max(st[k] for st in rows) for k in rows[0] if k != "finite"} if rows else {}
        emit({"phase": "serve", "check": "launches_vs_plain", "kernel": name,
              "group": 0, "launches_checked": len(rows), "failed": len(bad), "worst": worst})
        state.setdefault("serve_err", {})[name] = worst.get("max_abs_err")
        if bad or not rows:
            faults.append(f"{name}: {len(bad)} of {len(rows)} checked launches disagree")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    total_new = sum(len(r.output) for r in reqs)
    emit({"phase": "serve", "summary": True, "requests": len(reqs),
          "new_tokens": total_new, "wall_s": wall, "weights_gib": weights_gib,
          "init_s": init_s, "peak_gib": peak_gib, "launches": launches,
          "launches_expected": expected, "flash_attention_launches_by_body": by_body,
          "ssd_chunked_launches_by_body": ssd_by_body,
          "launches_per_prefill": {k: v // len(groups) for k, v in launches.items()
                                   if k != "flash_decode"},
          "flash_decode_per_step": launches["flash_decode"] / steps,
          "outputs_first_request": reqs[0].output})

    _profile_group(server, groups[1])
    for name, impl, ref_impl, freeze in (
            ("kernel_vs_plain", "kernel", "plain", False),
            ("blocked_vs_plain", "blocked", "plain", False),
            ("kernel_vs_plain_routing_frozen", "kernel", "plain", True),
            ("blocked_vs_plain_routing_frozen", "blocked", "plain", True)):
        rows, routing = _teacher_forced(params, cfg, groups[0], SERVE_MAX_LEN,
                                        impl, ref_impl, freeze)
        emit({"phase": "serve", "check": f"teacher_forced_{name}", "gate": False,
              "steps": rows, "routing": routing})
    state["serve"] = {"launches": launches, "by_body": by_body, "ssd_by_body": ssd_by_body,
                      "prompt_lens": [t["prompt_len"] for t in server.timings],
                      "timings": server.timings}
    del params, server
    torch.cuda.empty_cache()

    # small inputs against the reference: reduced Jamba in fp32, the card's
    # kernel path against the CPU's blocked path, same weights and requests;
    # then reduced h2o-danube-3-4b and phi-3-vision-4.2b at their published
    # head dims (120 and 96), impl="auto", every launch held to its plain
    # version
    for arch, check in ((SERVE_ARCH, False), ("h2o-danube-3-4b", True),
                        ("phi-3-vision-4.2b", True)):
        small = get_arch(arch).reduced()
        if check:                       # the published head dim
            small = dataclasses.replace(small, d_head=get_arch(arch).head_dim)
        outs, seen = _card_vs_cpu_tokens(small, check)
        emit({"phase": "serve", "check": "reduced_fp32_card_vs_cpu_reference",
              "arch": arch, "head_dim": small.head_dim,
              "tokens_equal": outs["card"] == outs["cpu"], "card": outs["card"],
              "cpu": outs["cpu"], "launches_checked": {k: len(v) for k, v in seen.items()},
              "worst_rel_rms": {k: max(st["rel_rms"] for st in v) for k, v in seen.items()}})
        if outs["card"] != outs["cpu"]:
            faults.append(f"reduced {arch}: the card's tokens differ from the CPU "
                          "reference's")
        if check and (set(seen) != {"flash_attention", "flash_decode"} or not all(
                st["finite"] and st["rel_rms"] <= 1e-5 for v in seen.values() for st in v)):
            faults.append(f"reduced {arch}: checked launches {seen}")
    if faults:
        raise AssertionError("serve: " + "; ".join(faults))


def _card_vs_cpu_tokens(cfg, check: bool):
    """``cfg`` in fp32 with weights from seed 0 served on the card
    (impl="auto": the kernels) and on the CPU (the blocked references):
    4 prompts of 5-39 tokens, batch 2, 8 new tokens.  With ``check`` every
    card launch is held to its plain version; returns both token lists and
    the checked launches' stats by kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import init_params

    cpu_params = init_params(cfg, torch.Generator().manual_seed(0))

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}
    srng = np.random.default_rng(1)
    lens = srng.integers(5, 40, size=4)
    prompts = [srng.integers(0, cfg.vocab_size, (int(n),)) for n in lens]
    outs, seen = {}, {}
    for name, p in (("card", to_cuda(cpu_params)), ("cpu", cpu_params)):
        srv = BatchedServer(cfg, p, batch_size=2, max_len=64)
        hook = (ops.checking(lambda k, st: seen.setdefault(k, []).append(st))
                if check and name == "card" else contextlib.nullcontext())
        with hook:
            outs[name] = [r.output for r in srv.run([Request(i, pr, 8)
                                                     for i, pr in enumerate(prompts)])]
    return outs, seen


def phase_noise(state):
    """The spread of the measured rung: NOISE_REPS scorings of the seed and
    the pipelined genome on mha_suite and gqa_suite, in turns, each paid
    anew (``score_uncached``: no memo).  Two scorings of one genome differ
    by at most max / min - 1 of its geomean; a commit floor below that lets
    a re-timing of an unchanged kernel commit."""
    import statistics

    import torch

    from repro_torch.core.evals import MEASURED, MEASURED_MIN_REL, Scorer
    from repro_torch.core.evals.scorer import TIMING_REPS, TIMING_WARMUP
    from repro_torch.core.perfmodel import gqa_suite, mha_suite
    from repro_torch.core.search_space import seed_genome

    genomes = {"seed": seed_genome(), "pipelined": pipelined_genome()}
    spreads = {}
    for suite_name, suite in (("mha_suite", mha_suite()), ("gqa_suite", gqa_suite())):
        scorer = Scorer(suite=suite, fidelity=MEASURED)
        for cfg in suite:                  # set-up: inputs made before the clock
            scorer.full_inputs(cfg)
        geo = {name: [] for name in genomes}
        t0 = time.perf_counter()
        for _ in range(NOISE_REPS):
            for name, g in genomes.items():
                sv = scorer.score_uncached(g)
                if not (sv.correct and sv.geomean > 0):
                    raise AssertionError(f"{name} genome on {suite_name}: {sv.failure}")
                geo[name].append(sv.geomean)
        wall = time.perf_counter() - t0
        for name, vals in geo.items():
            spreads[(suite_name, name)] = max(vals) / min(vals) - 1.0
            emit({"phase": "noise", "suite": suite_name, "genome": name,
                  "scorings": len(vals), "geomeans": vals,
                  "median": statistics.median(vals),
                  "rel_stdev": statistics.stdev(vals) / statistics.mean(vals),
                  "spread_max_over_min": spreads[(suite_name, name)],
                  "wall_s_all_genomes": wall})
        del scorer
        torch.cuda.empty_cache()
    worst = max(spreads.values())
    emit({"phase": "noise", "summary": True, "max_spread": worst,
          "at": "/".join(max(spreads, key=spreads.get)),
          "floor_in_force": MEASURED_MIN_REL, "floor_over_spread": MEASURED_MIN_REL / worst,
          "timer": f"CUDA events, {TIMING_WARMUP} warm-up, median of {TIMING_REPS}"})
    state["noise"] = {"max_spread": worst, "floor": MEASURED_MIN_REL}
    if MEASURED_MIN_REL < worst:
        raise AssertionError(f"the commit floor {MEASURED_MIN_REL} lies below the "
                             f"measured spread {worst}")


def check_commits(lineage, phase) -> list:
    """Every commit's values positive, and every commit after the first
    gaining more than the commit floor over the best before it.  Returns the
    gains."""
    from repro_torch.core.evals import MEASURED_MIN_REL
    gains, best = [], None
    for c in lineage.commits:
        if not all(v > 0 and v == v for v in c.values):
            raise AssertionError(f"{phase}: commit {c.version} has a non-positive value")
        if best is not None:
            gains.append(c.geomean / best - 1.0)
            if gains[-1] <= MEASURED_MIN_REL:
                raise AssertionError(f"{phase}: commit {c.version} gains {gains[-1]}, "
                                     f"not above the floor {MEASURED_MIN_REL}")
        best = c.geomean if best is None else max(best, c.geomean)
    return gains


def figure_rows(phase, scorer, columns: dict) -> list:
    """The paper's comparison, one row per suite config: each column's
    TFLOP/s, then cuDNN's and flash's from ``scorer.baselines()`` (None with
    the backend's error where it refused), and the first column over each."""
    base = scorer.baselines()
    lead, lead_vals = next(iter(columns.items()))
    rows = []
    for i, cfg in enumerate(scorer.suite):
        row = {"phase": phase, "figure_row": True, "config": cfg.name,
               **{name: vals[i] for name, vals in columns.items()}}
        for lib, key in (("cudnn", "expert"), ("flash", "fa_reference")):
            b = base[key][i]
            row[f"{lib}_tflops"] = b
            row[f"{lead}_over_{lib}"] = lead_vals[i] / b if b else None
            if b is None:
                row[f"{lib}_error"] = scorer.baseline_errors[key][cfg.name]
        emit(row)
        rows.append(row)
    return rows


def _drive(evo, phase, evals, target=None, **tags) -> tuple:
    """Steps of ``evo`` until ``evals`` paid evaluations; one line a step.
    Returns (steps, wall seconds, paid evaluations when the best first
    reached ``target`` TFLOP/s or None)."""
    scorer = evo.scorer
    t_all, step, reached = time.perf_counter(), 0, None
    while scorer.n_evaluations < evals and step < 3 * evals:
        n0, t0 = scorer.n_evaluations, time.perf_counter()
        rep = evo.run(max_steps=1)
        dt = time.perf_counter() - t0
        paid = scorer.n_evaluations - n0
        best = evo.lineage.best()
        if reached is None and target is not None and best and best.geomean >= target:
            reached = scorer.n_evaluations
        trace = evo.island.traces[-1]
        emit({"phase": phase, **tags, "step": step, "committed": rep.commits > 0,
              "best_tflops": best.geomean if best else 0.0, "paid_evals": paid,
              "s_per_eval": dt / paid if paid else None, "note": trace["note"][:80],
              "tried": [f"{a[1][:70]} -> {b[1][:40]}" for a, b in
                        zip(trace["trace"], trace["trace"][1:])
                        if a[0] == "edit" and b[0] == "eval"]})
        step += 1
    return step, time.perf_counter() - t_all, reached


def spearman(a, b) -> float:
    """Spearman's rank correlation of two sequences (ties take their mean
    rank)."""
    import numpy as np

    def ranks(x):
        x = np.asarray(x, dtype=np.float64)
        r = np.empty(len(x))
        r[x.argsort(kind="stable")] = np.arange(len(x), dtype=np.float64)
        for v in np.unique(x):
            r[x == v] = r[x == v].mean()
        return r
    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def phase_rank(state):
    """Rung 0 against rung 2: a seeded genome sample scored once each at
    the measured rung on mha_suite, ranked against each model's geomeans."""
    import numpy as np
    import torch

    from repro_torch.core import perfmodel, perfmodel_h100
    from repro_torch.core.evals import MEASURED, Scorer
    from repro_torch.core.perfmodel import mha_suite
    from repro_torch.core.search_space import full_space, seed_genome
    from repro_torch.kernels.flash_attention import flash_attention

    space = [g for g in full_space() if g.acc_dtype == "f32"]
    rng = np.random.default_rng(RANK_SEED)
    genomes = [space[i] for i in rng.choice(len(space), RANK_GENOMES, replace=False)]
    genomes += [g for g in (seed_genome(), pipelined_genome()) if g not in genomes]
    suite = mha_suite()
    scorer = Scorer(suite=suite, fidelity=MEASURED)
    for cfg in suite:                  # set-up: inputs made before the clock
        scorer.full_inputs(cfg)
    torch.cuda.synchronize()
    reset_counts(flash_attention)
    card, t0 = [], time.perf_counter()
    for g in genomes:
        sv = scorer(g)
        if not (sv.correct and sv.geomean > 0):
            raise AssertionError(f"rank: {g} failed on the card: {sv.failure}")
        card.append(sv.geomean)
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    by_body = dict(flash_attention.launches_by_body)
    if launches <= 0 or by_body["wgmma"] <= 0:
        raise AssertionError(f"rank: the measured rung never took the wgmma body: {by_body}")

    def modelled(model):
        """Each genome's modelled geomean, and host seconds per estimate call."""
        t = time.perf_counter()
        geo = [float(np.exp(np.mean([np.log(model.estimate(g, c).tflops)
                                     for c in suite]))) for g in genomes]
        return geo, (time.perf_counter() - t) / (len(genomes) * len(suite))
    h100, h100_s = modelled(perfmodel_h100)
    tpu, tpu_s = modelled(perfmodel)
    for g, c, h, t in zip(genomes, card, h100, tpu):
        emit({"phase": "rank", "genome": g.kernel_kwargs(), "card_tflops": c,
              "h100_model_tflops": h, "tpu_v5e_model_tflops": t})
    out = {"rho_h100_model": spearman(h100, card), "rho_tpu_v5e_model": spearman(tpu, card),
           "genomes": len(genomes), "sample_seed": RANK_SEED,
           "estimate_s_h100_model": h100_s, "estimate_s_tpu_v5e_model": tpu_s,
           "model_s_per_scoring_h100": h100_s * len(suite),
           "model_s_per_scoring_tpu_v5e": tpu_s * len(suite),
           "measured_s_per_scoring": wall / len(genomes),
           "launches": launches, "launches_by_body": by_body}
    emit({"phase": "rank", "summary": True, "gate": False, **out})
    state.update(rank=out, rank_launches=launches,
                 model_checks_s=state.get("model_checks_s", 0.0) + time.perf_counter() - t0)
    del scorer
    torch.cuda.empty_cache()


def phase_evolve(state):
    """The measured evolution twice, in turn: planned from the H100 model
    and Hopper facts (the default), then from the TPU v5e model's profiles
    and facts (the planning A/B); each against the pipelined genome scored
    in this call."""
    import torch

    from repro_torch.core.evals import MEASURED, MEASURED_MIN_REL, InlineBackend, Scorer
    from repro_torch.core.evolution import ContinuousEvolution
    from repro_torch.core.knowledge import KnowledgeBase
    from repro_torch.core.knowledge_h100 import HOPPER_FACTS
    from repro_torch.core.perfmodel import mha_suite
    from repro_torch.kernels.flash_attention import flash_attention

    t_ref = time.perf_counter()
    ref = Scorer(suite=mha_suite(), fidelity=MEASURED)
    pipelined = ref(pipelined_genome()).geomean
    del ref
    t_ref = time.perf_counter() - t_ref
    target = pipelined * (1.0 - MEASURED_MIN_REL)
    emit({"phase": "evolve", "pipelined_tflops": pipelined, "target_tflops": target})
    plans = {}
    for plan in ("h100", "tpu_v5e"):
        if plan == "h100":
            evo = ContinuousEvolution(fidelity=MEASURED)
        else:
            evo = ContinuousEvolution(
                scorer=InlineBackend(fidelity=MEASURED, _plan_machine="tpu_v5e"),
                kb=KnowledgeBase())
        scorer = evo.scorer
        for cfg in scorer.suite:       # set-up: inputs made before the clock
            scorer.full_inputs(cfg)
        torch.cuda.synchronize()
        reset_counts(flash_attention)
        step, wall, reached = _drive(evo, "evolve", EVOLVE_EVALS, target=target, plan=plan)
        launches = flash_attention.launches
        by_body = dict(flash_attention.launches_by_body)
        best = evo.lineage.best()
        if launches <= 0:
            raise AssertionError(f"the {plan}-planned evolution never launched the kernel")
        if by_body["wgmma"] <= 0:
            raise AssertionError(f"the measured rung never took the wgmma body: {by_body}")
        gains = check_commits(evo.lineage, "evolve")
        plans[plan] = {"paid_evals_to_pipelined": reached, "commits": len(evo.lineage),
                       "best_tflops": best.geomean, "launches": launches}
        emit({"phase": "evolve", "summary": True, "plan": plan,
              "kb": "hopper" if evo.kb.facts == HOPPER_FACTS else "tpu_v5e", "steps": step,
              "paid_evals": scorer.n_evaluations, "commits": len(evo.lineage),
              "commit_notes": [c.note for c in evo.lineage.commits],
              "commit_gains": gains, "floor": evo.operator.policy.min_rel,
              "paid_evals_to_pipelined": reached, "pipelined_tflops": pipelined,
              "launches": launches, "launches_by_body": by_body,
              "launches_per_eval": launches / scorer.n_evaluations,
              "wall_s": wall, "best_tflops": best.geomean,
              "best_values": list(best.values), "best_genome": best.genome.kernel_kwargs()})
        if plan == "h100":
            rows = figure_rows("evolve", scorer, {"evolved": best.values,
                                                  "seed": evo.lineage.commits[0].values})
            state.update(launches=launches, best=best.genome, evolve_by_body=by_body,
                         per_eval=launches / scorer.n_evaluations, fig3=rows)
        else:
            state.update(tpu_plan_launches=launches, model_checks_s=state.get(
                "model_checks_s", 0.0) + t_ref + wall)
        evo.close()
        del evo, scorer
        torch.cuda.empty_cache()
    emit({"phase": "evolve", "planning_ab": True, "gate": False, **{
        f"{plan}_{k}": v for plan, row in plans.items() for k, v in row.items()}})
    state["planning_ab"] = plans


def _held_to_plain(phase, scorer, genome, names) -> float:
    """The kernel at suite configs ``names`` (full shape, the measured
    rung's inputs) against its plain version under the bf16 bounds; these
    launches are comparisons, not the path's."""
    from repro_torch.kernels.flash_attention import (bf16_agreement, bf16_agrees,
                                                     flash_attention,
                                                     flash_attention_plain)
    worst = 0.0
    kw = genome.kernel_kwargs()
    for cfg in scorer.suite:
        if cfg.name not in names:
            continue
        q, k, v = scorer.full_inputs(cfg)
        mk = dict(kw, causal=cfg.causal, window=cfg.window)
        st = bf16_agreement(flash_attention(q, k, v, impl="kernel", **mk),
                            flash_attention_plain(q, k, v, **mk),
                            flash_attention_plain(q, k, v.abs(), **mk))
        emit({"phase": phase, "check": "kernel_vs_plain_bf16", "config": cfg.name,
              "genome": kw, **st})
        if not bf16_agrees(st):
            raise AssertionError(f"{phase}: the kernel disagrees at {cfg.name}: {st}")
        worst = max(worst, st["max_abs_err"])
    return worst


def phase_gqa(state):
    """Paper §4.3: the MHA-evolved genome adapted to gqa_suite at the
    measured rung, commit floor in force."""
    import torch

    from repro_torch.core.evals import MEASURED, InlineBackend
    from repro_torch.core.evolution import ContinuousEvolution, default_agent
    from repro_torch.core.knowledge_h100 import HOPPER_FACTS
    from repro_torch.core.perfmodel import gqa_suite
    from repro_torch.core.variation import AgenticVariationOperator
    from repro_torch.kernels.flash_attention import flash_attention

    mha_genome = state.get("best") or pipelined_genome()
    scorer = InlineBackend(suite=gqa_suite(), fidelity=MEASURED)
    evo = ContinuousEvolution(scorer=scorer, operator=AgenticVariationOperator(
        default_agent(MEASURED, seed=mha_genome)))
    for cfg in scorer.suite:           # set-up: inputs made before the clock
        scorer.full_inputs(cfg)
    torch.cuda.synchronize()
    reset_counts(flash_attention)
    step, wall, _ = _drive(evo, "gqa", GQA_EVALS)
    launches = flash_attention.launches
    by_body = dict(flash_attention.launches_by_body)
    by_rep = dict(flash_attention.launches_by_rep)
    faults = []
    if not (by_rep.get(8, 0) > 0 and by_rep.get(4, 0) > 0):
        faults.append(f"launches by rep {by_rep}: the rep-8 and rep-4 configs were not both timed")
    if by_body["wgmma"] <= 0 or by_body["mma_sync"] != 0:
        faults.append(f"launches by body {by_body}: the measured launches must take wgmma")
    if not len(evo.lineage) or evo.lineage.commits[0].genome != mha_genome:
        faults.append("the adaptation did not start from the MHA genome")
    if evo.kb.facts != HOPPER_FACTS:
        faults.append("the adaptation did not plan from the Hopper facts")
    if faults:
        raise AssertionError("gqa: " + "; ".join(faults))
    gains = check_commits(evo.lineage, "gqa")
    best = evo.lineage.best()
    emit({"phase": "gqa", "summary": True, "plan": scorer.plan_machine, "steps": step,
          "paid_evals": scorer.n_evaluations, "commits": len(evo.lineage),
          "commit_notes": [c.note for c in evo.lineage.commits],
          "commit_gains": gains, "floor": evo.operator.policy.min_rel,
          "launches": launches, "launches_by_body": by_body, "launches_by_rep": by_rep,
          "wall_s": wall, "zero_shot_tflops": evo.lineage.commits[0].geomean,
          "adapted_tflops": best.geomean, "mha_genome": mha_genome.kernel_kwargs(),
          "adapted_genome": best.genome.kernel_kwargs()})
    rows = figure_rows("gqa", scorer, {"adapted": best.values,
                                       "zero_shot": evo.lineage.commits[0].values})
    err = _held_to_plain("gqa", scorer, best.genome,
                         ("gqa8_causal_s4096", "gqa4_noncausal_s4096"))
    state.update(gqa_launches=launches, gqa_by_body=by_body, gqa_by_rep=by_rep,
                 fig4=rows, max_abs_err=max(state.get("max_abs_err", 0.0), err))
    evo.close()
    del evo, scorer
    torch.cuda.empty_cache()


def phase_decode_suite(state):
    """The pipelined genome scored once on decode_suite at the measured
    rung: GQA 32 / 8 chunks at large batch, three of them with a window of
    1024 (block_skip bounds with a window at full shape)."""
    import torch

    from repro_torch.core.evals import MEASURED, Scorer
    from repro_torch.core.perfmodel import decode_suite
    from repro_torch.kernels.flash_attention import flash_attention

    genome = pipelined_genome()
    scorer = Scorer(suite=decode_suite(), fidelity=MEASURED)
    for cfg in scorer.suite:
        scorer.full_inputs(cfg)
    torch.cuda.synchronize()
    reset_counts(flash_attention)
    t0 = time.perf_counter()
    sv = scorer(genome)
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    by_body = dict(flash_attention.launches_by_body)
    emit({"phase": "decode_suite", "summary": True, "genome": genome.kernel_kwargs(),
          "correct": sv.correct, "failure": sv.failure, "geomean_tflops": sv.geomean,
          "launches": launches, "launches_by_body": by_body, "wall_s": wall})
    if not (sv.correct and all(v > 0 for v in sv.values)):
        raise AssertionError(f"decode_suite: {sv.failure}")
    if by_body["wgmma"] < len(scorer.suite):
        raise AssertionError(f"decode_suite: launches by body {by_body}")
    rows = figure_rows("decode_suite", scorer, {"pipelined": sv.values})
    windowed = [r for r, c in zip(rows, scorer.suite) if c.window is not None]
    if not windowed or any(r["cudnn_tflops"] is not None or r["flash_tflops"] is not None
                           for r in windowed):
        raise AssertionError("decode_suite: a windowed config got a baseline")
    err = _held_to_plain("decode_suite", scorer, genome,
                         ("decode_w1024_s1024", "decode_w1024_s4096"))
    state.update(decode_suite_launches=launches, decode_suite_by_body=by_body,
                 max_abs_err=max(state.get("max_abs_err", 0.0), err))
    del scorer
    torch.cuda.empty_cache()


def phase_times(state):
    """flash_attention at every mha_suite shape for three genomes: the
    wgmma body against the mma_sync body in turns, the plain version at the
    smallest shape, and cuDNN's and FlashAttention's SDPA as yardsticks."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.core.evals.scorer import full_shape_inputs, time_cuda_ms
    from repro_torch.core.perfmodel import mha_suite, useful_flops
    from repro_torch.core.search_space import seed_genome
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME

    genomes = {"seed": seed_genome().kernel_kwargs(),
               "pipelined": dict(DEFAULT_ATTN_GENOME, gqa_pack=False),
               "best": state.get("best", seed_genome()).kernel_kwargs()}
    rows = []
    for cfg in mha_suite():
        q, k, v = full_shape_inputs(cfg, torch.device("cuda"), 0)
        lib = {}
        for name, backend in (("cudnn", SDPBackend.CUDNN_ATTENTION),
                              ("flash", SDPBackend.FLASH_ATTENTION)):
            try:
                with sdpa_kernel(backend):
                    lib[name] = time_cuda_ms(
                        lambda: torch.nn.functional.scaled_dot_product_attention(
                            q, k, v, is_causal=cfg.causal), reps=5)
            except RuntimeError as e:   # a yardstick the card lacks: recorded
                lib[name] = None
                lib[name + "_error"] = str(e)[:160]
        b_ms, b_by = bound(cfg)
        for tag, kw in genomes.items():
            t = in_turns(lambda body: time_cuda_ms(lambda: fa_launch(
                q, k, v, cfg.causal, kw, None if body == "wgmma" else body), reps=5),
                "mma_sync", "wgmma")
            ms = t["wgmma"]["ms"]
            row = {"phase": "times", "config": cfg.name, "genome": tag, "kernel_kwargs": kw,
                   "ms": ms, "tflops": useful_flops(cfg) / (ms * 1e-3) / 1e12,
                   "readings": t["wgmma"]["readings"], "mma_sync_ms": t["mma_sync"]["ms"],
                   "mma_sync_readings": t["mma_sync"]["readings"],
                   "speedup_vs_mma_sync": t["mma_sync"]["ms"] / ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms_cudnn": lib["cudnn"],
                   "library_ms_flash": lib["flash"], "plain_ms": None}
            if cfg.name == "mha_causal_s4096":          # the smallest shape
                row["plain_ms"] = time_cuda_ms(lambda: flash_attention_plain(
                    q, k, v, causal=cfg.causal, **kw), warmup=1, reps=1)
            row.update({k_: v_ for k_, v_ in lib.items() if k_.endswith("_error")})
            emit(row)
            rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    slower = [f"{r['config']} ({r['genome']})" for r in rows
              if r["genome"] == "pipelined" and r["ms"] >= r["mma_sync_ms"]]
    emit({"phase": "times", "check": "wgmma_vs_mma_sync_pipelined", "gate": False,
          "shapes": len(mha_suite()), "wgmma_slower_at": slower})
    state["times"] = rows
    _served_times(state)
    _head_dim_times(state)


def _head_dim_times(state):
    """Both attention kernels at the registry's head dims off the compiled
    widths, at the served prompt length, beside the compiled width in
    turns: flash_attention at h2o-danube-3-4b's 120 (zero-padded to 128)
    against 128 (GQA 32 / 8, causal), and at phi-3-vision-4.2b's 96 (MHA,
    the mma_sync body) beside SDPA; flash_decode at 120 and 96 (padded to
    128, the cache copied) against 128, L2 flushed.  Readings, not checks."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.evals.scorer import time_cuda_ms
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME

    S = (state.get("serve", {}).get("prompt_lens") or [2000])[0]
    B, Hq, L = SERVE_BATCH, 32, SERVE_MAX_LEN
    g = torch.Generator(device="cuda").manual_seed(6)
    kw = dict(DEFAULT_ATTN_GENOME, causal=True)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    out = {"flash_attention": {}, "flash_decode": {}}
    for arch, D, Hkv in (("h2o-danube-3-4b", 120, 8), ("phi-3-vision-4.2b", 96, 32)):
        q, k, v = rand(B, Hq, S, D), rand(B, Hkv, S, D), rand(B, Hkv, S, D)
        q_w, k_w, v_w = rand(B, Hq, S, 128), rand(B, Hkv, S, 128), rand(B, Hkv, S, 128)
        t = in_turns(lambda d: time_cuda_ms(
            (lambda: flash_attention(q, k, v, **kw)) if d == D else
            (lambda: flash_attention(q_w, k_w, v_w, **kw)), reps=5), 128, D)
        lib = time_cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hkv != Hq), reps=5)
        out["flash_attention"][D] = {
            "arch": arch, "shape": f"q ({B}, {Hq}, {S}, {D}), k/v ({B}, {Hkv}, {S}, {D})",
            "ms": t[D]["ms"], "readings": t[D]["readings"], "ms_at_128": t[128]["ms"],
            "library_ms": lib, "library": "sdpa"}
        del q, k, v, q_w, k_w, v_w
    vl = torch.full((B,), S + 16, dtype=torch.int32, device="cuda")
    for arch, D, Hkv in (("h2o-danube-3-4b", 120, 8), ("phi-3-vision-4.2b", 96, 32)):
        q, k, v = rand(B, Hq, D), rand(B, Hkv, L, D), rand(B, Hkv, L, D)
        q_w, k_w, v_w = rand(B, Hq, 128), rand(B, Hkv, L, 128), rand(B, Hkv, L, 128)
        t = in_turns(lambda d: time_cold_ms(
            (lambda: fd.flash_decode(q, k, v, vl)) if d == D else
            (lambda: fd.flash_decode(q_w, k_w, v_w, vl))), 128, D)
        out["flash_decode"][D] = {
            "arch": arch, "shape": f"q ({B}, {Hq}, {D}), cache ({B}, {Hkv}, {L}, {D}), "
                                   f"valid_len {S + 16}",
            "ms": t[D]["ms"], "readings": t[D]["readings"], "ms_at_128": t[128]["ms"]}
        del q, k, v, q_w, k_w, v_w
    torch.cuda.empty_cache()
    for name, rows in out.items():
        for D, row in rows.items():
            emit({"phase": "times", "check": "head_dim", "gate": False, "kernel": name,
                  "head_dim": D, **row})
    state["head_dim_times"] = out


def _served_times(state):
    """The three kernels at the served Jamba shapes (the first group's prompt
    length when the serve phase ran): kernel ms, bound, plain ms (one run),
    and a library yardstick where one PyTorch call computes the function.
    flash_attention's two bodies and flash_decode's one split against the
    wrapper's split count are timed in turns."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.evals.scorer import time_cuda_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd as sm
    from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME

    serve = state.get("serve", {})
    S = (serve.get("prompt_lens") or [2000])[0]
    B, Hq, Hkv, D = SERVE_BATCH, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(4)
    out = {}

    def yardstick(fn):
        try:
            return time_cuda_ms(fn, reps=5), None
        except (RuntimeError, TypeError) as e:     # recorded, not hidden
            return None, str(e)[:160]

    # flash_attention at the served prefill: causal, DEFAULT_ATTN_GENOME
    q = torch.randn((B, Hq, S, D), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    kw = dict(DEFAULT_ATTN_GENOME, gqa_pack=False)
    b_ms, b_by = attention_bound(B, Hq, Hkv, S, D)
    lib, err = yardstick(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    t = in_turns(lambda body: time_cuda_ms(lambda: fa_launch(
        q, k, v, True, kw, None if body == "wgmma" else body), reps=5), "mma_sync", "wgmma")
    out["flash_attention"] = {
        "shape": f"q ({B}, {Hq}, {S}, {D}), k/v ({B}, {Hkv}, {S}, {D}) bf16, causal",
        "ms": t["wgmma"]["ms"], "readings": t["wgmma"]["readings"],
        "mma_sync_ms": t["mma_sync"]["ms"], "mma_sync_readings": t["mma_sync"]["readings"],
        "plain_ms": time_cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, **kw),
                                 warmup=1, reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "library": "sdpa",
        "library_error": err}
    del q, k, v

    # flash_decode mid-decode of that group: every row at valid_len S + 16
    L = SERVE_MAX_LEN
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, L, D), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    valid = [S + 16] * B
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    mask = (torch.arange(L, device="cuda")[None, :] < vl[:, None])[:, None, None, :]
    b_ms, b_by = decode_bound(B, Hq, Hkv, D, valid)
    lib, err = None, None
    try:
        lib = time_cold_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))
    except (RuntimeError, TypeError) as e:
        err = str(e)[:160]
    splits = fd.kernel_splits(q, k)
    t = in_turns(lambda n: time_cold_ms(lambda: fd.flash_decode(
        q, k, v, vl, impl="kernel", splits=n)), 1, splits)
    sweep = {n: time_cold_ms(lambda: fd.flash_decode(q, k, v, vl, impl="kernel", splits=n))
             for n in DECODE_SWEEP}
    emit({"phase": "times", "check": "flash_decode_split_sweep", "gate": False,
          "wrapper_splits": splits, "ms_by_splits": sweep})
    out["flash_decode"] = {
        "shape": f"q ({B}, {Hq}, {D}), cache ({B}, {Hkv}, {L}, {D}) bf16, valid_len {valid[0]}",
        "splits": splits, "ms": t[splits]["ms"], "readings": t[splits]["readings"],
        "one_split_ms": t[1]["ms"], "one_split_readings": t[1]["readings"],
        "plain_ms": time_cuda_ms(lambda: fd.flash_decode_plain(q, k, v, vl, splits=splits),
                                 warmup=1, reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "library": "sdpa over the cache, valid_len mask, L2 flushed", "library_error": err}
    del q, k, v

    # ssd_chunked at the served prefill: Jamba's 128 heads of (64, 16)
    H, P, N, Q = 128, 64, 16, 256
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    x, dt, A, Bm, Cm = ssd_inputs(g, B, S, H, P, N, torch.bfloat16, A=A)
    b_ms, b_by = ssd_bound(B, S, H, P, N, Q)
    t = in_turns(lambda body: time_cold_ms(lambda: sm.ssd_chunked(
        x, dt, A, Bm, Cm, chunk=Q, impl="kernel", body=body)), "serial", "chunked")
    out["ssd_chunked"] = {
        "shape": f"x ({B}, {S}, {H}, {P}) bf16, B/C ({B}, {S}, 1, {N}), chunk {Q}",
        "ms": t["chunked"]["ms"], "readings": t["chunked"]["readings"],
        "serial_ms": t["serial"]["ms"], "serial_readings": t["serial"]["readings"],
        "plain_ms": time_cuda_ms(lambda: sm.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=Q),
                                 warmup=1, reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "library": "none"}
    del x, dt, Bm, Cm
    torch.cuda.empty_cache()
    for name, row in out.items():
        emit({"phase": "times", "kernel": name, "served": True, **row})
    state["served_times"] = out


def phase_kernels(state):
    times = {(r["config"], r["genome"]): r for r in state.get("times", [])}
    r = times.get(("mha_causal_s4096", "pipelined"), {})
    best = times.get(("mha_causal_s4096", "best"), {})
    seed = times.get(("mha_causal_s4096", "seed"), {})
    lib = [x for x in (r.get("library_ms_cudnn"), r.get("library_ms_flash"))
           if x is not None]
    served = state.get("served_times", {})
    serve = state.get("serve", {})
    serve_launches = serve.get("launches", {})
    serve_err = state.get("serve_err", {})
    fa_serve = served.get("flash_attention", {})
    entries = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:251",
        "launches": state.get("launches", 0) + state.get("tpu_plan_launches", 0)
        + state.get("rank_launches", 0) + state.get("gqa_launches", 0)
        + state.get("decode_suite_launches", 0) + serve_launches.get("flash_attention", 0),
        "launches_by_path": {"evolve": state.get("launches", 0),
                             "evolve_tpu_plan": state.get("tpu_plan_launches", 0),
                             "rank": state.get("rank_launches", 0),
                             "gqa": state.get("gqa_launches", 0),
                             "decode_suite": state.get("decode_suite_launches", 0),
                             "serve": serve_launches.get("flash_attention", 0)},
        "launches_by_body": {"evolve": state.get("evolve_by_body"),
                             "gqa": state.get("gqa_by_body"),
                             "decode_suite": state.get("decode_suite_by_body"),
                             "serve": serve.get("by_body")},
        "launches_by_rep": {"gqa": state.get("gqa_by_rep")},
        "launches_per_eval": state.get("per_eval"),
        "max_abs_err": state.get("max_abs_err"),
        "ms": r.get("ms"), "mma_sync_ms": r.get("mma_sync_ms"),
        "best_genome_ms": best.get("ms"), "best_genome_mma_sync_ms": best.get("mma_sync_ms"),
        "seed_genome_ms": seed.get("ms"), "seed_genome_mma_sync_ms": seed.get("mma_sync_ms"),
        "plain_ms": r.get("plain_ms"),
        "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
        "library_ms": min(lib) if lib else None,
        "shape": "mha_causal_s4096 (B=8, H=16, S=4096, D=128, bf16), the pipelined "
                 "genome (DEFAULT_ATTN_GENOME); wgmma body, mma_sync body beside it",
        "served": fa_serve,
        "head_dims": state.get("head_dim_times", {}).get("flash_attention")}]
    for name, src, replaces, err in (
            ("flash_decode", "flash_decode.cu", "src/repro/kernels/flash_decode.py:67",
             state.get("decode_err")),
            ("ssd_chunked", "ssd.cu", "src/repro/kernels/ssd.py:73", state.get("ssd_err"))):
        t = served.get(name, {})
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": serve_launches.get(name, 0),
            "launches_by_path": {"serve": serve_launches.get(name, 0)},
            "max_abs_err": err, "max_abs_err_served_bf16": serve_err.get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"), "shape": t.get("shape")}
        if name == "flash_decode":
            entry.update(splits=t.get("splits", state.get("decode_splits")),
                         one_split_ms=t.get("one_split_ms"),
                         head_dims=state.get("head_dim_times", {}).get("flash_decode"))
        else:
            entry.update(serial_ms=t.get("serial_ms"),
                         launches_by_body={"serve": serve.get("ssd_by_body")})
        entries.append(entry)
    emit({"kernels": entries})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    resolve_device("cuda")            # IEEE fp32 products for the gate and oracle

    t0 = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    state: dict = {}
    if "device" in phases:
        emit({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        device_check()
    runners = {"build": lambda st: phase_build(), "kernel": phase_kernel,
               "decode_kernel": phase_decode_kernel, "ssd_kernel": phase_ssd_kernel,
               "serve": phase_serve, "noise": phase_noise, "rank": phase_rank,
               "evolve": phase_evolve,
               "gqa": phase_gqa, "decode_suite": phase_decode_suite,
               "times": phase_times, "kernels": phase_kernels}
    for phase in PHASES[1:]:
        if phase in phases:
            t1 = time.perf_counter()
            runners[phase](state)
            emit({"phase": phase, "done": True, "wall_s": time.perf_counter() - t1})
    # model_checks_s: the rank phase, the pipelined reference scoring and the
    # TPU-planned evolution, which check the rung-0 models against the card
    emit({"phase": "done", "wall_s": time.perf_counter() - t0,
          "model_checks_s": state.get("model_checks_s")})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
