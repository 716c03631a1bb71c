#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases device,build,kernel

Phases, each printing JSON lines (any failure exits non-zero):
  device         card name, count, and nvidia-smi's name and power limit
  build          nvcc of the three sm_90a libraries from the checkout, all
                 started together; registers and spills of every kernel
  kernel         flash_attention vs its plain PyTorch version and vs the
                 oracle: every combination of the six non-block genome axes
                 x 3 block pairs on the gate's fp32 proxy shapes, bf16 at
                 every mha_suite shape through the wgmma body (with two
                 wrong versions the bf16 bound must reject), and the gate's
                 verdicts through kernel and plain version
  decode_kernel  flash_decode vs its plain version walking the same splits:
                 fp32 over split count, rep, head_dim, ragged L,
                 per-sequence valid_len and softcap; bf16 at the served
                 Jamba shape under its bounds at several split counts, with
                 a wrong version (valid_len - 1) the bounds must reject
  ssd_kernel     ssd_chunked vs its plain version: fp32 on the serial body
                 over (P, N), chunk, ragged L and H; bf16 on the chunked body
                 over the same grid and at the served Jamba shape under its
                 bounds, with a wrong version (the state rounded to bf16
                 between chunks) the bounds must reject
  evolve         ContinuousEvolution(fidelity="measured") on mha_suite() for
                 a bounded number of paid evaluations; the kernel must launch
  serve          jamba-v0.1-52b at full width, 16 of its 32 layers, bf16,
                 random weights from a seeded generator on the card: 8
                 requests through BatchedServer (batch 4, 32 new tokens);
                 launch counts of all three kernels must equal what the path
                 implies; every launch of the first group is held against its
                 plain version; the teacher-forced agreement of kernel and
                 plain paths is printed beside witnesses (blocked vs plain:
                 no kernel; both again with the MoE routing frozen to the
                 plain path's); reduced Jamba's tokens on the card
                 must equal the CPU reference path's
  times          flash_attention's wgmma body against its mma_sync body, in
                 turns (mma_sync, wgmma, wgmma, mma_sync), for the seed, a
                 fixed pipelined genome and the search's best at every
                 mha_suite shape, and at the served prefill; flash_decode
                 (one split against the wrapper's split count, in turns, and
                 a sweep of split counts) and ssd_chunked (the serial body
                 against the chunked one, in turns) at the served shapes:
                 kernel ms, bound ms, plain
                 ms, and a library yardstick where one PyTorch call computes
                 the same function
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
PHASES = ("device", "build", "kernel", "decode_kernel", "ssd_kernel", "serve",
          "evolve", "times", "kernels")
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

    worst_bf16 = _full_width_bf16()

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

    # a small input against the reference: reduced Jamba in fp32, the card's
    # kernel path against the CPU's blocked path, same weights and requests
    small = get_arch(SERVE_ARCH).reduced()
    cpu_params = init_params(small, torch.Generator().manual_seed(0))

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}
    card_params = to_cuda(cpu_params)
    srng = np.random.default_rng(1)
    lens = srng.integers(5, 40, size=4)
    prompts = [srng.integers(0, small.vocab_size, (int(n),)) for n in lens]
    outs = {}
    for name, p in (("card", card_params), ("cpu", cpu_params)):
        srv = BatchedServer(small, p, batch_size=2, max_len=64)
        outs[name] = [r.output for r in srv.run([Request(i, pr, 8)
                                                 for i, pr in enumerate(prompts)])]
    emit({"phase": "serve", "check": "reduced_fp32_card_vs_cpu_reference",
          "tokens_equal": outs["card"] == outs["cpu"], "card": outs["card"],
          "cpu": outs["cpu"]})
    if outs["card"] != outs["cpu"]:
        faults.append("reduced Jamba: the card's tokens differ from the CPU reference's")
    if faults:
        raise AssertionError("serve: " + "; ".join(faults))


def phase_evolve(state):
    import torch

    from repro_torch.core.evolution import ContinuousEvolution
    from repro_torch.kernels.flash_attention import flash_attention

    evo = ContinuousEvolution(fidelity="measured")
    scorer = evo.scorer
    for cfg in scorer.suite:           # set-up: inputs made before the clock
        scorer.full_inputs(cfg)
    torch.cuda.synchronize()
    reset_counts(flash_attention)
    t_all = time.perf_counter()
    step = 0
    while scorer.n_evaluations < EVOLVE_EVALS and step < 3 * EVOLVE_EVALS:
        n0, t0 = scorer.n_evaluations, time.perf_counter()
        rep = evo.run(max_steps=1)
        dt = time.perf_counter() - t0
        paid = scorer.n_evaluations - n0
        best = evo.lineage.best()
        emit({"phase": "evolve", "step": step, "committed": rep.commits > 0,
              "best_tflops": best.geomean if best else 0.0, "paid_evals": paid,
              "s_per_eval": dt / paid if paid else None,
              "note": evo.island.traces[-1]["note"][:80]})
        step += 1
    launches = flash_attention.launches
    by_body = dict(flash_attention.launches_by_body)
    wall = time.perf_counter() - t_all
    best = evo.lineage.best()
    if launches <= 0:
        raise AssertionError("the evolution never launched the kernel")
    if by_body["wgmma"] <= 0:
        raise AssertionError(f"the measured rung never took the wgmma body: {by_body}")
    for c in evo.lineage.commits:
        if not all(v > 0 and v == v for v in c.values):
            raise AssertionError(f"commit {c.version} has a non-positive value")
    emit({"phase": "evolve", "summary": True, "steps": step,
          "paid_evals": scorer.n_evaluations, "commits": len(evo.lineage),
          "launches": launches, "launches_by_body": by_body,
          "launches_per_eval": launches / scorer.n_evaluations,
          "wall_s": wall, "best_tflops": best.geomean,
          "best_values": list(best.values), "best_genome": best.genome.kernel_kwargs()})
    state.update(launches=launches, best=best.genome, evolve_by_body=by_body,
                 per_eval=launches / scorer.n_evaluations)
    evo.close()


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
        "launches": state.get("launches", 0) + serve_launches.get("flash_attention", 0),
        "launches_by_path": {"evolve": state.get("launches", 0),
                             "serve": serve_launches.get("flash_attention", 0)},
        "launches_by_body": {"evolve": state.get("evolve_by_body"),
                             "serve": serve.get("by_body")},
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
        "served": fa_serve}]
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
                         one_split_ms=t.get("one_split_ms"))
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
    runners = {"build": lambda st: phase_build(), "kernel": phase_kernel,
               "decode_kernel": phase_decode_kernel, "ssd_kernel": phase_ssd_kernel,
               "serve": phase_serve, "evolve": phase_evolve, "times": phase_times,
               "kernels": phase_kernels}
    for phase in PHASES[1:]:
        if phase in phases:
            t1 = time.perf_counter()
            runners[phase](state)
            emit({"phase": phase, "done": True, "wall_s": time.perf_counter() - t1})
    emit({"phase": "done", "wall_s": time.perf_counter() - t0})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
