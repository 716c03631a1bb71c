#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases device,build,kernel

Phases, each printing one JSON line (any failure exits non-zero):
  device     card name, count, and nvidia-smi's name and power limit
  build      nvcc of the sm_90a flash-attention library from the checkout
  kernel     kernel vs its plain PyTorch version and vs the oracle: every
             combination of the six non-block genome axes x 3 block pairs on
             the gate's fp32 proxy shapes, bf16 at every mha_suite shape
             (with two wrong versions the bf16 bound must reject), and the
             gate's verdicts through kernel and plain version
  evolve     ContinuousEvolution(fidelity="measured") on mha_suite() for a
             bounded number of paid evaluations; the kernel must launch
  times      seed and best genome at every mha_suite shape: kernel ms, bound
             ms, SDPA (cuDNN, flash) as a yardstick, plain ms on the smallest
  kernels    the summary line of every ported kernel
The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX and
nothing of the JAX package.
"""
from __future__ import annotations

import argparse
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
PHASES = ("device", "build", "kernel", "evolve", "times", "kernels")

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
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load("flash_attention.cu")
    info = dict(_build.BUILD_INFO["flash_attention.cu"])
    emit({"phase": "build", "wall_s": time.perf_counter() - t0, **info})


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
    for cfg in mha_suite():
        q, k, v = full_shape_inputs(cfg, torch.device("cuda"), 0)
        small, good = cfg.name == "mha_causal_s4096", None
        mag = flash_attention_plain(q, k, v.abs(), causal=cfg.causal,
                                    **BF16_GENOMES[0])
        for kw in BF16_GENOMES + (BF16_GENOMES_SMALL if small else []):
            o = flash_attention(q, k, v, causal=cfg.causal, impl="kernel", **kw)
            p = flash_attention_plain(q, k, v, causal=cfg.causal, **kw)
            st = bf16_agreement(o, p, mag)
            emit({"phase": "kernel", "check": "full_width_bf16",
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


def phase_evolve(state):
    import torch

    from repro_torch.core.evolution import ContinuousEvolution
    from repro_torch.kernels.flash_attention import flash_attention

    evo = ContinuousEvolution(fidelity="measured")
    scorer = evo.scorer
    for cfg in scorer.suite:           # set-up: inputs made before the clock
        scorer.full_inputs(cfg)
    torch.cuda.synchronize()
    flash_attention.launches = 0
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
    wall = time.perf_counter() - t_all
    best = evo.lineage.best()
    if launches <= 0:
        raise AssertionError("the evolution never launched the kernel")
    for c in evo.lineage.commits:
        if not all(v > 0 and v == v for v in c.values):
            raise AssertionError(f"commit {c.version} has a non-positive value")
    emit({"phase": "evolve", "summary": True, "steps": step,
          "paid_evals": scorer.n_evaluations, "commits": len(evo.lineage),
          "launches": launches, "launches_per_eval": launches / scorer.n_evaluations,
          "wall_s": wall, "best_tflops": best.geomean,
          "best_values": list(best.values), "best_genome": best.genome.kernel_kwargs()})
    state.update(launches=launches, best=best.genome,
                 per_eval=launches / scorer.n_evaluations)
    evo.close()


def phase_times(state):
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.core.evals.scorer import full_shape_inputs, time_cuda_ms
    from repro_torch.core.perfmodel import mha_suite, useful_flops
    from repro_torch.core.search_space import seed_genome
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    genomes = {"seed": seed_genome(), "best": state.get("best", seed_genome())}
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
        for tag, g in genomes.items():
            kw = g.kernel_kwargs()
            ms = time_cuda_ms(lambda: flash_attention(
                q, k, v, causal=cfg.causal, impl="kernel", **kw), reps=5)
            row = {"phase": "times", "config": cfg.name, "genome": tag,
                   "ms": ms, "tflops": useful_flops(cfg) / (ms * 1e-3) / 1e12,
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
    state["times"] = rows


def phase_kernels(state):
    rows = [r for r in state.get("times", []) if r["genome"] == "best"
            and r["config"] == "mha_causal_s4096"]
    r = rows[0] if rows else {}
    lib = [x for x in (r.get("library_ms_cudnn"), r.get("library_ms_flash"))
           if x is not None]
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:251",
        "launches": state.get("launches", 0),
        "launches_per_eval": state.get("per_eval"),
        "max_abs_err": state.get("max_abs_err"),
        "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
        "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
        "library_ms": min(lib) if lib else None,
        "shape": "mha_causal_s4096 (B=8, H=16, S=4096, D=128, bf16), best genome"}]})


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
    if "build" in phases:
        phase_build()
    if "kernel" in phases:
        phase_kernel(state)
    if "evolve" in phases:
        phase_evolve(state)
    if "times" in phases:
        phase_times(state)
    if "kernels" in phases:
        phase_kernels(state)
    emit({"phase": "done", "wall_s": time.perf_counter() - t0})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
