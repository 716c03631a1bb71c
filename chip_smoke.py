#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases device,build,kernel

Phases, each printing JSON lines (any failure exits non-zero):
  device         card name, count, and nvidia-smi's name and power limit; the
                 H100 model's SM count, L2 size and shared memory per block
                 held against torch.cuda.get_device_properties
  build          the three sm_90a libraries built from the checkout by
                 BUILD_PROCS spawned processes at once, as the workers of a pool
                 on a cold build directory would: nvcc must run once per
                 source (the others wait on its lock and load); registers
                 and spills of every kernel
  kernel         flash_attention vs its plain PyTorch version and vs the
                 oracle: every combination of the six non-block genome axes
                 x 3 block pairs on the gate's fp32 proxy shapes, bf16 at
                 every mha_suite shape through the wgmma body (with two
                 wrong versions the bf16 bound must reject), bf16 at the
                 head dims of h2o-danube-3-4b (120, zero-padded to 128) and
                 phi-3-vision-4.2b (96), and the gate's verdicts through
                 kernel and plain version
  decode_kernel  flash_decode vs its plain version walking the same splits:
                 fp32 on the simt body over split count, rep, head_dim (16,
                 64, 128), ragged L, per-sequence valid_len and softcap; bf16
                 on the wgmma body at the served Jamba shape under its bounds
                 at several split counts (two identical calls bit-equal),
                 with a wrong version (valid_len - 1) the bounds must reject,
                 and at head_dim 64, 96 and 120 (no copy); the wgmma body's
                 CTAs per SM against the split rule's; one kernel a bf16 call
                 (torch.profiler); shards: one sequence at long context, q
                 (1, 32, 128) against a (1, 8, LONG_LEN, 128) bf16 cache with
                 LONG_VALID live keys: the kernel over the whole cache, and
                 the partial mode over LONG_SHARDS equal length shards
                 (each shard's output and statistics against the plain
                 version's), merged and held against the plain version over
                 the whole cache under the bf16 bounds; the shards past
                 LONG_VALID read o = 0, M = -1e30, l = 0, no NaN, on both
                 bodies; the whole call and one shard's timed on the card's
                 own time beside the bytes bound and SDPA over the masked
                 cache; rank shape: what each model rank of qwen2-7b's
                 decode_32k runs (28 Q heads over 4 KV heads, rep 7, on
                 (data=16, model=16)), q (8, 28, 128) against a (8, 4,
                 RANK_LEN, 128) bf16 cache, every key live: the whole
                 launch, and the partial mode over RANK_SHARDS length
                 shards (each against the plain version, merged as
                 spmd.merge_over merges the gathered partials, against the
                 plain version over the whole cache), again with the last
                 shard empty; the whole launch and one shard's timed on
                 the card's own time beside their bounds and SDPA
  ssd_kernel     ssd_chunked vs its plain version: fp32 on the serial body
                 over (P, N), chunk, ragged L and H; bf16 on the chunked body
                 over the same grid and at the served Jamba shape under its
                 bounds, with a wrong version (the state rounded to bf16
                 between chunks) the bounds must reject
  rank           rungs 0 and 1 against rung 2 on mha_suite: RANK_GENOMES
                 genomes drawn with a fixed numpy seed (fp32 accumulators),
                 the seed and the pipelined genome, each scored once at the
                 measured rung; Spearman's rho of each rung-0 model's
                 geomeans (H100, TPU v5e) and of rung 1's against the
                 card's, the host seconds per estimate call of each model
                 and per rung-1 scoring (after one set-up scoring, the
                 trace memo emptied, then again with it warm); gates: rung
                 1's rho above 0 and its host seconds per scoring below
                 the card seconds of a rung-2 scoring
  noise          the measured rung's spread, unpaired and paired: NOISE_REPS
                 scorings of the seed and the pipelined genome on mha_suite
                 and gqa_suite, each paid anew (max / min - 1 of the
                 geomean), then NOISE_REPS paired comparisons of each genome
                 against itself (Scorer.paired_gain: max |gain|), printed
                 side by side with the seconds per paired decision; the
                 commit floor MEASURED_MIN_REL must not lie below the paired
                 spread, nor MEASURED_CALL_SPREAD below the unpaired one;
                 the sign check: two genomes of the rank sample
                 SIGN_BAND apart, paired NOISE_REPS times, must give gains of
                 one sign (noise needs rank)
  evolve         ContinuousEvolution(fidelity="measured") on mha_suite() for
                 a bounded number of paid evaluations, twice in turn: planned
                 from the H100 model and Hopper facts (the default), and from
                 the TPU v5e model's profiles and facts (the planning A/B);
                 the agent is the PairedAgent; the kernel must launch, and no
                 commit may be decided on a paired gain of MEASURED_MIN_REL
                 or less; each plan's commits, seconds per paired decision
                 and per paid evaluation, and the paid evaluations it took
                 to come within MEASURED_CALL_SPREAD of the pipelined genome,
                 scored earlier in the same call; the paper's
                 Fig. 3 rows of the H100-planned run: evolved, seed, cuDNN
                 and flash TFLOP/s per config (Scorer.baselines(): SDPA's
                 two backends)
  backends       the evaluation backends on the card (mha_suite, measured
                 rung): a slate of 8 genomes (the seed, the pipelined genome,
                 6 drawn as rank draws them) through the process and the
                 service backend, POOL_WORKERS spawned workers each, against
                 inline: equal gate verdicts, geomeans within
                 MEASURED_CALL_SPREAD; the card lock's sections of every process
                 disjoint; flash_attention launched on its fp32 and wgmma
                 bodies inside the workers; the measured evolution through
                 the process backend (spawn and warm seconds apart from the
                 steady state, seconds per paid evaluation beside evolve's
                 inline figure; the PairedAgent times on a scorer of its
                 own in this process), no commit at or below the floor; a service
                 worker SIGKILLed with REQUEUE_SLATE genomes in flight, every
                 result arriving with inline's verdicts; the elastic pool
                 (spawned slots) grown to POOL_WORKERS and shrunk back under
                 a queue held by a modelled latency
  islands        the island engine (scenario_specs(): mha, gqa, decode and
                 mha-explorer at the suites' full shapes, seed 0, rung 0 on
                 the H100 model, every gate on the fp32 kernel): the card's
                 lineages and migration ledger equal the same engine's on
                 the CPU, with fp32 gate launches on the card and none on
                 the CPU and this process's card-lock sections disjoint
                 across its threads; a run killed after ISLAND_RESUME_AT
                 steps and resumed from its file equals the uninterrupted
                 one; pipelined stepping on the process backend
                 (POOL_WORKERS spawned workers, a shared speculation budget)
                 equals it too, with every process's lock sections
                 disjoint; each island's best genome and the pipelined
                 genome read once at the measured rung beside cuDNN and
                 flash; the four islands raced against the serial loop on
                 the union suite to the serial run's final coverage
  cascade        the evaluation cascade through the island engine: the islands
                 phase's archipelago with cascade_eta=3 and slates of the best
                 genome and up to 8 suggestions, rung 0 on the H100 model
                 (fp32 gates), rung 1 traced on the meta device, rung 2
                 timed on the wgmma body, thread backend; gates: lineages
                 equal with the cascade off, promotion off and on; every
                 pass promotes at most max(1, n // 3) a rung, and a full
                 9-genome slate 1/3 to rung 1 and 1/9 to rung 2; the run's
                 card seconds (cache stats of rungs 0 and 2; rung 1 runs no
                 kernel, its host seconds printed beside) below the slates
                 scored flat at rung 2; rung 1 on the card equal to rung 1
                 on the CPU;
                 rung 2 on the wgmma body with lock sections disjoint; a run
                 killed after ISLAND_RESUME_AT steps adopts the payload's
                 calibration and log and resumes to the same lineages.
                 Printed, not gated: rung 0 against rung 2 rank inversions
                 before and after calibration, rung 1's against rung 2
                 beside them, the factors, and rung 1's
                 launch overhead (LAUNCH_REPS launches of the fp32 body)
  frontier       the search frontier: SearchFrontier with POOL_WORKERS spawned
                 workers on the card, two jobs of FRONTIER_PRIORITIES (equal
                 budgets, one seed, rung 0 on the H100 model, fp32 gates in
                 the workers), one submitted in process and one over the
                 wire through FrontierClient; both done with the fingerprint
                 of the same seed through IslandEvolution(backend="service")
                 on the card; every process's card-lock sections disjoint;
                 fp32 launches counted in the workers; each tenant's grants
                 while both ran and at the end
  gqa            paper §4.3: the evolve phase's best genome adapted to
                 gqa_suite at the measured rung for GQA_EVALS paid
                 evaluations, planned from the Hopper facts, committed on the
                 paired gain; launches at
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
                 requests through BatchedServer (batch 4, 32 new tokens), the
                 first group eagerly, every launch held against its plain
                 version, the others with the decode step a CUDA graph;
                 launch counts of all three kernels must equal what the path
                 implies; the second group eagerly and graphed in turns
                 (eager, graphed, graphed, eager: tokens equal, launches as
                 the path implies in each run, the graphed median below the
                 eager one; both medians, the capture and copy ms, each
                 mode's busy share of the step); the teacher-forced agreement of kernel and
                 plain paths is printed beside witnesses (blocked vs plain:
                 no kernel; both again with the MoE routing frozen to the
                 plain path's); every flash_decode call on the wgmma body,
                 and the requests' tokens again with it and with every call
                 routed to the simt body: equal, or a rounding tie at the
                 first difference; reduced Jamba's tokens on the card
                 must equal the CPU reference path's, and so must those of
                 reduced h2o-danube-3-4b and phi-3-vision-4.2b at their
                 published head dims (120, 96) with impl="auto"
  long_decode    jamba-v0.1-52b at full width (serve's depth and weights)
                 decoding one sequence at LONG_LEN keys: init_decode_cache
                 filled with seeded bf16 K/V up to LONG_VALID - 1 and seeded
                 fp32 Mamba states, LONG_STEPS greedy steps through
                 decode_step (2 flash_decode launches a step, all on the
                 wgmma body; ms per step, peak memory), then the same steps
                 as a CUDA graph, graphed and eager again (tokens and
                 launches equal, the graphed median below the eager one,
                 both busy shares), then with every launch held against its
                 plain version, eagerly, the tokens equal
  serve_encdec   seamless-m4t-medium at full width and full depth (12
                 encoder and 12 decoder layers), bf16, random weights from a
                 seeded generator on the card: (a) 8 requests through
                 BatchedServer (batch 4, 32 new tokens, zero frames of the
                 prompt's length, as the JAX package feeds them): 36
                 flash_attention launches per group (encoder, self- and
                 cross-attention, all on the wgmma body), 24 flash_decode
                 calls per decode step (the self and the cross cache, all on
                 the wgmma body), no ssd_chunked, every launch of the first
                 group held against its plain version (eagerly; the others
                 graphed, one capture a prompt length: the cross cache is as
                 long as the prompt), the second group eagerly and graphed
                 in turns (as serve's) and the tokens on the simt body (as
                 serve's); (b) prefill and ENCDEC_STEPS
                 decode steps with seeded random frames (ENCDEC_FRAMES
                 frames, ENCDEC_PROMPT-token prompts), every launch held
                 against its plain version, the cross shapes, the plain path
                 fed the same tokens (logits RMS and greedy agreement per
                 step) and a witness that other frames move the logits,
                 which must exceed kernel against plain; (c) reduced
                 seamless in fp32, card against CPU: BatchedServer's tokens
                 equal, and random-frame logits within ENCDEC_CARD_CPU_REL
  train          training on the card, through the blocked references (the
                 kernels have no backward): qwen2-7b at full width, 8 of
                 its 28 layers, bf16 compute on fp32 state, remat, 8 steps
                 of 8 x 1024 tokens in 2 microbatches (every loss finite,
                 the last below the first, peak memory under 90 % of the
                 card's, attention blocks recomputed in the backward:
                 ref.counts["step_remat"] above 0; seconds per step,
                 tokens/s, model TFLOP/s);
                 reduced qwen2-7b, moonshot-v1-16b-a3b and
                 seamless-m4t-medium in fp32 for 3 steps on the card and on
                 the CPU from the same weights
                 (per-step loss within TRAIN_PARITY_REL); a ResilientRunner
                 with one fault against an uninterrupted run (final loss
                 within TRAIN_RESTART_REL, one restart); the three kernel
                 guards raising on inputs that require grad; no kernel
                 launch in the phase
  mesh           the device mesh on the card: a one-rank NCCL process group
                 (a file:// store under build/) and make_host_mesh() as
                 (data=1, model=1); (a) qwen2-7b at full width (the train
                 phase's depth, batch, sequence, microbatches and lr),
                 MESH_TRAIN_STEPS steps through the mesh step (DTensor
                 parameters and moments, gradients reduced to their
                 placements) and as many unsharded from the same seed: the
                 first-step losses within MESH_LOSS_REL, each step's loss,
                 grad norm, seconds and the peak memory of both, no
                 loss call on the vocab shards (transformer.counts
                 ["loss_shards"]: one model rank holds the whole vocab) and
                 no attention projecting only its KV heads
                 (attention.counts["kv_columns"]: one model rank reads
                 every KV head); (b)
                 jamba-v0.1-52b at full width (serve's depth), one group of
                 SERVE_BATCH requests of SERVE_PROMPT lengths, MESH_SERVE_NEW
                 greedy tokens through BatchedServer on the mesh and off it,
                 every launch held against its plain version: equal tokens,
                 the serve phase's launches per group (every kernel on its
                 rank's local shard), prefill and step ms of both paths, and
                 the decode steps' products on the weights' shards
                 (spmd.counts: every product through the route, no
                 collective on one rank), no Mamba block on the
                 own-columns route (ssm.counts: one model rank multiplies
                 the whole in_proj as it is), no decode attention whose
                 cache length splits over "model" (attention.counts: one
                 model rank holds the whole length), no head call that
                 splits the vocab over "model" (transformer.counts: one
                 model rank computes every column) and no attention on the
                 own-KV-heads route (attention.counts["kv_columns"]);
                 (c) checkpoint_restart: the train phase's ResilientRunner
                 (reduced TRAIN_ARCH, a checkpoint every 2 steps, one fault
                 at TRAIN_RESTART_FAULT) on the mesh, its state DTensors,
                 each save gathering them, the restore placing them with
                 train_state_shardings: the final loss equal to the
                 uninterrupted mesh run's exactly, the restored parameters
                 and moments DTensors on cuda, no kernel launch; the
                 seconds of every save and restore (both runs) and the
                 checkpoint's bytes beside nvidia-smi's name and power limit;
                 (d) checkpoint_full_width: one save and one restore of
                 TRAIN_ARCH's fp32 train state at full width, cut to
                 CKPT_LAYERS layers (every leaf at its published shape;
                 parameters, mu and nu drawn from the seed), on the mesh:
                 every restored shard equal to the saved one on the card,
                 DTensors on cuda, the seconds and GB/s of each, the
                 checkpoint's bytes and the peak device memory
  dryrun         the dry run (repro_torch.launch.dryrun) in one subprocess,
                 which must never initialise CUDA: mamba2-780m decode_32k on
                 the 256- and 512-rank fake meshes, qwen2-7b prefill_32k and
                 train_4k and mixtral-8x22b decode_32k on the 256-rank one
                 (meta tensors, fake process group); the pinned pod1 record
                 of mamba2-780m equal to the CPU test's (DRYRUN_PINNED); one
                 line per record (terms, dominant, useful fraction,
                 collective bytes a rank and by axis, the top three
                 collective sites, wall seconds); a decode record fails on a
                 site that gathers a product's weight or the table
                 (">use": a weight through spmd.dot or spmd.lookup's
                 gather).  Calibration: one-device records of the train
                 phase's step and of the serve phase's decode step; the
                 largest term of each no more than the time the phase
                 measured, and the train record's argument + temp bytes
                 within DRYRUN_MEM_REL of the train phase's peak
  times          flash_attention's wgmma body against its mma_sync body, in
                 turns (mma_sync, wgmma, wgmma, mma_sync), for the seed, a
                 fixed pipelined genome and the search's best at every
                 mha_suite shape, and at the served prefill; flash_decode
                 (its wgmma body against its simt body, in turns, each beside
                 its device time with the host's enqueue hidden behind a
                 spin kernel, again after a flush that writes, and a sweep
                 of split counts) and ssd_chunked
                 (the serial body against the chunked one, in turns) at the
                 served shapes: kernel ms, bound ms, plain
                 ms, and a library yardstick where one PyTorch call computes
                 the same function; both attention kernels at head_dim 120
                 and 96 beside 128; both attention kernels in
                 seamless-m4t-medium's roles (the encoder's non-causal
                 self-attention, cross-attention, decode over the cross
                 cache) beside SDPA.  The L2 is flushed by reading 256 MB
  kernels        the summary line of every ported kernel
The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX and
nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
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
BUILD_PROCS = 2                # processes that build the kernels at once
POOL_WORKERS = 2            # workers of each pool of the backends phase
SLATE_DRAWN = 6             # genomes drawn (as rank draws them) for its slate
REQUEUE_SLATE = 6           # genomes in flight when a service worker is killed
ELASTIC_LATENCY_S = 0.5     # modelled latency that holds the elastic pool's queue
ELASTIC_IDLE_S = 1.0        # idle seconds after which it retires a worker
ISLAND_STEPS = 6            # steps per island of the islands phase's runs
ISLAND_INTERVAL = 2         # steps per epoch (migration barrier)
ISLAND_RESUME_AT = 4        # steps before the resume check's kill
ISLAND_PREFETCH_BUDGET = 6  # shared speculation budget of the pipelined run
RACE_SERIAL_STEPS = 24      # steps of the serial side of the race
RACE_ISLAND_STEPS = 12      # steps per island of the island side
CASCADE_ETA = 3             # successive-halving rate of the cascade phase
CASCADE_SLATE = 8           # KB suggestions beside each island's best, at most
CASCADE_SEED = 1            # seed of the full 9-genome slate (drawn as rank draws)
LAUNCH_REPS = 200           # back-to-back launches timed for the launch overhead
SIGN_BAND = (0.02, 0.05)    # unpaired difference of the sign check's two genomes
FRONTIER_PRIORITIES = (4.0, 1.0)    # the in-process and the over-the-wire tenant
FRONTIER_BUDGET = 400       # paid evaluations per job (the steps end first)
FRONTIER_STEPS = 6          # archipelago steps per job, migration every 2
FRONTIER_SEED = 5           # both jobs' seed, and the direct run's
FRONTIER_SUITE, FRONTIER_ISLANDS = "mha+gqa+decode", 4    # each job's archipelago
PHASES = ("device", "build", "kernel", "decode_kernel", "ssd_kernel", "serve", "long_decode",
          "serve_encdec", "train", "mesh", "dryrun", "rank", "noise", "evolve", "backends", "islands",
          "cascade", "frontier", "gqa", "decode_suite", "times", "kernels")
SOURCES = ("flash_attention.cu", "flash_decode.cu", "ssd.cu")
TOL_SSD_F32 = 2e-5          # SSD kernel vs plain, fp32: relative to max |y|
SERVE_ARCH, SERVE_LAYERS = "jamba-v0.1-52b", 16
SERVE_BATCH, SERVE_REQUESTS, SERVE_NEW, SERVE_MAX_LEN = 4, 8, 32, 4096
SERVE_PROMPT = (1000, 2049)         # prompt lengths drawn in [lo, hi)
DECODE_SPLITS = (1, 2, 3, 5, 8, None)   # None: the wrapper's split count
DECODE_SWEEP = (2, 4, 6, 8, 10, 12, 16)  # wgmma split counts timed at the served shape
TEACHER_STEPS = 8                   # decode steps of the teacher-forced reading
# one sequence at long context (the dry run's long_500k cell): the cache
# length, the live keys, the equal length shards the partial mode is merged
# over in decode_kernel, and long_decode's greedy steps
LONG_LEN, LONG_VALID, LONG_SHARDS, LONG_STEPS = 524288, 400000, (2, 4, 16), 8
# one model rank of qwen2-7b's decode_32k on (data=16, model=16): its 8 rows,
# all 28 Q heads over 4 KV heads, the cache's 32 768 slots split over the 16
# model ranks
RANK_ROWS, RANK_LEN, RANK_SHARDS = 8, 32768, 16
# where the served tokens of flash_decode's two bodies part: a tie is two
# router probabilities, or a token's logit and the best one, within 4 bf16
# ulps in both runs (two roundings of each of two values), among the top 4
DECODE_TIE_ULPS, DECODE_TIE_TOP = 4, 4
ENCDEC_ARCH = "seamless-m4t-medium"         # served at full width and full depth
ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_STEPS = 1500, 16, 32   # direct part: Se, S, steps
ENCDEC_CARD_CPU_STEPS = 8                   # reduced fp32 decode steps, card vs CPU
ENCDEC_CARD_CPU_REL = 1e-4                  # their logits, relative (fp32, TF32 off)
PROFILE_NEW = 4                     # new tokens of the profiled pass
TRAIN_ARCH, TRAIN_LAYERS = "qwen2-7b", 8    # full width, depth cut 28 -> 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 1024, 2, 8
TRAIN_LR = 1e-4             # peak lr (2 warmup steps); 1e-3 diverges at this width
TRAIN_WITNESS_STEPS = 3     # full-width steps again in fp32 compute, beside bf16's
TRAIN_WITNESS_REL = (1e-3, 1e-3)    # first step: loss, grad norm, bf16 vs fp32
TRAIN_PARITY_ARCHS = ("qwen2-7b", "moonshot-v1-16b-a3b",   # reduced, card vs CPU
                      "seamless-m4t-medium")
TRAIN_PARITY_STEPS = 3
TRAIN_PARITY_REL = 1e-4     # per-step loss, card vs CPU (fp32; atomics on the card)
TRAIN_RESTART_STEPS, TRAIN_RESTART_FAULT = 6, 3     # steps, and the step that faults
TRAIN_RESTART_REL = 1e-5    # final loss, restarted run vs uninterrupted
TRAIN_PEAK_SHARE = 0.9      # peak memory, share of the card's
MESH_TRAIN_STEPS = 2        # full-width train steps on each path of the mesh phase
MESH_LOSS_REL = 1e-3        # first-step loss, mesh vs unsharded (relative)
MESH_SERVE_NEW = 8          # greedy tokens of the mesh phase's one group
CKPT_LAYERS = 1             # the full-width checkpoint: depth cut 28 -> 1 (~16 GB of fp32)
DRYRUN_CELLS = (("mamba2-780m", "decode_32k", (False, True)),   # (arch, cell, multi_pod)
                ("qwen2-7b", "prefill_32k", (False,)), ("qwen2-7b", "train_4k", (False,)),
                ("mixtral-8x22b", "decode_32k", (False,)))
# mamba2-780m decode_32k on the 256-rank mesh: tests/test_torch_dryrun.py's PINNED_POD1
DRYRUN_PINNED = {"hlo_dot_flops": 808230912.0,
                 "collective_bytes": {"all-gather": 11392000, "all-to-all": 2408448,
                                     "all-reduce": 12694528}}
DRYRUN_MEM_REL = 0.2        # train record's argument + temp bytes against the measured peak
DRYRUN_TIMEOUT_S = 300      # the dry-run subprocess (about 60-100 s on the chip host)
# the row split's kernel launches (each model rank's query rows, q_offset =
# its first row): the gate loop's band [ROW_BAND_LO, 160) of its proxy
# shapes; qwen2-7b's 16 model ranks' shards of a 4096-row sequence, checked
# against the whole launch; and prefill_32k's rank shape (2048 rows a rank
# of 32768), timed on the shards of ranks ROW_TIMED
ROW_BAND_LO = 88
ROW_SHARDS, ROW_CHECK_S, ROW_RANK_ROWS, ROW_TIMED = 16, 4096, 2048, (0, 7, 15)

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


def _build_all(out) -> None:
    """One build process: every source built at once, one thread each;
    its pid and BUILD_INFO go to the queue ``out``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        list(ex.map(_build.build, SOURCES))
    out.put((os.getpid(), {src: _build.BUILD_INFO[src] for src in SOURCES}))


def phase_build():
    """BUILD_PROCS spawned processes build the three sources at once, as the
    workers of a pool on a cold build directory would: each source's nvcc
    must run once (none if it was built already), the other build processes wait
    on its lock and load.  Then the libraries are loaded here."""
    import multiprocessing

    from repro_torch.kernels import _build
    cold = {src: not _build.library_path(src).exists() for src in SOURCES}
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_build_all, args=(out,)) for _ in range(BUILD_PROCS)]
    try:
        for p in procs:
            p.start()
        infos: dict = {}
        while len(infos) < len(procs):          # drained before the joins
            try:
                pid, info = out.get(timeout=5)
            except queue.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed or time.perf_counter() - t0 > 600:
                    raise AssertionError(f"a build process failed (exit codes {failed}); "
                                         "its nvcc error is on stderr")
                continue
            infos[pid] = info
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"build process {p.pid} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    for src in SOURCES:
        _build.load(src)
    wall = time.perf_counter() - t0
    for src in SOURCES:
        built = [pid for pid, info in infos.items() if not info[src]["cached"]]
        info = next((infos[pid][src] for pid in built), infos[next(iter(infos))][src])
        emit({"phase": "build", "source": src, "wall_s": wall, "cold": cold[src],
              "build_procs": len(procs), "nvcc_runs": len(built),
              "lock_wait_s": [i[src]["lock_wait_s"] for i in infos.values()],
              **{k: v for k, v in info.items() if k != "lock_wait_s"}})
        if len(built) != int(cold[src]):
            raise AssertionError(f"{src}: nvcc ran {len(built)} times across "
                                 f"{len(procs)} build processes (cold: {cold[src]})")


def _proxy(rng, Hkv, causal, window):
    import numpy as np
    import torch
    arrs = [rng.normal(size=(1, h, 160, 64)).astype(np.float32)
            for h in (4, Hkv, Hkv)]
    return [torch.from_numpy(a).cuda() for a in arrs], dict(causal=causal,
                                                            window=window)


def _proxy_band(rng, Hkv, window, lo=ROW_BAND_LO):
    """A proxy shape's rows [lo, 160) with ``q_offset`` = lo against all
    160 keys, causal: a row shard as the models' row split launches one."""
    (q, k, v), sh = _proxy(rng, Hkv, True, window)
    return [q[:, :, lo:].contiguous(), k, v], dict(sh, q_offset=lo)


def _row_shard_bound(B, Hq, Hkv, Sq, D, off, esize=2) -> tuple:
    """A causal row shard: rows [off, off + Sq) against keys [0, off +
    Sq); each row's useful QK^T and PV over its off + row + 1 keys; q and
    o, and the K/V rows it reads, once."""
    keys = Sq * (off + 1) + Sq * (Sq - 1) // 2           # sum over rows of off + row + 1
    nbytes = 2 * B * Hq * Sq * D * esize + 2 * B * Hkv * (off + Sq) * D * esize
    return _bound(nbytes, 4.0 * B * Hq * D * keys)


def _row_shards() -> dict:
    """The kernel's query-row offset as the models' row split launches it
    (each model rank's rows of a sequence, q_offset = its first row).
    Correctness at qwen2-7b's heads, bf16: q (2, 28, 4096, D) against K/V
    (2, 4, 4096, D), causal and with a window of 1024, cut into ROW_SHARDS
    row shards; each launched with its offset, concatenated, equal to the
    whole launch bit for bit (every shard starts on one of the whole
    launch's 128-row blocks) and within the bf16 bounds of the plain
    version's whole call.  D = 128 takes the wgmma body, D = 96 the
    mma_sync body.  Timing at ``prefill_32k``'s rank shape: q (2, 28, 2048,
    128) against K/V (2, 4, 32768, 128), the shards of ranks ROW_TIMED,
    each held against its plain version's output within the bf16 bounds
    and timed beside its bound, its plain version and one SDPA call over
    the K/V rows it reads (``causal_lower_right``)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.core.evals.scorer import time_cuda_ms
    from repro_torch.kernels.flash_attention import (attention_body, bf16_agreement,
                                                     bf16_agrees, flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME

    g = torch.Generator(device="cuda").manual_seed(30)
    genome = dict(DEFAULT_ATTN_GENOME, gqa_pack=False)
    B, Hq, Hkv = 2, 28, 4
    faults, out = [], {"checks": []}

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    S = ROW_CHECK_S
    n = S // ROW_SHARDS
    for D in (128, 96):
        body = attention_body(torch.bfloat16, D)
        q, k, v = rand(B, Hq, S, D), rand(B, Hkv, S, D), rand(B, Hkv, S, D)
        for window in (None, 1024):
            kw = dict(genome, causal=True, window=window)
            by_body = flash_attention.launches_by_body[body]
            whole = flash_attention(q, k, v, impl="kernel", **kw)
            shards = torch.cat([flash_attention(q[:, :, r * n:(r + 1) * n].contiguous(), k, v,
                                                impl="kernel", q_offset=r * n, **kw)
                                for r in range(ROW_SHARDS)], dim=2)
            launched = flash_attention.launches_by_body[body] - by_body
            st = bf16_agreement(shards, flash_attention_plain(q, k, v, **kw),
                                flash_attention_plain(q, k, v.abs(), **kw))
            equal = bool(torch.equal(shards, whole))
            row = {"phase": "kernel", "check": "row_shards_bf16", "body": body,
                   "window": window,
                   "shape": f"q ({B}, {Hq}, {S}, {D}), k/v ({B}, {Hkv}, {S}, {D}) bf16, causal",
                   "shards": ROW_SHARDS, "rows_a_shard": n, "equal_to_whole_launch": equal,
                   "launches_on_body": launched, **st}
            emit(row)
            out["checks"].append(row)
            case = f"D {D} ({body}), window {window}"
            if not equal:
                faults.append(f"{case}: the shards differ from the whole launch by "
                              f"{float((shards.float() - whole.float()).abs().max())}")
            if not bf16_agrees(st):
                faults.append(f"{case}: the shards against the plain version: {st}")
            if launched != ROW_SHARDS + 1:
                faults.append(f"{case}: {launched} {body} launches, not {ROW_SHARDS + 1}")
        del q, k, v, whole, shards

    Sq, Sk, D = ROW_RANK_ROWS, ROW_RANK_ROWS * ROW_SHARDS, 128
    q, k, v = rand(B, Hq, Sq, D), rand(B, Hkv, Sk, D), rand(B, Hkv, Sk, D)
    kw = dict(genome, causal=True)
    times = {}
    for r in ROW_TIMED:
        off = r * Sq
        b_ms, b_by = _row_shard_bound(B, Hq, Hkv, Sq, D, off)
        ms = time_cuda_ms(lambda: flash_attention(q, k, v, impl="kernel", q_offset=off, **kw),
                          reps=5)
        o = flash_attention(q, k, v, impl="kernel", q_offset=off, **kw)
        p = flash_attention_plain(q, k, v, q_offset=off, **kw)      # the timing's warm-up
        plain_ms = time_cuda_ms(lambda: flash_attention_plain(q, k, v, q_offset=off, **kw),
                                warmup=0, reps=1)
        st = bf16_agreement(o, p, flash_attention_plain(q, k, v.abs(), q_offset=off, **kw))
        del o, p
        kr, vr = k[:, :, :off + Sq].contiguous(), v[:, :, :off + Sq].contiguous()
        mask = causal_lower_right(Sq, off + Sq)
        lib = time_cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mask, enable_gqa=True), reps=5)
        del kr, vr
        times[r] = {"rank": r, "q_offset": off, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                    "library": "sdpa, causal_lower_right, enable_gqa", **st}
        emit({"phase": "kernel", "check": "row_shard_time",
              "shape": f"q ({B}, {Hq}, {Sq}, {D}) bf16 at q_offset {off}, k/v ({B}, {Hkv}, "
                       f"{Sk}, {D}), causal", **times[r]})
        if not bf16_agrees(st):
            faults.append(f"rank {r} (q_offset {off}) against the plain version: {st}")
    out["timed"] = times
    del q, k, v
    torch.cuda.empty_cache()
    if faults:
        raise AssertionError("row shards: " + "; ".join(faults))
    return out


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
    # row shards: rows [88, 160) at q_offset 88, GQA 4 / 2, causal, windowed
    shapes += [_proxy_band(rng, 2, w) for w in (None, 48)]
    blocks = ((16, 16), (32, 128), (128, 64))
    worst_f32 = worst_oracle = 0.0
    bf16_min_oracle = float("inf")
    n = n_offset = 0
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
                n_offset += "q_offset" in sh
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
          "cases_with_q_offset": n_offset,
          "max_abs_err_vs_plain_f32acc": worst_f32,
          "max_abs_err_vs_oracle_f32acc": worst_oracle,
          "min_abs_err_vs_oracle_bf16acc": bf16_min_oracle,
          "tol_vs_plain": TOL_F32, "tol_vs_oracle": CORRECTNESS_TOL})

    worst_bf16 = max(_full_width_bf16(), _padded_head_dims())
    state["row_shards"] = _row_shards()
    rows = state["row_shards"]
    worst_bf16 = max([worst_bf16] + [c["max_abs_err"] for c in rows["checks"]]
                     + [t["max_abs_err"] for t in rows["timed"].values()])

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


def _l2_flush(kind: str = "read"):
    """A function that pushes the 50 MB L2 out with 256 MB of traffic:
    "read" sums a buffer, as the weight reads between two decode steps
    would; "write" zeroes it, which leaves the L2 full of dirty lines whose
    write-back then competes with the timed kernel's reads."""
    import torch
    buf = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    if kind == "write":
        return buf.zero_
    words, sink = buf.view(torch.int64), torch.empty(1, dtype=torch.int64, device="cuda")
    return lambda: torch.sum(words, dim=0, keepdim=True, out=sink)


def time_cold_ms(fn, reps: int = 20, warmup: int = 3, flush: str = "read",
                 cushion: bool = False) -> float:
    """Median CUDA-event milliseconds of ``fn()`` with the L2 cache flushed
    before every run (``_l2_flush``): on the served path a decode launch
    finds its K/V cold (the layers between two steps stream gigabytes of
    weights).  The reading includes any time the host takes to enqueue
    ``fn``'s work beyond the flush's.  With ``cushion``, a spin kernel of
    about 1 ms runs between the flush and the start event, so the host has
    enqueued all of ``fn`` before the card reaches it: the reading is then
    the card's time for the call alone, host gaps excluded."""
    import statistics

    import torch
    flush_l2 = _l2_flush(flush)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush_l2()
        if cushion:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels_a_call(fn, reps: int = 3) -> dict:
    """The CUDA kernels ``fn()`` launches per call and their names, from
    torch.profiler (warm, nothing else in the window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"kernels_per_call": sum(e.count for e in rows) / reps,
            "kernels": sorted({e.key[:80] for e in rows})}


@contextlib.contextmanager
def decode_routed_to_simt():
    """Every flash_decode call inside takes the simt body: the A/B of the
    served tokens, routed from this script's side (the server has no such
    option)."""
    from repro_torch.kernels import flash_decode as fd
    routed = fd.decode_body
    fd.decode_body = lambda dtype, head_dim: "simt"
    try:
        yield
    finally:
        fd.decode_body = routed


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
    over the axes on the simt body; bf16 on the wgmma body at the served
    shape under its bounds at several split counts (two identical calls
    bit-equal), with a wrong version that must fail, and at the registry's
    other head dims; the wgmma body's occupancy, and one kernel a call."""
    import itertools

    import numpy as np
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import decode_reference

    rng = np.random.default_rng(1)
    worst_plain = worst_ref = 0.0
    n = 0
    fp32_before = dict(fd.flash_decode.launches_by_body)
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
    fp32_took = {b: fd.flash_decode.launches_by_body[b] - fp32_before[b] for b in fd.BODIES}
    emit({"phase": "decode_kernel", "check": "fp32_grid", "cases": n,
          "splits": [s or "wrapper's" for s in DECODE_SPLITS],
          "launches_by_body": fp32_took,
          "max_abs_err_vs_plain": worst_plain, "max_abs_err_vs_reference": worst_ref,
          "tol": TOL_F32})
    faults = []
    if fp32_took != {"wgmma": 0, "simt": n}:
        faults.append(f"fp32 launches by body {fp32_took}: all {n} must take simt")

    # the wgmma body's occupancy: the split rule assumes CTAS_PER_SM
    occupancy = {D: fd.wgmma_ctas_per_sm(D) for D in (64, 128)}
    emit({"phase": "decode_kernel", "check": "wgmma_ctas_per_sm", "by_head_dim": occupancy,
          "split_rule_assumes": fd.CTAS_PER_SM, "ring_depth": fd.RING_DEPTH})
    if set(occupancy.values()) != {fd.CTAS_PER_SM}:
        faults.append(f"wgmma CTAs per SM {occupancy}, the split rule assumes "
                      f"{fd.CTAS_PER_SM}")

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
    before, checked = dict(fd.flash_decode.launches_by_body), 0
    for softcap in (0.0, 50.0):
        for splits in (auto, 1, 3, 8):
            kw = dict(softcap=softcap, splits=splits)
            plain = fd.flash_decode_plain(q, k, v, vl, **kw)
            mag = fd.flash_decode_plain(q, k, v.abs(), vl, **kw)
            out = fd.flash_decode(q, k, v, vl, impl="kernel", **kw)
            again = fd.flash_decode(q, k, v, vl, impl="kernel", **kw)
            checked += 2
            st = fd.bf16_agreement(out, plain, mag)
            bit_equal = bool(torch.equal(out, again))
            emit({"phase": "decode_kernel", "check": "served_bf16", "body": "wgmma",
                  "softcap": softcap, "splits": splits, "wrapper_splits": splits == auto,
                  "two_calls_bit_equal": bit_equal, **st, **bounds})
            worst_bf16 = max(worst_bf16, st["max_abs_err"])
            verdicts.append((f"kernel, {splits} splits", softcap,
                             fd.bf16_agrees(st) and bit_equal, True))
        wrong = fd.flash_decode_plain(q, k, v, vl - 1, softcap=softcap)
        st = fd.bf16_agreement(wrong, fd.flash_decode_plain(q, k, v, vl, softcap=softcap),
                               fd.flash_decode_plain(q, k, v.abs(), vl, softcap=softcap))
        emit({"phase": "decode_kernel", "check": "served_bf16_control",
              "control": "valid_len-1", "softcap": softcap, **st, **bounds})
        verdicts.append(("valid_len-1", softcap, fd.bf16_agrees(st), False))
    # bf16 at the registry's head dims off the served one, each arch's heads:
    # seamless-m4t-medium's 64, phi-3-vision-4.2b's 96 and h2o-danube-3-4b's
    # 120 (the last two in 128-wide tiles, TMA filling the columns past D)
    for arch, D, Hq_d, Hkv_d in (("seamless-m4t-medium", 64, 16, 16),
                                 ("phi-3-vision-4.2b", 96, 32, 32),
                                 ("h2o-danube-3-4b", 120, 32, 8)):
        qd = torch.randn((B, Hq_d, D), generator=g, device="cuda").to(torch.bfloat16)
        kd, vd = (torch.randn((B, Hkv_d, L, D), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        launched = fd.flash_decode.launches
        out = fd.flash_decode(qd, kd, vd, vl, impl="kernel")
        checked += 1
        n = fd.kernel_splits(qd, kd)
        st = fd.bf16_agreement(out, fd.flash_decode_plain(qd, kd, vd, vl, splits=n),
                               fd.flash_decode_plain(qd, kd, vd.abs(), vl, splits=n))
        emit({"phase": "decode_kernel", "check": "head_dim_bf16", "arch": arch,
              "head_dim": D, "body": fd.decode_body(qd.dtype, D), "splits": n,
              "shape": f"q ({B}, {Hq_d}, {D}), cache ({B}, {Hkv_d}, {L}, {D})",
              "launches": fd.flash_decode.launches - launched, **st, **bounds})
        worst_bf16 = max(worst_bf16, st["max_abs_err"])
        verdicts.append((f"kernel at head_dim {D}", 0.0,
                         fd.bf16_agrees(st) and fd.flash_decode.launches == launched + 1
                         and out.shape == qd.shape, True))
        del qd, kd, vd
    took = {b: fd.flash_decode.launches_by_body[b] - before[b] for b in fd.BODIES}
    if took != {"wgmma": checked, "simt": 0}:
        faults.append(f"{checked} bf16 calls, launches by body {took}: all must take wgmma")
    # one bf16 call is one kernel launch: with one split and with the rule's,
    # and at 96 and 120 (no copy of the cache)
    calls = {f"splits {n}": (lambda n=n: fd.flash_decode(q, k, v, vl, splits=n)) for n in (1, auto)}
    for D, Hkv_d in ((96, 32), (120, 8)):
        qd = torch.randn((B, 32, D), generator=g, device="cuda").to(torch.bfloat16)
        kd = torch.randn((B, Hkv_d, L, D), generator=g, device="cuda").to(torch.bfloat16)
        calls[f"head_dim {D}"] = lambda qd=qd, kd=kd: fd.flash_decode(qd, kd, kd, vl)
    for name, call in calls.items():
        seen = kernels_a_call(call)
        emit({"phase": "decode_kernel", "check": "one_launch_a_call", "call": name, **seen})
        if seen["kernels_per_call"] != 1 or "decode_wgmma" not in "".join(seen["kernels"]):
            faults.append(f"a bf16 call ({name}) launched {seen}")
    faults += [f"{who} (softcap {sc}) {'failed' if want else 'passed'} the bf16 bounds"
               for who, sc, ok, want in verdicts if ok != want]
    if worst_plain > TOL_F32 or worst_ref > TOL_F32:
        faults.append(f"fp32: {worst_plain} vs plain, {worst_ref} vs reference")
    state["decode_shards"] = _decode_shards(faults)
    state["decode_rank_shape"] = _decode_rank_shape(faults)
    if faults:
        raise AssertionError("flash_decode: " + "; ".join(faults))
    state["decode_err"] = max(worst_plain, worst_bf16)
    state["decode_splits"] = auto


def _partial_shards(q, k, v, vl, n: int, faults: list, what: str, body=None) -> tuple:
    """flash_decode's partial mode over ``n`` equal length shards of the
    cache (k, v), as the ranks of a length-sharded cache run it: each
    shard's (o, M, l) held against the plain version's on it, a shard with
    no live key in any row held to o = 0, M = -1e30, l = 0 exactly.
    Returns the shards merged in shard order (``merge_partials``, as
    ``spmd.merge_over`` merges the partials it gathered), the empty
    shards and the worst statistics' errors."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    Lr = k.shape[2] // n
    parts, empty, stat_worst = [], [], {"stat_m_err": 0.0, "stat_l_rel": 0.0}
    for r in range(n):
        ks, vs = (t[:, :, r * Lr:(r + 1) * Lr].contiguous() for t in (k, v))
        vr = (vl - r * Lr).clamp(0, Lr).to(torch.int32)
        part = fd.flash_decode(q, ks, vs, vr, body=body, partial=True)
        sp = fd.kernel_splits(q, ks)
        st = fd.partial_agreement(part, fd.flash_decode_plain(q, ks, vs, vr, splits=sp,
                                                              partial=True),
                                  fd.flash_decode_plain(q, ks, vs.abs(), vr, splits=sp,
                                                        partial=True)[0])
        for key in stat_worst:
            stat_worst[key] = max(stat_worst[key], st[key])
        if not fd.bf16_agrees(st):
            faults.append(f"{what} partial, shard {r} of {n}: {st}")
        if int(vr.max()) == 0:
            empty.append(r)
            o, M, l = part
            if not (torch.equal(o, torch.zeros_like(o)) and bool((M == -1e30).all())
                    and bool((l == 0).all())):
                faults.append(f"{what}: empty shard {r} of {n} reads |o| "
                              f"{float(o.abs().max())}, M {M.flatten()[:2].tolist()}, "
                              f"l {float(l.abs().max())}")
        parts.append(part)
        del ks, vs
    merged = fd.merge_partials(*(torch.stack(t) for t in zip(*parts)))
    return merged, empty, stat_worst


def _decode_shards(faults: list) -> dict:
    """flash_decode on one sequence at long context: q (1, 32, 128) against
    a (1, 8, LONG_LEN, 128) bf16 cache (jamba's attention), LONG_VALID live
    keys.  The kernel over the whole cache, and its partial mode over
    LONG_SHARDS equal length shards, each shard's (o, M, l) held against
    the plain version's on it, the shards merged (merge_partials, as the
    ranks of a length-sharded cache merge them) and held against the plain
    version over the whole cache under the bf16 bounds; the shards past
    LONG_VALID read o = 0, M = -1e30, l = 0 and no NaN, on the wgmma body
    and (at the most shards) on the simt body.  Times on the card's own
    time and host-inclusive, L2 flushed: the whole call, one full shard's
    partial call, the plain version (one reading) and SDPA over the masked
    cache, beside the bytes bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.evals.scorer import time_cuda_ms
    from repro_torch.kernels import flash_decode as fd

    B, Hq, Hkv, D, L = 1, 32, 8, 128, LONG_LEN
    g = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, L, D), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    vl = torch.tensor([LONG_VALID], dtype=torch.int32, device="cuda")
    splits = fd.kernel_splits(q, k)
    plain = fd.flash_decode_plain(q, k, v, vl, splits=splits)
    mag = fd.flash_decode_plain(q, k, v.abs(), vl, splits=splits)
    before = dict(fd.flash_decode.launches_by_body)
    out = fd.flash_decode(q, k, v, vl)
    whole = fd.bf16_agreement(out, plain, mag)
    emit({"phase": "decode_kernel", "check": "long_context_whole", "body": "wgmma",
          "shape": f"q ({B}, {Hq}, {D}), cache ({B}, {Hkv}, {L}, {D}) bf16, "
                   f"valid_len {LONG_VALID}", "splits": splits, **whole})
    if not fd.bf16_agrees(whole):
        faults.append(f"long context, whole cache: {whole}")
    worst, merged_stats, empties, calls = whole["max_abs_err"], {}, {}, {"wgmma": 1, "simt": 0}
    for n, body in [(n, "wgmma") for n in LONG_SHARDS] + [(LONG_SHARDS[-1], "simt")]:
        Lr = L // n
        merged, empty, stat_worst = _partial_shards(q, k, v, vl, n, faults,
                                                    f"long context, {body}", body)
        calls[body] += n
        st = fd.bf16_agreement(merged.to(torch.bfloat16), plain, mag)
        emit({"phase": "decode_kernel", "check": "long_context_shards_merged", "body": body,
              "shards": n, "keys_a_shard": Lr, "empty_shards": empty,
              "shard_stats_worst": stat_worst, "stat_rel_bound": fd.STAT_REL, **st})
        if not fd.bf16_agrees(st):
            faults.append(f"long context, {n} {body} shards merged: {st}")
        worst = max(worst, st["max_abs_err"])
        merged_stats[f"{n}_{body}"] = st["rel_rms"]
        empties[f"{n}_{body}"] = empty
    took = {b: fd.flash_decode.launches_by_body[b] - before[b] for b in fd.BODIES}
    if took != calls:
        faults.append(f"long context: launches by body {took}, the calls were {calls}")

    # times: the whole call and one full shard (of the most shards) in partial mode
    Lr = L // LONG_SHARDS[-1]
    ks, vs = (t[:, :, :Lr].contiguous() for t in (k, v))
    vr = torch.tensor([Lr], dtype=torch.int32, device="cuda")
    mask = (torch.arange(L, device="cuda") < LONG_VALID)[None, None, None, :]
    b_ms, b_by = decode_bound(B, Hq, Hkv, D, [LONG_VALID])
    row = {"shape": f"q ({B}, {Hq}, {D}), cache ({B}, {Hkv}, {L}, {D}) bf16, valid_len "
                    f"{LONG_VALID}", "splits": splits,
           "ms": time_cold_ms(lambda: fd.flash_decode(q, k, v, vl)),
           "device_ms": time_cold_ms(lambda: fd.flash_decode(q, k, v, vl), cushion=True),
           "shard_keys": Lr, "shard_splits": fd.kernel_splits(q, ks),
           "shard_ms": time_cold_ms(lambda: fd.flash_decode(q, ks, vs, vr, partial=True)),
           "shard_device_ms": time_cold_ms(lambda: fd.flash_decode(q, ks, vs, vr, partial=True),
                                           cushion=True),
           "plain_ms": time_cuda_ms(lambda: fd.flash_decode_plain(q, k, v, vl, splits=splits),
                                    warmup=1, reps=1),
           "bound_ms": b_ms, "bound_by": b_by,
           "shard_bound_ms": decode_bound(B, Hq, Hkv, D, [Lr])[0], "library_ms": None,
           "library": "sdpa over the masked cache, L2 flushed",
           "max_abs_err": worst, "merged_rel_rms": merged_stats, "empty_shards": empties}
    try:
        sdpa = lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,  # noqa: E731
                                                      enable_gqa=True)
        row.update(library_ms=time_cold_ms(sdpa), library_device_ms=time_cold_ms(
            sdpa, cushion=True))
    except (RuntimeError, TypeError) as e:            # recorded, not hidden
        row["library_error"] = str(e)[:160]
    emit({"phase": "decode_kernel", "check": "long_context_times", "gate": False,
          "nvidia_smi": nvidia_smi(), **row})
    del q, k, v, ks, vs, plain, mag
    torch.cuda.empty_cache()
    return row


def _decode_rank_shape(faults: list) -> dict:
    """flash_decode at the shape each model rank of qwen2-7b's decode_32k
    runs on (data=16, model=16): q (RANK_ROWS, 28, 128) against a
    (RANK_ROWS, 4, RANK_LEN, 128) bf16 cache, every key live (the cell
    decodes at position RANK_LEN - 1), rep 7.  The whole launch (each rank
    before the cache length split over "model"), then the partial mode
    over RANK_SHARDS length shards (each rank's since), each shard's (o,
    M, l) against the plain version's, the shards merged as
    ``spmd.merge_over`` merges the partials it gathered over "model"
    (``merge_partials`` in rank order) and held against the plain version
    over the whole cache under the bf16 bounds; then the same with
    valid_len RANK_LEN - RANK_LEN / RANK_SHARDS, where the last shard is
    empty (o = 0, M = -1e30, l = 0).  Times on the card's own time and
    host-inclusive, L2 flushed: the whole launch and one shard's partial
    launch, each beside its bound, the plain version's whole walk (one
    reading) and SDPA over the whole cache (enable_gqa, no mask)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.evals.scorer import time_cuda_ms
    from repro_torch.kernels import flash_decode as fd

    B, Hq, Hkv, D, L, n = RANK_ROWS, 28, 4, 128, RANK_LEN, RANK_SHARDS
    Lr = L // n
    g = torch.Generator(device="cuda").manual_seed(14)
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, L, D), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    shape = f"q ({B}, {Hq}, {D}), cache ({B}, {Hkv}, {L}, {D}) bf16, rep {Hq // Hkv}"
    before = dict(fd.flash_decode.launches_by_body)
    calls, worst, out_row = 0, 0.0, {}
    for valid in (L, L - Lr):
        vl = torch.full((B,), valid, dtype=torch.int32, device="cuda")
        splits = fd.kernel_splits(q, k)
        plain = fd.flash_decode_plain(q, k, v, vl, splits=splits)
        mag = fd.flash_decode_plain(q, k, v.abs(), vl, splits=splits)
        whole = fd.bf16_agreement(fd.flash_decode(q, k, v, vl), plain, mag)
        calls += 1
        if not fd.bf16_agrees(whole):
            faults.append(f"rank shape, valid_len {valid}, whole launch: {whole}")
        merged, empty, stat_worst = _partial_shards(q, k, v, vl, n, faults,
                                                    f"rank shape, valid_len {valid}")
        calls += n
        st = fd.bf16_agreement(merged.to(torch.bfloat16), plain, mag)
        emit({"phase": "decode_kernel", "check": "rank_shape", "shape": shape,
              "valid_len": valid, "splits": splits, "whole": whole, "shards": n,
              "keys_a_shard": Lr, "empty_shards": empty, "shard_stats_worst": stat_worst,
              "stat_rel_bound": fd.STAT_REL, "merged": st})
        if not fd.bf16_agrees(st):
            faults.append(f"rank shape, valid_len {valid}, {n} shards merged: {st}")
        if (valid < L) != (empty == [n - 1]):
            faults.append(f"rank shape, valid_len {valid}: empty shards {empty}")
        worst = max(worst, whole["max_abs_err"], st["max_abs_err"])
        out_row[f"merged_rel_rms_valid_{valid}"] = st["rel_rms"]
        del plain, mag
    took = {b: fd.flash_decode.launches_by_body[b] - before[b] for b in fd.BODIES}
    if took != {"wgmma": calls, "simt": 0}:
        faults.append(f"rank shape: launches by body {took}, {calls} calls on wgmma")

    vl = torch.full((B,), L, dtype=torch.int32, device="cuda")
    ks, vs = (t[:, :, :Lr].contiguous() for t in (k, v))
    vr = torch.full((B,), Lr, dtype=torch.int32, device="cuda")
    b_ms, b_by = decode_bound(B, Hq, Hkv, D, [L] * B)
    s_ms, s_by = decode_bound(B, Hq, Hkv, D, [Lr] * B)
    row = {"shape": shape, "splits": fd.kernel_splits(q, k),
           "ms": time_cold_ms(lambda: fd.flash_decode(q, k, v, vl)),
           "device_ms": time_cold_ms(lambda: fd.flash_decode(q, k, v, vl), cushion=True),
           "shard_keys": Lr, "shard_splits": fd.kernel_splits(q, ks),
           "shard_ms": time_cold_ms(lambda: fd.flash_decode(q, ks, vs, vr, partial=True)),
           "shard_device_ms": time_cold_ms(lambda: fd.flash_decode(q, ks, vs, vr, partial=True),
                                           cushion=True),
           "plain_ms": time_cuda_ms(lambda: fd.flash_decode_plain(q, k, v, vl), warmup=1,
                                    reps=1),
           "bound_ms": b_ms, "bound_by": b_by, "shard_bound_ms": s_ms, "shard_bound_by": s_by,
           "library_ms": None, "library": "sdpa over the whole cache, enable_gqa, L2 flushed",
           "max_abs_err": worst, **out_row}
    try:
        sdpa = lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,  # noqa: E731
                                                      enable_gqa=True)
        row.update(library_ms=time_cold_ms(sdpa), library_device_ms=time_cold_ms(
            sdpa, cushion=True))
    except (RuntimeError, TypeError) as e:            # recorded, not hidden
        row["library_error"] = str(e)[:160]
    emit({"phase": "decode_kernel", "check": "rank_shape_times", "gate": False,
          "nvidia_smi": nvidia_smi(), **row})
    del q, k, v, ks, vs
    torch.cuda.empty_cache()
    return row


def phase_long_decode(state):
    """SERVE_ARCH at full width (serve's depth: 2 attention layers) decoding
    one sequence against a LONG_LEN-key cache: init_decode_cache filled
    with seeded bf16 K/V in the slots before LONG_VALID - 1 and seeded fp32
    Mamba states, then LONG_STEPS greedy steps through decode_step, timed
    with the launch counts set to 0 just before and read just after (2
    flash_decode launches a step, all on the wgmma body, nothing else).
    Then the same steps from the same cache in turns, as a CUDA graph
    (``launch.serve.GraphedStep``: the first graphed run's first step warms
    it up and the capture follows; the second replays every step), graphed
    again and eagerly again, each run's launches as the path implies and
    its tokens equal; both medians, the capture and each mode's busy share
    (the profiler's kernel time a step over the step).  Last, the steps
    again with every flash_decode launch held against its plain version
    (eagerly; tokens equal).  Takes serve's weights when serve ran before
    it."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as sm
    from repro_torch.launch.serve import GraphedStep, make_serve_step
    from repro_torch.models import decode_step, init_decode_cache, init_params

    cfg = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=SERVE_LAYERS)
    params = state.pop("serve_params", None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if params is None:
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda", dtype=torch.bfloat16)
    weights_gib = sum(t.numel() * t.element_size() for t in _leaves(params)) / 2 ** 30
    cache = init_decode_cache(cfg, 1, LONG_LEN, cache_dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    mamba0 = {}
    for pos, entry in cache["layers"].items():
        if "k" in entry:
            for name in ("k", "v"):
                entry[name][:, :, :, :LONG_VALID - 1].normal_(generator=g)
        if "mamba" in entry:
            entry["mamba"]["ssm"].normal_(0.0, 0.1, generator=g)
            entry["mamba"]["conv"].normal_(generator=g)
            mamba0[pos] = {n: t.clone() for n, t in entry["mamba"].items()}
    cache["pos"].fill_(LONG_VALID - 1)
    cache_gib = sum(t.numel() * t.element_size() for t in _leaves(cache["layers"])) / 2 ** 30
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    first = int(np.random.default_rng(13).integers(0, cfg.vocab_size))
    kernels = {"flash_attention": fa.flash_attention, "flash_decode": fd.flash_decode,
               "ssd_chunked": sm.ssd_chunked}
    graphed = {}                                     # the captured step, once captured

    def steps(timed: bool, graph: bool = False):
        """LONG_STEPS steps from the seeded cache: tokens, each step's ms
        (CUDA events), whether every logits row was finite and (1, vocab)."""
        for pos, saved in mamba0.items():            # the same start every time
            for n, t in saved.items():
                cache["layers"][pos]["mamba"][n].copy_(t)
        cache["pos"].fill_(LONG_VALID - 1)
        c, tok, toks, marks, finite = cache, torch.tensor([first], device="cuda"), [], [], []
        gs = graphed.get("step")
        if graph and gs is not None:
            gs.token.copy_(tok)
        with torch.no_grad():
            for _ in range(LONG_STEPS):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                if not graph:
                    logits, c = decode_step(params, cfg, c, tok)
                    tok = torch.argmax(logits, -1)
                else:
                    if gs is None:                   # the warm-up is the first step
                        gs = GraphedStep(make_serve_step(cfg), params, cache, tok)
                        gs.warm()
                    else:
                        gs.replay()
                    logits, tok = gs.logits, gs.token.clone()
                b.record()
                marks.append((a, b))
                finite.append(torch.isfinite(logits).all() if logits.shape == (
                    1, cfg.vocab_size) else torch.tensor(False))
                toks.append(tok)
                if graph and "step" not in graphed:  # after the warm-up's span
                    gs.capture()
                    graphed["step"] = gs
        torch.cuda.synchronize()
        return ([int(t) for t in toks], [a.elapsed_time(b) for a, b in marks] if timed else [],
                all(bool(f) for f in finite))

    faults: list = []
    n_attn = sum(b.kind == "attn" for b in cfg.pattern) * cfg.n_periods
    expected = {"flash_attention": 0, "flash_decode": n_attn * LONG_STEPS, "ssd_chunked": 0}
    turns = []
    for graph in (False, True, True, False):
        torch.cuda.synchronize()
        reset_counts(*kernels.values())
        tokens_, ms_, finite_ = steps(timed=True, graph=graph)
        turns.append({"graphed": graph, "tokens": tokens_, "ms": ms_, "finite": finite_,
                      "launches": {name: fn.launches for name, fn in kernels.items()},
                      "by_body": dict(fd.flash_decode.launches_by_body)})
    tokens, ms, finite = turns[0]["tokens"], turns[0]["ms"], turns[0]["finite"]
    launches, by_body = turns[0]["launches"], turns[0]["by_body"]
    busy = {}
    for graph in (False, True):                      # the kernels' time a step, profiled
        busy["graphed" if graph else "eager"] = _steps_busy_share(
            lambda graph=graph: steps(timed=False, graph=graph), LONG_STEPS,
            sorted(x for t in turns if t["graphed"] == graph for x in t["ms"]))
    checks: dict = {}
    with ops.checking(lambda name, st: checks.setdefault(name, []).append(st)):
        tokens_checked, _, finite_checked = steps(timed=False)
    err = _checked(checks, faults, phase="long_decode")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(ms)[len(ms) // 2]
    by_mode = {g: sorted(x for t in turns if t["graphed"] == g for x in t["ms"])
               for g in (False, True)}
    med_mode = {g: v[len(v) // 2] for g, v in by_mode.items()}
    gs = graphed.get("step")
    emit({"phase": "long_decode", "check": "eager_vs_graphed",
          "order": ["graphed" if t["graphed"] else "eager" for t in turns],
          "ms_per_step_median_eager": med_mode[False],
          "ms_per_step_median_graphed": med_mode[True],
          "graphed_over_eager": med_mode[True] / med_mode[False],
          "ms_by_run": [t["ms"] for t in turns], "decode_step_busy_share": busy,
          "captures": int(gs is not None), "capture_ms": gs.capture_ms if gs else None,
          "tokens_equal": all(t["tokens"] == tokens for t in turns),
          "launches_by_run": [t["launches"] for t in turns], "launches_expected": expected})
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "of_layers": get_arch(SERVE_ARCH).n_layers,
           "batch": 1, "max_len": LONG_LEN, "valid_len_first_step": LONG_VALID,
           "steps": LONG_STEPS, "launches": launches, "launches_expected": expected,
           "flash_decode_launches_by_body": by_body,
           "launches_checked": len(checks.get("flash_decode", [])),
           "ms_per_step": ms, "ms_per_step_median": med, "tokens_per_s": 1e3 / med,
           "ms_per_step_median_graphed": med_mode[True],
           "weights_gib": weights_gib, "cache_gib": cache_gib, "peak_gib": peak_gib,
           "setup_s": setup_s, "tokens": tokens, "tokens_checked_equal": tokens == tokens_checked,
           "max_abs_err": err.get("flash_decode"), "nvidia_smi": nvidia_smi()}
    emit({"phase": "long_decode", "summary": True, **out})
    for t in turns:
        mode = "graphed" if t["graphed"] else "eager"
        if t["launches"] != expected:
            faults.append(f"{mode} run: launches {t['launches']}, the path implies {expected}")
        if t["by_body"]["wgmma"] != t["launches"]["flash_decode"]:
            faults.append(f"{mode} run: flash_decode launches by body {t['by_body']}: all "
                          f"must take wgmma")
        if not t["finite"]:
            faults.append(f"{mode} run: logits not finite or not (1, vocab)")
        if t["tokens"] != tokens:
            faults.append(f"{mode} run: tokens {t['tokens']}, the first eager run's {tokens}")
    if not finite_checked:
        faults.append("checked run: logits not finite or not (1, vocab)")
    if tokens != tokens_checked:
        faults.append(f"tokens {tokens}, again with the checks {tokens_checked}")
    if not med_mode[True] < med_mode[False]:
        faults.append(f"the graphed step's median {med_mode[True]} ms is not below the "
                      f"eager one's {med_mode[False]} ms")
    state["long_decode"] = out
    del params, cache, graphed, gs
    torch.cuda.empty_cache()
    if faults:
        raise AssertionError("long_decode: " + "; ".join(faults))


def _steps_busy_share(run, n_steps: int, step_ms: list) -> dict:
    """torch.profiler over ``run()`` (``n_steps`` decode steps): the kernels'
    device time a step and its share of the median step (``step_ms``, from
    CUDA events).  A profiler that sees a graph's launch and not its kernels
    reads no kernel time: "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    med = step_ms[len(step_ms) // 2]
    if not device_ms:
        return {"device_ms_per_step": "not measured", "busy_share": "not measured"}
    return {"device_ms_per_step": device_ms / n_steps, "step_ms_median": med,
            "busy_share": device_ms / n_steps / med}


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


def _profile_group(server, group, phase="serve") -> dict:
    """torch.profiler over two more passes of a group: the prefill alone (one
    new token) and the prefill with PROFILE_NEW - 1 decode steps.  Device
    time of the kernels (CUDA rows only), the ported kernels' share, the
    device's busy share of the pass's wall time, and by difference the
    device time of one decode step and its share of the step.  On a graphed
    server the replays' spans on the card (CUDA events) stand beside it, in
    case the profiler sees the graph's launch and not its kernels.  A
    reading, not a check; returns the second pass's line."""
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
                                   ("flash_decode", ("decode_wgmma", "decode_split",
                                                     "decode_combine")),
                                   ("ssd_chunked", ("ssd_kernel", "ssd_chunk_state",
                                                    "ssd_state_pass", "ssd_chunk_scan")))}
        t = server.timings[-1]
        line = {"phase": phase, "check": "profile", "gate": False, "new_tokens": new,
                "graphed": server.graph, "replay_ms": t.get("replay_ms"),
                "prompt_len": t["prompt_len"], "wall_ms": wall_ms,
                "device_ms": device_ms[new] or "not measured",
                "device_busy_share": (device_ms[new] / wall_ms if device_ms[new]
                                      else "not measured"),
                "ported_kernels_ms": ours, "prefill_ms": t["prefill_ms"],
                "decode_ms": t["decode_ms"],
                "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:12]]}
        if new > 1 and device_ms[1] and t["decode_ms"]:
            step = (device_ms[new] - device_ms[1]) / (new - 1)
            line["decode_step_device_ms"] = step if step > 0 else "not measured"
            line["decode_step_busy_share"] = (
                step / (sum(t["decode_ms"]) / len(t["decode_ms"])) if step > 0
                else "not measured")
        emit(line)
    return line


def _serve_traffic(cfg, params, checked, faults: list, **tags) -> dict:
    """SERVE_REQUESTS requests (prompts drawn in SERVE_PROMPT, SERVE_NEW
    greedy tokens each) through BatchedServer in bf16, batch SERVE_BATCH,
    max_len SERVE_MAX_LEN.  The three kernels' counts are set to 0 just
    before; the first group runs eagerly, every launch held against its
    plain version (``checked``: the kernels that must have checked
    launches), the others through the card's default server, whose decode
    step is a CUDA graph.  One line per group, tagged with ``tags``; a
    fault for a wrong number of decode steps or a bad output.  Returns the
    graphed server, requests, groups, timings, launch counts, decode steps,
    checks and wall seconds."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as sm
    from repro_torch.launch.serve import BatchedServer, Request

    rng = np.random.default_rng(0)
    lens = rng.integers(*SERVE_PROMPT, size=SERVE_REQUESTS)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (int(n),)), SERVE_NEW)
            for i, n in enumerate(lens)]
    groups = [reqs[i:i + SERVE_BATCH] for i in range(0, len(reqs), SERVE_BATCH)]
    kw = dict(batch_size=SERVE_BATCH, max_len=SERVE_MAX_LEN, compute_dtype=torch.bfloat16)
    eager, server = BatchedServer(cfg, params, graph=False, **kw), BatchedServer(cfg, params, **kw)
    kernels = {"flash_attention": fa.flash_attention, "flash_decode": fd.flash_decode,
               "ssd_chunked": sm.ssd_chunked}
    checks = {name: [] for name in checked}
    torch.cuda.synchronize()
    reset_counts(*kernels.values())
    t0 = time.perf_counter()
    with ops.checking(lambda name, st: checks.setdefault(name, []).append(st)):
        eager.run_group(groups[0])               # every launch held against plain
    for grp in groups[1:]:
        server.run_group(grp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    decode_by_body = dict(fd.flash_decode.launches_by_body)
    timings = eager.timings + server.timings
    steps = sum(len(t["decode_ms"]) for t in timings)
    for i, t in enumerate(timings):
        dec = sorted(t["decode_ms"])
        med = dec[len(dec) // 2]
        emit({**tags, "group": i, "checked_against_plain": i == 0, "graphed": i > 0,
              "batch": t["batch"], "prompt_len": t["prompt_len"],
              "prompt_lens": [len(r.prompt) for r in groups[i]],
              "prefill_ms": t["prefill_ms"], "decode_steps": len(dec),
              "decode_ms_median": med, "decode_ms_mean": sum(dec) / len(dec),
              "decode_tokens_per_s": t["batch"] / (med * 1e-3)})
    emit({**tags, "check": "graph_captures", "captures": len(server.graph_log["capture_ms"]),
          "capture_ms": server.graph_log["capture_ms"], "copy_ms": server.graph_log["copy_ms"]})
    if steps != len(groups) * (SERVE_NEW - 1):
        faults.append(f"{steps} decode steps, expected {len(groups) * (SERVE_NEW - 1)}")
    for r in reqs:
        if len(r.output) != SERVE_NEW or not all(0 <= t < cfg.vocab_size for t in r.output):
            faults.append(f"request {r.rid} output {r.output}")
    return dict(server=server, reqs=reqs, groups=groups, timings=timings, launches=launches,
                steps=steps, checks=checks, wall=wall, decode_by_body=decode_by_body)


def _eager_vs_graphed(cfg, params, group, expected: dict, faults: list, **tags) -> dict:
    """``group`` through BatchedServer eagerly and with its decode step a
    CUDA graph, in turns (eager, graphed, graphed, eager), each run from its
    own prefill of the same prompts, the three kernels' counts set to 0 just
    before each run and read just after: the same tokens in every run and,
    in every run, the launches the path implies (``expected``).  The graphed
    server is fresh: its first run captures, its second copies its prefill
    cache into the captured one.  Prints both step medians, the captures
    and each server's profile (``_profile_group``): the step's busy share,
    and on the graph each replay's span on the card (CUDA events)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd as sm
    from repro_torch.launch.serve import BatchedServer, Request

    kw = dict(batch_size=SERVE_BATCH, max_len=SERVE_MAX_LEN, compute_dtype=torch.bfloat16)
    servers = {False: BatchedServer(cfg, params, graph=False, **kw),
               True: BatchedServer(cfg, params, graph=True, **kw)}
    kernels = {"flash_attention": fa.flash_attention, "flash_decode": fd.flash_decode,
               "ssd_chunked": sm.ssd_chunked}
    runs = []
    for graph in (False, True, True, False):
        reqs = [Request(r.rid, r.prompt, r.max_new_tokens) for r in group]
        torch.cuda.synchronize()
        reset_counts(*kernels.values())
        servers[graph].run_group(reqs)
        torch.cuda.synchronize()
        t = servers[graph].timings[-1]
        runs.append({"graphed": graph, "tokens": [r.output for r in reqs],
                     "launches": {name: fn.launches for name, fn in kernels.items()},
                     "decode_ms": t["decode_ms"], "replay_ms": t.get("replay_ms")})
    ms = {g: sorted(x for r in runs if r["graphed"] == g for x in r["decode_ms"])
          for g in (False, True)}
    med = {g: v[len(v) // 2] for g, v in ms.items()}
    # the graphed runs' replayed steps: all but the first run's first (the warm-up)
    spans = [(rep, dec) for r in runs if r["graphed"]
             for rep, dec in zip(r["replay_ms"], r["decode_ms"][len(r["decode_ms"])
                                                                - len(r["replay_ms"]):])]
    log = {k: list(v) for k, v in servers[True].graph_log.items()}    # the turns'
    profiles = {g: _profile_group(servers[g], group, tags["phase"]) for g in (False, True)}
    line = {**tags, "check": "eager_vs_graphed", "prompt_len": max(len(r.prompt) for r in group),
            "order": ["graphed" if r["graphed"] else "eager" for r in runs],
            "decode_ms_median_eager": med[False], "decode_ms_median_graphed": med[True],
            "graphed_over_eager": med[True] / med[False],
            "decode_ms_by_run": [r["decode_ms"] for r in runs],
            "replay_ms_median": sorted(a for a, _ in spans)[len(spans) // 2],
            "replay_busy_share": sum(a for a, _ in spans) / sum(b for _, b in spans),
            "decode_step_busy_share": {("graphed" if g else "eager"):
                                       p.get("decode_step_busy_share", "not measured")
                                       for g, p in profiles.items()},
            "captures": len(log["capture_ms"]), "capture_ms": log["capture_ms"],
            "copy_ms": log["copy_ms"], "tokens_equal": all(r["tokens"] == runs[0]["tokens"]
                                                           for r in runs),
            "launches_by_run": [r["launches"] for r in runs], "launches_expected": expected,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(line)
    if not line["tokens_equal"]:
        faults.append(f"eager and graphed tokens differ: {[r['tokens'] for r in runs]}")
    for r in runs:
        if r["launches"] != expected:
            faults.append(f"{'graphed' if r['graphed'] else 'eager'} run: launches "
                          f"{r['launches']}, the path implies {expected}")
    if line["captures"] != 1 or len(log["copy_ms"]) != 1:
        faults.append(f"graphed server: {line['captures']} captures and "
                      f"{len(log['copy_ms'])} copies, want one of each")
    if not med[True] < med[False]:
        faults.append(f"the graphed step's median {med[True]} ms is not below the eager "
                      f"one's {med[False]} ms")
    return line


def _bf16_ulp(x: float) -> float:
    import math
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _decode_bodies_agree(cfg, params, run, faults: list, **tags) -> dict:
    """The served requests again, twice, through a fresh eager BatchedServer:
    with flash_decode as routed (the wgmma body) and with every call routed
    to the simt body from this script's side (a graph would fix the routing
    at its capture).  The routed run must give the served run's tokens (the
    kernel is deterministic; the served run's groups after the first ran
    as a CUDA graph).  Where a request's
    tokens differ between the two runs, the first point where the two runs
    part must be a rounding tie: the first decode step at which one of its
    MoE layers chose other experts (the k-th and the next expert's router
    probabilities within DECODE_TIE_ULPS of each other in both runs), or, with
    no such step before it, the first differing token (the two tokens each
    run's top DECODE_TIE_TOP, within DECODE_TIE_ULPS of each run's best)."""
    import torch

    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import moe

    own_top_k, steps_a_group = moe.top_k, SERVE_NEW - 1
    outs, tops, routes = {}, {}, {}
    for body in ("wgmma", "simt"):            # eager: the routing and the reads are the host's
        server = BatchedServer(cfg, params, batch_size=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                               compute_dtype=torch.bfloat16, graph=False)
        inner, top, route, at = server._serve, [], [], {"step": None}

        def serve(params_, cache, token, inner=inner, top=top, at=at):
            at["step"] = len(top)
            logits, cache = inner(params_, cache, token)
            at["step"] = None
            best = logits.float().topk(DECODE_TIE_TOP, dim=-1)
            top.append((best.values.cpu(), best.indices.cpu()))
            return logits, cache

        def top_k(probs, k, route=route, at=at):
            vals, idx = own_top_k(probs, k)
            if at["step"] is not None:             # a decode step's MoE layer
                route.append((at["step"], idx.cpu(), probs.float().topk(k + 1).values.cpu()))
            return vals, idx
        server._serve = serve
        reqs = [Request(r.rid, r.prompt, r.max_new_tokens) for r in run["reqs"]]
        moe.top_k = top_k
        try:
            with decode_routed_to_simt() if body == "simt" else contextlib.nullcontext():
                server.run(reqs)
        finally:
            moe.top_k = own_top_k
        outs[body], tops[body], routes[body] = [r.output for r in reqs], top, route
    served = [r.output for r in run["reqs"]]
    parted = []
    for i, (a, b) in enumerate(zip(outs["wgmma"], outs["simt"])):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        grp, row = divmod(i, SERVE_BATCH)
        first = grp * steps_a_group                # the group's first decode step
        where = {"request": i, "token_position": j, "tokens": [a[j], b[j]]}
        moved = next(((st, n) for n, ((st, ia, _), (_, ib, _)) in enumerate(
            zip(routes["wgmma"], routes["simt"]))
            if first <= st < first + j and sorted(ia[row].tolist())
            != sorted(ib[row].tolist())), None) if j > 0 else None
        if moved is not None:                      # an MoE layer chose other experts
            st, n = moved
            layer = n - next(m for m, r in enumerate(routes["wgmma"]) if r[0] == st)
            where.update(parted_at=f"decode step {st - first}, MoE layer {layer}")
            ok = True
            for body in ("wgmma", "simt"):
                ranked = routes[body][n][2][row].tolist()      # top k + 1 probabilities
                kth, nxt = ranked[-2], ranked[-1]
                where[body] = {"router_top": ranked, "experts": routes[body][n][1][row].tolist(),
                               "gap_bf16_ulps": (kth - nxt) / _bf16_ulp(kth)}
                ok &= kth - nxt <= DECODE_TIE_ULPS * _bf16_ulp(kth)
        elif j > 0:                                # the token itself was a tie
            where.update(parted_at=f"token {j}")
            ok = True
            for body, other in (("wgmma", b[j]), ("simt", a[j])):
                vals, idx = tops[body][first + j - 1]          # token j: decode step j - 1
                best, toks = vals[row].tolist(), idx[row].tolist()
                gap = best[0] - best[toks.index(other)] if other in toks else float("inf")
                where[body] = {"top": best, "top_tokens": toks,
                               "other_run_token_gap_bf16_ulps": gap / _bf16_ulp(best[0])}
                ok &= gap <= DECODE_TIE_ULPS * _bf16_ulp(best[0])
        else:
            where.update(parted_at="the prefill's token")
            ok = False
        where["rounding_tie"] = ok
        parted.append(where)
    line = {**tags, "check": "decode_bodies_agree", "requests": len(served),
            "routed_equals_served": outs["wgmma"] == served,
            "simt_equals_wgmma": outs["wgmma"] == outs["simt"],
            "requests_parted": len(parted), "first_parting": parted}
    emit(line)
    if outs["wgmma"] != served:
        faults.append("the routed rerun's tokens differ from the served run's")
    if not all(p["rounding_tie"] for p in parted):
        faults.append(f"wgmma and simt runs part other than at a rounding tie: {parted}")
    return line


def phase_serve(state):
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sm
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

    faults: list = []
    run = _serve_traffic(cfg, params, ("flash_attention", "flash_decode", "ssd_chunked"),
                         faults, phase="serve")
    reqs, groups = run["reqs"], run["groups"]
    launches, steps, wall = run["launches"], run["steps"], run["wall"]
    by_body = dict(fa.flash_attention.launches_by_body)
    ssd_by_body = dict(sm.ssd_chunked.launches_by_body)

    n_attn = sum(b.kind == "attn" for b in cfg.pattern) * cfg.n_periods
    n_mamba = sum(b.kind == "mamba" for b in cfg.pattern) * cfg.n_periods
    expected = {"flash_attention": n_attn * len(groups),
                "ssd_chunked": n_mamba * len(groups),
                "flash_decode": n_attn * steps}
    if launches != expected:
        faults.append(f"launches {launches}, the path implies {expected}")
    if by_body["wgmma"] != launches["flash_attention"]:
        faults.append(f"flash_attention launches by body {by_body}: the served bf16 "
                      f"prefill at head_dim 128 must take the wgmma body")
    if ssd_by_body["chunked"] != launches["ssd_chunked"]:
        faults.append(f"ssd_chunked launches by body {ssd_by_body}: the served bf16 "
                      f"prefill must take the chunked body")
    decode_by_body = run["decode_by_body"]
    if decode_by_body["wgmma"] != launches["flash_decode"]:
        faults.append(f"flash_decode launches by body {decode_by_body}: every served "
                      f"bf16 decode call must take the wgmma body")
    state["serve_err"] = _checked(run["checks"], faults, phase="serve", group=0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    total_new = sum(len(r.output) for r in reqs)
    emit({"phase": "serve", "summary": True, "requests": len(reqs),
          "new_tokens": total_new, "wall_s": wall, "weights_gib": weights_gib,
          "init_s": init_s, "peak_gib": peak_gib, "launches": launches,
          "launches_expected": expected, "flash_attention_launches_by_body": by_body,
          "ssd_chunked_launches_by_body": ssd_by_body,
          "flash_decode_launches_by_body": decode_by_body,
          "launches_per_prefill": {k: v // len(groups) for k, v in launches.items()
                                   if k != "flash_decode"},
          "flash_decode_per_step": launches["flash_decode"] / steps,
          "outputs_first_request": reqs[0].output})

    state["serve_graph"] = _eager_vs_graphed(
        cfg, params, groups[1], {"flash_attention": n_attn, "ssd_chunked": n_mamba,
                                 "flash_decode": n_attn * (SERVE_NEW - 1)},
        faults, phase="serve")
    _decode_bodies_agree(cfg, params, run, faults, phase="serve")
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
                      "decode_by_body": decode_by_body,
                      "prompt_lens": [t["prompt_len"] for t in run["timings"]],
                      "timings": run["timings"]}
    if "long_decode" in state.get("phases", ()):
        state["serve_params"] = params      # long_decode decodes on the same weights
    del params, run
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


def _checked(checks: dict, faults: list, **tags) -> dict:
    """One line per kernel of ``checks`` (its checked launches' stats by
    name) with the worst of each reading; a fault for a kernel with no
    checked launch or with one outside its bf16 bounds.  Returns the worst
    max_abs_err by kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd as sm
    agree = {"flash_attention": fa.bf16_agrees, "flash_decode": fd.bf16_agrees,
             "ssd_chunked": sm.bf16_agrees}
    worst_err = {}
    for name, rows in checks.items():
        bad = [st for st in rows if not agree[name](st)]
        worst = {k: max(st[k] for st in rows) for k in rows[0] if k != "finite"} if rows else {}
        emit({**tags, "check": "launches_vs_plain", "kernel": name,
              "launches_checked": len(rows), "failed": len(bad), "worst": worst})
        worst_err[name] = worst.get("max_abs_err")
        if bad or not rows:
            faults.append(f"{' '.join(map(str, tags.values()))}: {name}: {len(bad)} "
                          f"of {len(rows)} checked launches disagree")
    return worst_err


def _encdec_served(cfg, params, faults: list) -> dict:
    """(a) The served traffic through BatchedServer as the JAX package
    drives an encoder-decoder (zero frames of each group's prompt length):
    launch counts, the first group's launches held to their plain versions,
    timings, and the second group eagerly and graphed in turns."""
    from repro_torch.kernels import flash_attention as fa

    run = _serve_traffic(cfg, params, ("flash_attention", "flash_decode"), faults,
                         phase="serve_encdec", part="served")
    groups, launches, steps = run["groups"], run["launches"], run["steps"]
    by_body = dict(fa.flash_attention.launches_by_body)
    n_attn = sum(b.kind == "attn" for b in cfg.pattern) * cfg.n_periods
    n_cross = sum(b.cross_attn for b in cfg.pattern) * cfg.n_periods
    per_group = cfg.n_enc_layers + n_attn + n_cross      # encoder, self, cross
    expected = {"flash_attention": per_group * len(groups), "ssd_chunked": 0,
                "flash_decode": (n_attn + n_cross) * steps}
    if launches != expected:
        faults.append(f"served: launches {launches}, the path implies {expected}")
    if by_body["wgmma"] != launches["flash_attention"]:
        faults.append(f"served: flash_attention launches by body {by_body}: the bf16 "
                      "launches at head_dim 64 must take the wgmma body")
    decode_by_body = run["decode_by_body"]
    if decode_by_body["wgmma"] != launches["flash_decode"]:
        faults.append(f"served: flash_decode launches by body {decode_by_body}: every "
                      "bf16 decode call must take the wgmma body")
    err = _checked(run["checks"], faults, phase="serve_encdec", part="served")
    total_new = sum(len(r.output) for r in run["reqs"])
    emit({"phase": "serve_encdec", "part": "served", "summary": True,
          "requests": len(run["reqs"]), "new_tokens": total_new, "wall_s": run["wall"],
          "tokens_per_s": total_new / run["wall"], "launches": launches,
          "launches_expected": expected, "flash_attention_launches_by_body": by_body,
          "flash_decode_launches_by_body": decode_by_body,
          "flash_attention_per_group": launches["flash_attention"] / len(groups),
          "flash_decode_per_step": launches["flash_decode"] / steps,
          "outputs_first_request": run["reqs"][0].output})
    out = {"launches": launches, "by_body": by_body, "decode_by_body": decode_by_body,
           "err": err, "prompt_lens": [t["prompt_len"] for t in run["timings"]],
           "timings": run["timings"]}
    out["graph"] = _eager_vs_graphed(
        cfg, params, groups[1], {"flash_attention": cfg.n_enc_layers + n_attn + n_cross,
                                 "ssd_chunked": 0,
                                 "flash_decode": (n_attn + n_cross) * (SERVE_NEW - 1)},
        faults, phase="serve_encdec", part="served")
    _decode_bodies_agree(cfg, params, run, faults, phase="serve_encdec", part="served")
    return out


def _encdec_direct(cfg, params, faults: list) -> dict:
    """(b) prefill and ENCDEC_STEPS greedy decode steps straight through the
    model with seeded random frames (ENCDEC_FRAMES of them, not a multiple of
    128) and ENCDEC_PROMPT-token prompts, impl="kernel", every launch held to
    its plain version; then the plain path fed the same tokens (logits
    relative RMS and greedy agreement per step), and a witness: other frames
    move the logits."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, prefill

    B, Se, S = SERVE_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT
    max_len = S + ENCDEC_STEPS
    g = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")
    frames = torch.randn((B, Se, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    other = torch.randn((B, Se, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    kw = dict(compute_dtype=torch.bfloat16)

    def run(impl, frames, steps, feed=None):
        """Logits of the prefill and of ``steps`` decode steps, each fed
        ``feed``'s token or else its own greedy one; the tokens fed."""
        logits, cache = prefill(params, cfg, toks, max_len, enc_frames=frames,
                                cache_dtype=torch.bfloat16, impl=impl, **kw)
        out, fed = [logits], []
        for t in range(steps):
            fed.append(feed[t] if feed is not None else logits.argmax(-1))
            logits, cache = decode_step(params, cfg, cache, fed[-1], impl=impl, **kw)
            out.append(logits)
        return out, fed, cache

    checks = {"flash_attention": [], "flash_decode": []}
    shapes = []
    own_attention = ops.attention

    def attention(q, k, v, **a):                 # records the shapes it is given
        shapes.append((tuple(q.shape), tuple(k.shape), a.get("causal")))
        return own_attention(q, k, v, **a)
    before = (fa.flash_attention.launches, fd.flash_decode.launches)
    ops.attention = attention
    try:
        with ops.checking(lambda n, st: checks[n].append(st)):
            kernel, fed, cache = run("kernel", frames, ENCDEC_STEPS)
    finally:
        ops.attention = own_attention
    launched = (fa.flash_attention.launches - before[0], fd.flash_decode.launches - before[1])
    cross = cache["layers"]["pos0"]["cross"]["k"]
    n_attn = sum(b.kind == "attn" for b in cfg.pattern) * cfg.n_periods
    want = (cfg.n_enc_layers + 2 * n_attn, 2 * n_attn * ENCDEC_STEPS)
    cross_shapes = sorted({s for s in shapes if s[0][2] != s[1][2]})
    emit({"phase": "serve_encdec", "part": "direct", "batch": B, "enc_frames": Se,
          "prompt_len": S, "decode_steps": ENCDEC_STEPS,
          "attention_shapes": [{"q": list(q), "k": list(k), "causal": c}
                               for q, k, c in sorted(set(shapes))],
          "cross_cache": {"shape": list(cross.shape), "dtype": str(cross.dtype),
                          "enc_len": cache["enc_len"]},
          "launches": {"flash_attention": launched[0], "flash_decode": launched[1]},
          "launches_expected": {"flash_attention": want[0], "flash_decode": want[1]}})
    if launched != want:
        faults.append(f"direct: launches {launched}, the path implies {want}")
    if cross_shapes != [((B, cfg.n_heads, S, cfg.head_dim),
                         (B, cfg.n_kv_heads, Se, cfg.head_dim), False)]:
        faults.append(f"direct: cross-attention shapes {cross_shapes}")
    if cache["enc_len"] != Se or cross.dtype != torch.bfloat16:
        faults.append(f"direct: enc_len {cache['enc_len']}, cross cache {cross.dtype}")
    err = _checked(checks, faults, phase="serve_encdec", part="direct")

    plain, _, _ = run("plain", frames, ENCDEC_STEPS, feed=fed)
    steps = [{"logits_rel_rms": float((a - b).norm() / b.norm()),
              "greedy_agree": float((a.argmax(-1) == b.argmax(-1)).float().mean())}
             for a, b in zip(kernel, plain)]
    witness, _, _ = run("kernel", other, 0)
    moved = float((witness[0] - kernel[0]).norm() / kernel[0].norm())
    emit({"phase": "serve_encdec", "part": "direct", "check": "teacher_forced_kernel_vs_plain",
          "gate": False, "steps": steps})
    emit({"phase": "serve_encdec", "part": "direct", "check": "other_frames_move_the_logits",
          "prefill_logits_rel_change": moved,
          "kernel_vs_plain_prefill_rel_rms": steps[0]["logits_rel_rms"]})
    if not all(all(torch.isfinite(t).all() for t in run_) for run_ in (kernel, plain)):
        faults.append("direct: logits not finite")
    if not moved > steps[0]["logits_rel_rms"]:
        faults.append(f"direct: other frames moved the logits by {moved}, less than "
                      f"kernel and plain differ ({steps[0]['logits_rel_rms']})")
    return {"err": err, "steps": steps, "moved": moved}


def _encdec_card_vs_cpu(faults: list) -> dict:
    """(c) reduced seamless in fp32: BatchedServer's tokens on the card (the
    kernels, every launch checked) against the CPU's (the blocked
    references); then seeded random frames, a prefill and ENCDEC_CARD_CPU_STEPS
    greedy decode steps on the card, the CPU fed the card's tokens: logits
    within ENCDEC_CARD_CPU_REL relative and the same greedy tokens."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_map

    small = get_arch(ENCDEC_ARCH).reduced()
    outs, seen = _card_vs_cpu_tokens(small, True)
    emit({"phase": "serve_encdec", "part": "reduced_fp32_card_vs_cpu", "check": "tokens",
          "tokens_equal": outs["card"] == outs["cpu"], "card": outs["card"],
          "cpu": outs["cpu"], "launches_checked": {k: len(v) for k, v in seen.items()},
          "worst_rel_rms": {k: max(st["rel_rms"] for st in v) for k, v in seen.items()}})
    if outs["card"] != outs["cpu"]:
        faults.append("reduced: the card's tokens differ from the CPU reference's")
    if set(seen) != {"flash_attention", "flash_decode"} or not all(
            st["finite"] and st["rel_rms"] <= 1e-5 for v in seen.values() for st in v):
        faults.append(f"reduced: checked launches {seen}")

    cpu = init_params(small, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.cuda(), cpu)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, small.vocab_size, (2, 11)))
    frames = torch.from_numpy(rng.standard_normal((2, 45, small.d_model)).astype(np.float32))
    kw = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
    lc, cc = prefill(card, small, toks.cuda(), 32, enc_frames=frames.cuda(), **kw)
    lp, cp = prefill(cpu, small, toks, 32, enc_frames=frames, **kw)
    logits = {"card": [lc.cpu()], "cpu": [lp]}
    kw.pop("cache_dtype")
    for _ in range(ENCDEC_CARD_CPU_STEPS):
        tok = lc.argmax(-1)
        lc, cc = decode_step(card, small, cc, tok, **kw)
        lp, cp = decode_step(cpu, small, cp, tok.cpu(), **kw)
        logits["card"].append(lc.cpu())
        logits["cpu"].append(lp)
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(logits["card"], logits["cpu"])]
    same = [bool((a.argmax(-1) == b.argmax(-1)).all())
            for a, b in zip(logits["card"], logits["cpu"])]
    emit({"phase": "serve_encdec", "part": "reduced_fp32_card_vs_cpu",
          "check": "random_frames_logits", "enc_frames": 45, "prompt_len": 11,
          "decode_steps": ENCDEC_CARD_CPU_STEPS, "rel_by_step": rel,
          "greedy_equal_by_step": same, "tol": ENCDEC_CARD_CPU_REL})
    if not (max(rel) <= ENCDEC_CARD_CPU_REL and all(same)):
        faults.append(f"reduced: random-frame logits card vs CPU {rel}, greedy {same}")
    return {"tokens_equal": outs["card"] == outs["cpu"], "max_rel": max(rel)}


def phase_serve_encdec(state):
    """seamless-m4t-medium at full width and full depth (12 encoder and 12
    decoder layers, bf16, seeded random weights on the card): served as the
    JAX package serves it, driven directly with random frames, and reduced in
    fp32 against the CPU."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import init_params

    cfg = get_arch(ENCDEC_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weights_gib = sum(t.numel() * t.element_size() for t in _leaves(params)) / 2 ** 30
    emit({"phase": "serve_encdec", "arch": cfg.name, "n_enc_layers": cfg.n_enc_layers,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
          "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
          "params_b": cfg.param_count() / 1e9, "weights_gib": weights_gib,
          "init_s": time.perf_counter() - t0,
          "cut": "none: every width and both depths are the published ones"})
    faults: list = []
    parts = {}
    for name, part in (("served", _encdec_served), ("direct", _encdec_direct)):
        t1 = time.perf_counter()
        parts[name] = part(cfg, params, faults)
        parts[name + "_s"] = time.perf_counter() - t1
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del params
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    parts["reduced"] = _encdec_card_vs_cpu(faults)
    parts["reduced_s"] = time.perf_counter() - t1
    emit({"phase": "serve_encdec", "summary": True, "weights_gib": weights_gib,
          "peak_gib": peak_gib,
          "seconds": {k: v for k, v in parts.items() if k.endswith("_s")}})
    state["serve_encdec"] = {**parts["served"], "peak_gib": peak_gib,
                             "direct_err": parts["direct"]["err"]}
    if faults:
        raise AssertionError("serve_encdec: " + "; ".join(faults))


def _train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 per token for each parameter that
    enters a matrix product (all but an untied embedding table), plus causal
    attention forward and backward, 3 x (2 x tokens x S x Hq x Dh) per
    layer.  The recompute of remat is not counted."""
    n = cfg.param_count() - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    n_attn = sum(b.kind == "attn" for b in cfg.pattern) * cfg.n_periods
    return 6 * n * tokens + 6 * tokens * seq * cfg.n_heads * cfg.head_dim * n_attn


def _profile_train_step(run) -> None:
    """torch.profiler over one more full-width step (after the timed ones):
    device time by kernel class and the top kernels, and the device's busy
    share of the step's wall time.  A reading, not a check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    classes = (("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90")),
               ("softmax", ("softmax",)), ("reduce", ("reduce",)),
               ("index_scatter_gather", ("index", "scatter", "gather")),
               ("copy_cast", ("copy", "cast")),
               ("elementwise", ("elementwise", "vectorized")))
    by_class: dict = {}
    for key, ms, _ in rows:
        name = next((c for c, tags in classes if any(t in key.lower() for t in tags)), "other")
        by_class[name] = by_class.get(name, 0.0) + ms
    device_ms = sum(r[1] for r in rows)
    emit({"phase": "train", "check": "profile", "gate": False, "wall_ms": wall_ms,
          "device_ms": device_ms or "not measured",
          "device_busy_share": device_ms / wall_ms if device_ms else "not measured",
          "device_ms_by_class": by_class,
          "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:15]]})


def _full_width_steps(cfg, compute_dtype, steps: int, after=None) -> list:
    """``steps`` train steps of ``cfg`` on the card from seed-0 weights and
    the seed-0 pipeline, one row each (loss, grad norm, lr, seconds);
    ``after(run_one)`` runs while the training state is alive.  The state
    is freed before the rows are returned."""
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import batch_to_device, init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig

    state = list(init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda"))
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                                            total_steps=TRAIN_STEPS),
                           n_microbatches=TRAIN_MICRO, compute_dtype=compute_dtype)
    pipe = TokenPipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)

    def run_one() -> dict:
        batch = batch_to_device(pipe.next_batch(), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, residual, m = step(*state, batch)
        state[:] = (params, opt_state, residual)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        return {"loss": loss, "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
                "s": time.perf_counter() - t0}

    rows = [run_one() for _ in range(steps)]
    if after is not None:
        after(run_one)
    state.clear()
    torch.cuda.empty_cache()
    return rows


def _train_fp32_witness(cfg, rows: list, faults: list) -> dict:
    """The full-width run's first TRAIN_WITNESS_STEPS steps again, from the
    same weights and batches, with fp32 compute: the first step's loss and
    gradient norm (same weights) must agree with bf16's to its rounding;
    later steps are printed only (Adam's first update is sign-like, so it
    amplifies rounding)."""
    import torch

    fp32 = _full_width_steps(cfg, torch.float32, TRAIN_WITNESS_STEPS)
    loss_rel = abs(rows[0]["loss"] - fp32[0]["loss"]) / abs(fp32[0]["loss"])
    gn_rel = abs(rows[0]["grad_norm"] - fp32[0]["grad_norm"]) / abs(fp32[0]["grad_norm"])
    out = {"fp32": fp32, "bf16": rows[:TRAIN_WITNESS_STEPS],
           "first_step_loss_rel": loss_rel, "first_step_grad_norm_rel": gn_rel,
           "tol": TRAIN_WITNESS_REL}
    emit({"phase": "train", "check": "full_width_bf16_vs_fp32", **out})
    if not (loss_rel <= TRAIN_WITNESS_REL[0] and gn_rel <= TRAIN_WITNESS_REL[1]):
        faults.append(f"full width: bf16 and fp32 first steps differ: {out}")
    return out


def _train_full_width(faults: list) -> dict:
    """TRAIN_STEPS steps of TRAIN_ARCH at full width, TRAIN_LAYERS deep, then
    a profiled step and the fp32 witness."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ref

    full = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    n = cfg.param_count()
    remat: list = []
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "of_layers": full.n_layers, "params_b": n / 1e9,
          "full_params_b": full.param_count() / 1e9, "remat": cfg.remat,
          "cut": f"depth {full.n_layers} -> {cfg.n_layers} layers; every width is the "
                 f"published one (d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} "
                 f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size})",
          "reason": f"all {full.n_layers} layers are {full.param_count() / 1e9:.2f} B "
                    f"parameters, {16 * full.param_count() / 1e9:.0f} GB of fp32 "
                    f"parameters, gradients and two moments, above the card's 80 GB; "
                    f"{cfg.n_layers} layers are {16 * n / 2 ** 30:.1f} GiB"})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peak: list = []
    ref.counts["step_remat"] = 0
    rows = _full_width_steps(cfg, torch.bfloat16, TRAIN_STEPS, after=lambda run: (
        peak.append(torch.cuda.max_memory_allocated()),
        remat.append(ref.counts["step_remat"]), _profile_train_step(run)))
    card = torch.cuda.get_device_properties(0).total_memory
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _train_flops(cfg, tokens, TRAIN_SEQ)
    for i, r in enumerate(rows):
        r.update(tokens_per_s=tokens / r["s"], model_tflops=flops / r["s"] / 1e12)
        emit({"phase": "train", "width": "full", "step": i, **r})
    witness = _train_fp32_witness(cfg, rows, faults)
    steady = sorted(r["s"] for r in rows[1:])
    s_step = steady[len(steady) // 2]
    out = {"params_b": n / 1e9, "state_gib": 16 * n / 2 ** 30,
           "peak_gib": peak[0] / 2 ** 30, "card_gib": card / 2 ** 30,
           "peak_share": peak[0] / card, "tokens_per_step": tokens,
           "model_flops_per_step": flops, "first_step_s": rows[0]["s"],
           "s_per_step_median": s_step, "tokens_per_s": tokens / s_step,
           "model_tflops": flops / s_step / 1e12,
           "model_flops_share_of_bf16_peak": flops / s_step / PEAK_BF16,
           "losses": [r["loss"] for r in rows], "fp32_witness": witness,
           "step_remat_per_step": remat[0] / TRAIN_STEPS, "nvidia_smi": nvidia_smi()}
    emit({"phase": "train", "summary": "full_width", **out})
    if not remat[0]:
        faults.append("full width: no attention block was recomputed in a backward")
    if not all(math.isfinite(r["loss"]) for r in rows):
        faults.append(f"full width: a loss is not finite: {out['losses']}")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        faults.append(f"full width: the last loss is not below the first: {out['losses']}")
    if peak[0] >= TRAIN_PEAK_SHARE * card:
        faults.append(f"full width: peak {peak[0] / 2 ** 30:.2f} GiB is "
                      f"{100 * peak[0] / card:.1f} % of the card's")
    return out


def _train_card_vs_cpu(faults: list) -> dict:
    """Reduced TRAIN_PARITY_ARCHS in fp32: TRAIN_PARITY_STEPS steps on the
    card and on the CPU from the same weights and batches."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import batch_to_device, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_map

    out = {}
    for arch in TRAIN_PARITY_ARCHS:
        cfg = get_arch(arch).reduced()
        weights = init_params(cfg, torch.Generator().manual_seed(0))
        losses = {}
        for dev in ("cuda", "cpu"):
            params = tree_map(lambda t: t.clone().to(dev), weights)
            opt_state = adamw_init(params)
            step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10),
                                   n_microbatches=2, compute_dtype=torch.float32)
            pipe = TokenPipeline(cfg, 32, 4, seed=1)
            losses[dev] = []
            for _ in range(TRAIN_PARITY_STEPS):
                params, opt_state, _, m = step(params, opt_state, None,
                                               batch_to_device(pipe.next_batch(), dev))
                losses[dev].append(float(m["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        out[arch] = {"card": losses["cuda"], "cpu": losses["cpu"], "max_rel": rel}
        emit({"phase": "train", "check": "reduced_fp32_card_vs_cpu", "arch": arch,
              "steps": TRAIN_PARITY_STEPS, **out[arch], "tol": TRAIN_PARITY_REL})
        if not rel <= TRAIN_PARITY_REL:
            faults.append(f"reduced {arch}: card and CPU losses differ by {rel:.3g} relative")
    return out


def _train_restart(faults: list, mesh=None) -> dict:
    """A ResilientRunner over reduced TRAIN_ARCH on the card, checkpointing
    every 2 steps, with one fault raised at TRAIN_RESTART_FAULT, against
    the same run uninterrupted.  Under ``mesh`` (the mesh phase) the state
    is DTensors, each save gathers it, ``load`` places the restored tensors
    with ``train_state_shardings``, and the final loss must equal the
    uninterrupted mesh run's exactly; the seconds of every save and
    restore and the checkpoint's bytes are printed, and no kernel may
    launch."""
    import shutil

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer, place
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed.fault_tolerance import FaultPolicy, ResilientRunner
    from repro_torch.distributed.sharding import distribute_params, train_state_shardings
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd as sm
    from repro_torch.launch.train import batch_to_device, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, AdamWState, adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_arch(TRAIN_ARCH).reduced()
    weights = init_params(cfg, torch.Generator().manual_seed(1))
    directory = os.path.join(HERE, "build", "train_restart")
    timed = {"save_s": [], "restore_s": [], "checkpoint_bytes": None, "placed": []}

    class TimedCheckpointer(Checkpointer):
        def save(self, step, state, extra=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = super().save(step, state, extra)
            timed["save_s"].append(time.perf_counter() - t0)
            timed["checkpoint_bytes"] = sum(os.path.getsize(os.path.join(path, f))
                                            for f in os.listdir(path))
            return path

        def restore(self, step=None, shardings=None, device=None):
            t0 = time.perf_counter()
            out = super().restore(step, shardings=shardings, device=device)
            timed["restore_s"].append(time.perf_counter() - t0)
            return out

    def run(fault_at):
        step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=1,
                                                total_steps=TRAIN_RESTART_STEPS),
                               compute_dtype=torch.float32)
        pipe = TokenPipeline(cfg, 32, 4, seed=2)
        raised = []

        def step_fn(st, i):
            if i == fault_at and not raised:
                raised.append(i)
                raise RuntimeError(f"simulated fault at step {i}")
            params, opt_state, _ = st
            params, opt_state, _, m = step(params, opt_state, None,
                                           batch_to_device(pipe.next_batch(), "cuda"))
            return params, opt_state, float(m["loss"])

        def save(st):
            return ({"params": st[0], "opt_state": st[1]._asdict()},
                    {"pipeline": pipe.state_dict(), "loss": st[2]})

        def load(tree, extra):
            pipe.load_state_dict(extra["pipeline"])
            if mesh is None:
                tree = tree_map(lambda t: t.to("cuda"), tree)
            else:                   # the restore's second half: this rank's shards
                t0 = time.perf_counter()
                tree = place(tree, train_state_shardings(weights, mesh, cfg), device="cuda")
                torch.cuda.synchronize()
                timed["restore_s"][-1] += time.perf_counter() - t0
                o = tree["opt_state"]
                timed["placed"].append(all(
                    isinstance(t, DTensor) and t.device.type == "cuda"
                    for t in tree_leaves(tree["params"]) + tree_leaves(o["mu"])
                    + tree_leaves(o["nu"])))
            o = tree["opt_state"]
            return tree["params"], AdamWState(o["step"], o["mu"], o["nu"]), extra["loss"]

        shutil.rmtree(directory, ignore_errors=True)
        params = tree_map(lambda t: t.clone().to("cuda"), weights)
        if mesh is not None:
            params = distribute_params(params, mesh, cfg)
        runner = ResilientRunner(TimedCheckpointer(directory, keep=2),
                                 FaultPolicy(max_restarts=2, checkpoint_every=2), save, load)
        try:
            final, end = runner.run((params, adamw_init(params), float("nan")), step_fn,
                                    start_step=0, n_steps=TRAIN_RESTART_STEPS)
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        return final[2], end, runner

    kernels = {"flash_attention": fa.flash_attention, "flash_decode": fd.flash_decode,
               "ssd_chunked": sm.ssd_chunked}
    ctx.set_mesh(mesh)
    try:
        torch.cuda.synchronize()
        before = {name: fn.launches for name, fn in kernels.items()}
        clean_loss, _, clean = run(None)
        loss, end, runner = run(TRAIN_RESTART_FAULT)
        torch.cuda.synchronize()
    finally:
        ctx.set_mesh(None)
    launches = {name: fn.launches - before[name] for name, fn in kernels.items()}
    rel = abs(loss - clean_loss) / abs(clean_loss)
    out = {"final_loss": loss, "uninterrupted_final_loss": clean_loss, "rel": rel,
           "end_step": end, "restarts": runner.restarts, "events": runner.events,
           "uninterrupted_restarts": clean.restarts}
    ok = (runner.restarts == 1 and clean.restarts == 0 and end == TRAIN_RESTART_STEPS)
    if mesh is None:
        emit({"phase": "train", "check": "checkpoint_restart", **out, "tol": TRAIN_RESTART_REL})
        ok = ok and rel <= TRAIN_RESTART_REL
    else:
        out.update(equal=loss == clean_loss, restored_dtensors_on_cuda=timed["placed"],
                   save_s=timed["save_s"], restore_s=timed["restore_s"],
                   checkpoint_bytes=timed["checkpoint_bytes"], launches=launches,
                   nvidia_smi=nvidia_smi())
        emit({"phase": "mesh", "part": "checkpoint_restart", "arch": cfg.name, **out})
        ok = (ok and out["equal"] and timed["placed"] == [True]
              and not any(launches.values()))
    if not ok:
        faults.append(f"checkpoint-restart: {out}")
    return out


def _train_guards(faults: list) -> dict:
    """Each kernel wrapper refuses inputs that require grad, and a loss
    through impl="kernel" raises at the first launch."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd as sm
    from repro_torch.models import init_params, lm_loss
    from repro_torch.tree import tree_leaves

    g = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

    q = rand(1, 4, 128, 64, dtype=torch.bfloat16).requires_grad_()
    k, v = rand(1, 2, 128, 64, dtype=torch.bfloat16), rand(1, 2, 128, 64, dtype=torch.bfloat16)
    cache = rand(1, 2, 128, 64)
    vl = torch.full((1,), 100, dtype=torch.int32, device="cuda")
    x = rand(1, 64, 2, 64).requires_grad_()
    dt = torch.full((1, 64, 2), 0.01, device="cuda")
    A = -torch.ones(2, device="cuda")
    Bm, Cm = rand(1, 64, 1, 16), rand(1, 64, 1, 16)
    cfg = get_arch(TRAIN_ARCH).reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    toks = torch.zeros((1, 16), dtype=torch.long, device="cuda")
    calls = {
        "flash_attention": lambda: fa.flash_attention(q, k, v, causal=True),
        "flash_decode": lambda: fd.flash_decode(rand(1, 4, 64).requires_grad_(), cache,
                                                cache, vl),
        "ssd_chunked": lambda: sm.ssd_chunked(x, dt, A, Bm, Cm, chunk=32),
        "lm_loss_impl_kernel": lambda: lm_loss(params, cfg, {"tokens": toks, "labels": toks},
                                               compute_dtype=torch.float32, impl="kernel")}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
        if not (out[name] and "no backward" in out[name]):
            faults.append(f"guard {name}: {out[name]!r}")
    emit({"phase": "train", "check": "kernel_guards", "raised": out})
    return out


def phase_train(state):
    """Training through the blocked references: full width, card against
    the CPU, checkpoint-restart and the kernel guards; no kernel launches."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd as sm

    kernels = {"flash_attention": fa.flash_attention, "flash_decode": fd.flash_decode,
               "ssd_chunked": sm.ssd_chunked}
    faults: list = []
    torch.cuda.synchronize()
    reset_counts(*kernels.values())
    parts = {}
    for name, part in (("full_width", _train_full_width),
                       ("card_vs_cpu", _train_card_vs_cpu),
                       ("restart", _train_restart), ("guards", _train_guards)):
        t0 = time.perf_counter()
        parts[name] = part(faults)
        parts[name + "_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    emit({"phase": "train", "summary": True, "launches": launches,
          "seconds": {k: v for k, v in parts.items() if k.endswith("_s")}})
    if any(launches.values()):
        faults.append(f"kernel launches in the train phase: {launches}")
    state["train"] = {"launches": launches, **parts}
    if faults:
        raise AssertionError("train: " + "; ".join(faults))


def _mesh_train(faults: list, mesh) -> dict:
    """TRAIN_ARCH at full width, MESH_TRAIN_STEPS steps through the mesh and
    off it, from the same seed and batches (the mesh state is freed first)."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import context as ctx
    from repro_torch.models import attention, transformer

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    rows, peak, loss_shards, kv_columns = {}, {}, {}, {}
    for path in ("mesh", "unsharded"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ctx.set_mesh(mesh if path == "mesh" else None)
        transformer.counts["loss_shards"] = 0
        attention.counts["kv_columns"] = 0
        try:
            rows[path] = _full_width_steps(
                cfg, torch.bfloat16, MESH_TRAIN_STEPS,
                after=lambda run, path=path: peak.__setitem__(
                    path, torch.cuda.max_memory_allocated() / 2 ** 30))
        finally:
            ctx.set_mesh(None)
        loss_shards[path] = transformer.counts["loss_shards"]
        kv_columns[path] = attention.counts["kv_columns"]
        for i, r in enumerate(rows[path]):
            emit({"phase": "mesh", "part": "train", "path": path, "step": i, **r})
        # on one model rank the whole vocab is its own: the loss takes the
        # log-softmax over it as off the mesh
        if loss_shards[path]:
            faults.append(f"train {path}: {loss_shards[path]} loss calls took the "
                          f"log-softmax over vocab shards")
        # on one model rank every KV head is its own: K/V are projected whole
        if kv_columns[path]:
            faults.append(f"train {path}: {kv_columns[path]} attentions projected only "
                          f"their KV heads")
    first = [rows[p][0]["loss"] for p in ("mesh", "unsharded")]
    rel = abs(first[0] - first[1]) / abs(first[1])
    steady = {p: sorted(r["s"] for r in rows[p][1:]) or [rows[p][0]["s"]] for p in rows}
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "steps": MESH_TRAIN_STEPS,
           "losses": {p: [r["loss"] for r in rows[p]] for p in rows},
           "grad_norms": {p: [r["grad_norm"] for r in rows[p]] for p in rows},
           "loss_diff": [a["loss"] - b["loss"] for a, b in zip(rows["mesh"], rows["unsharded"])],
           "grad_norm_diff": [a["grad_norm"] - b["grad_norm"]
                              for a, b in zip(rows["mesh"], rows["unsharded"])],
           "first_step_loss_rel": rel, "tol": MESH_LOSS_REL,
           "s_per_step": {p: v[len(v) // 2] for p, v in steady.items()},
           "first_step_s": {p: rows[p][0]["s"] for p in rows},
           "peak_gib": peak, "loss_shards": loss_shards, "kv_columns": kv_columns}
    emit({"phase": "mesh", "summary": "train", **out})
    if not rel <= MESH_LOSS_REL:
        faults.append(f"train: first-step losses {first} differ by {rel:.3g} relative")
    return out


def _mesh_checkpoint_full(faults: list, mesh) -> dict:
    """One save and one restore of TRAIN_ARCH's fp32 train state (params,
    AdamW step, mu, nu) at full width and CKPT_LAYERS layers on the mesh:
    the gather and host copy of each leaf, rank 0's npz and its hash, the
    hash and load on the restore and each shard's copy to the card, at the
    leaves' real sizes.  Every restored leaf must be placed as it was saved,
    with an equal local shard."""
    import dataclasses
    import shutil

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _leaves
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed.sharding import distribute_params, train_state_shardings
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=CKPT_LAYERS)
    directory = os.path.join(HERE, "build", "checkpoint_full")
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_params(cfg, gen, device="cuda", dtype=torch.float32)

    def drawn(scale):
        return distribute_params(tree_map(lambda p: torch.randn(
            p.shape, generator=gen, device="cuda").mul_(scale).abs_(), params), mesh, cfg)

    placed = distribute_params(params, mesh, cfg)
    state = {"params": placed,
             "opt_state": {"step": torch.ones((), dtype=torch.int32, device="cuda"),
                           "mu": drawn(1e-3), "nu": drawn(1e-6)}}
    ck = Checkpointer(directory, keep=1)
    ctx.set_mesh(mesh)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ck.save(1, state)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = time.perf_counter()
        _, got, _ = ck.restore(1, shardings=train_state_shardings(params, mesh, cfg),
                               device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        saved, back = _leaves(state), _leaves(got)
        bad = sorted(k for k in saved if k not in back or not (
            torch.equal(back[k], saved[k]) if not isinstance(saved[k], DTensor) else
            isinstance(back[k], DTensor) and back[k].device.type == "cuda"
            and back[k].placements == saved[k].placements
            and torch.equal(back[k].to_local(), saved[k].to_local())))
    finally:
        ctx.set_mesh(None)
        shutil.rmtree(directory, ignore_errors=True)
    n = sum(p.numel() for p in _leaves(params).values())
    largest = max(_leaves(params).items(), key=lambda kv: kv[1].numel())
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "params_b": n / 1e9,
           "leaves": len(saved), "largest_leaf": [largest[0], list(largest[1].shape)],
           "checkpoint_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
           "save_gb_per_s": nbytes / save_s / 1e9, "restore_gb_per_s": nbytes / restore_s / 1e9,
           "peak_gib": peak / 2 ** 30, "unequal": bad, "nvidia_smi": nvidia_smi()}
    emit({"phase": "mesh", "part": "checkpoint_full_width", **out})
    if bad or len(back) != len(saved):
        faults.append(f"full-width checkpoint: {len(bad)} leaves restored unequal: {bad[:5]}")
    del state, got, placed, params, saved, back
    torch.cuda.empty_cache()
    return out


def _mesh_serve(faults: list, mesh) -> dict:
    """SERVE_ARCH at full width, one group through BatchedServer on the mesh
    and off it, every launch held against its plain version."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as sm
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import attention, init_params, ssm, transformer

    cfg = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=SERVE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                         dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    lens = rng.integers(*SERVE_PROMPT, size=SERVE_BATCH)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in lens]
    kernels = {"flash_attention": fa.flash_attention, "flash_decode": fd.flash_decode,
               "ssd_chunked": sm.ssd_chunked}
    n_attn = sum(b.kind == "attn" for b in cfg.pattern) * cfg.n_periods
    n_mamba = sum(b.kind == "mamba" for b in cfg.pattern) * cfg.n_periods
    expected = {"flash_attention": n_attn, "ssd_chunked": n_mamba,
                "flash_decode": n_attn * (MESH_SERVE_NEW - 1)}
    products_a_step = decode_products(cfg)
    runs = {}
    for path in ("mesh", "unsharded"):
        ctx.set_mesh(mesh if path == "mesh" else None)
        try:
            placed = distribute_params(params, mesh, cfg) if path == "mesh" else params
            server = BatchedServer(cfg, placed, batch_size=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                                   compute_dtype=torch.bfloat16)
            group = [Request(i, p, MESH_SERVE_NEW) for i, p in enumerate(prompts)]
            checks: dict = {}
            torch.cuda.synchronize()
            reset_counts(*kernels.values())
            spmd.counts.update(products=0, collectives=0)
            ssm.counts["own_columns"] = 0
            attention.counts.update(length_model=0, kv_columns=0)
            transformer.counts["head_columns"] = 0
            with ops.checking(lambda name, st: checks.setdefault(name, []).append(st)):
                server.run_group(group)
            torch.cuda.synchronize()
            route = dict(spmd.counts)
            own = ssm.counts["own_columns"]
            length_model = attention.counts["length_model"]
            kv_columns = attention.counts["kv_columns"]
            head_columns = transformer.counts["head_columns"]
        finally:
            ctx.set_mesh(None)
        launches = {name: fn.launches for name, fn in kernels.items()}
        t = server.timings[0]
        dec = sorted(t["decode_ms"])
        runs[path] = {"tokens": [r.output for r in group], "launches": launches,
                      "by_body": dict(fa.flash_attention.launches_by_body),
                      "ssd_by_body": dict(sm.ssd_chunked.launches_by_body),
                      "decode_by_body": dict(fd.flash_decode.launches_by_body),
                      "prefill_ms": t["prefill_ms"], "decode_ms_median": dec[len(dec) // 2],
                      "decode_steps": len(dec), "prompt_len": t["prompt_len"],
                      "stationary_route": route, "own_columns": own,
                      "length_model": length_model, "kv_columns": kv_columns,
                      "head_columns": head_columns}
        runs[path]["err"] = _checked(checks, faults, phase="mesh", part="serve", path=path)
        emit({"phase": "mesh", "part": "serve", "path": path,
              **{k: v for k, v in runs[path].items() if k != "tokens"},
              "tokens_first_request": runs[path]["tokens"][0]})
        if launches != expected:
            faults.append(f"serve {path}: launches {launches}, the path implies {expected}")
        # decode multiplies every weight on its shard: on one rank, with no
        # collective; off the mesh the route is not taken
        want_products = products_a_step * (MESH_SERVE_NEW - 1) if path == "mesh" else 0
        if route != {"products": want_products, "collectives": 0}:
            faults.append(f"serve {path}: the stationary route took {route}, "
                          f"want {want_products} products and no collective")
        # on one model rank its columns of in_proj are every column: the
        # prefill multiplies the whole weight as it is
        if own:
            faults.append(f"serve {path}: {own} Mamba blocks took the own-columns route")
        # on one model rank the cache length stays whole
        if length_model:
            faults.append(f"serve {path}: {length_model} decode attentions split the cache "
                          f"length over model")
        # on one model rank the whole vocab is its own
        if head_columns:
            faults.append(f"serve {path}: {head_columns} head calls split the vocab over model")
        # on one model rank prefill projects every KV head, as it does anywhere
        if kv_columns:
            faults.append(f"serve {path}: {kv_columns} attentions projected only their KV heads")
        if runs[path]["by_body"]["wgmma"] != launches["flash_attention"] or \
                runs[path]["ssd_by_body"]["chunked"] != launches["ssd_chunked"] or \
                runs[path]["decode_by_body"]["wgmma"] != launches["flash_decode"]:
            faults.append(f"serve {path}: bodies {runs[path]['by_body']} "
                          f"{runs[path]['ssd_by_body']} {runs[path]['decode_by_body']}")
    equal = runs["mesh"]["tokens"] == runs["unsharded"]["tokens"]
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": SERVE_BATCH,
           "prompt_lens": [int(n) for n in lens], "new_tokens": MESH_SERVE_NEW,
           "tokens_equal": equal, "launches_expected": expected,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           **{f"{k}_{p}": runs[p][k] for p in runs
              for k in ("launches", "prefill_ms", "decode_ms_median", "err")}}
    emit({"phase": "mesh", "summary": "serve", **out})
    if not equal:
        faults.append(f"serve: tokens differ: mesh {runs['mesh']['tokens']} unsharded "
                      f"{runs['unsharded']['tokens']}")
    del params, placed, server
    torch.cuda.empty_cache()
    return {**out, "launches": runs["mesh"]["launches"],
            "decode_by_body": runs["mesh"]["decode_by_body"]}


def decode_products(cfg) -> int:
    """The products one decode step takes through spmd.dot and
    spmd.lookup: the table and the head, and per block Q, K, V and the
    output projection (and the cross-attention's Q and output projection),
    in_proj and out_proj, the router and three expert products, or the
    MLP's two or three."""
    per_block = {"attn": 4, "mamba": 2}
    per_mlp = {"moe": 4, "gated_silu": 3, "gated_gelu": 3, "squared_relu": 2, "relu": 2}
    return 2 + cfg.n_periods * sum(per_block.get(b.kind, 0) + per_mlp.get(b.mlp, 0)
                                   + 2 * (b.cross_attn and cfg.enc_dec) for b in cfg.pattern)


def phase_mesh(state):
    """The train step and the served path under a one-rank NCCL mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    store = os.path.join(HERE, "build", f"mesh-store-{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    backend = init_process_group(store, 0, 1)
    faults: list = []
    try:
        mesh = make_host_mesh()
        emit({"phase": "mesh", "backend": backend, "world_size": dist.get_world_size(),
              "mesh": {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)},
              "device_type": mesh.device_type, "nvidia_smi": nvidia_smi()})
        if backend != "nccl" or mesh.device_type != "cuda":
            faults.append(f"the card mesh is {backend} on {mesh.device_type}")
        parts = {}
        for name, part in (("train", _mesh_train), ("checkpoint_restart", _train_restart),
                           ("checkpoint_full_width", _mesh_checkpoint_full),
                           ("serve", _mesh_serve)):
            t0 = time.perf_counter()
            parts[name] = part(faults, mesh)
            parts[name + "_s"] = time.perf_counter() - t0
        train_s = state.get("train", {}).get("full_width", {}).get("s_per_step_median")
        emit({"phase": "mesh", "summary": True,
              "train_s_per_step": parts["train"]["s_per_step"],
              "train_phase_s_per_step": train_s,
              "serve_prefill_ms": {p: parts["serve"][f"prefill_ms_{p}"]
                                   for p in ("mesh", "unsharded")},
              "serve_step_ms": {p: parts["serve"][f"decode_ms_median_{p}"]
                                for p in ("mesh", "unsharded")},
              "checkpoint_restart_equal": parts["checkpoint_restart"]["equal"],
              "checkpoint_full_width_gb_per_s": {
                  k: parts["checkpoint_full_width"][f"{k}_gb_per_s"]
                  for k in ("save", "restore")},
              "launches": parts["serve"]["launches"],
              "seconds": {k: v for k, v in parts.items() if k.endswith("_s")}})
        state["mesh"] = {"launches": parts["serve"]["launches"], **parts}
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
        torch.cuda.empty_cache()
    if faults:
        raise AssertionError("mesh: " + "; ".join(faults))


def dryrun_child(out_dir: str) -> None:
    """The dryrun phase's subprocess (``python -c``, PYTHONPATH=src): the
    DRYRUN_CELLS records through ``run_cell`` on fake process groups, and
    the one-device calibration records of the train and serve phases'
    steps; prints one JSON line, with whether CUDA was ever initialised."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun

    records = []
    for arch, cell, meshes in DRYRUN_CELLS:
        for multi_pod in meshes:
            records.append(dryrun.run_cell(arch, cell, multi_pod=multi_pod, force=True,
                                           out_dir=out_dir))
    calib = {}
    for name, arch, layers, cell, knobs in (
            ("train", TRAIN_ARCH, TRAIN_LAYERS,
             ShapeCell("train_phase", TRAIN_SEQ, TRAIN_BATCH, "train"),
             {"n_microbatches": TRAIN_MICRO}),
            ("serve_decode", SERVE_ARCH, SERVE_LAYERS,
             ShapeCell("serve_phase_decode", SERVE_MAX_LEN, SERVE_BATCH, "decode"),
             {"param_dtype": torch.bfloat16})):
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
        t0 = time.perf_counter()
        traced = dryrun.trace_cell(cfg, cell, None, **knobs)
        rec = dryrun.analyze(cfg, cell, traced, None)
        rec["wall_s"] = {"trace": time.perf_counter() - t0}
        calib[name] = rec
    print(json.dumps({"records": records, "calibration": calib,
                      "cuda_initialized": torch.cuda.is_initialized()}), flush=True)


def phase_dryrun(state):
    """The dry run in a subprocess (this process has a CUDA context and,
    after the mesh phase, had a default process group), then the pinned
    record and the calibration against the train and serve phases."""
    from repro_torch.configs.base import SHAPES_BY_NAME

    out_dir = os.path.join(HERE, "build", "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.dryrun_child({out_dir!r})"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dryrun: the subprocess exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    faults: list = []
    if out["cuda_initialized"]:
        faults.append("the dry run initialised CUDA")
    for rec in out["records"]:
        emit({"phase": "dryrun", "arch": rec["arch"], "cell": rec["cell"],
              "mesh": rec["mesh"], "n_chips": rec["n_chips"], "terms_s": rec["terms_s"],
              "dominant": rec["dominant"], "useful_flops_frac": rec["useful_flops_frac"],
              "hlo_dot_flops": rec["hlo_dot_flops"],
              "collective_bytes": rec["collectives"]["bytes"],
              "collective_bytes_a_rank": rec["collectives"]["total_bytes"],
              "collective_bytes_by_axis": rec["collectives"]["by_axis"],
              "top_collective_sites": rec["top_collective_sites"][:3],
              "memory": rec["memory"], "n_microbatches": rec.get("n_microbatches"),
              "wall_s": rec["wall_s"]})
        if not (rec["hlo_flops"] > 0 and rec["terms_s"]["memory"] > 0
                and 0 < rec["useful_flops_frac"] < 5.0):
            faults.append(f"{rec['arch']} {rec['cell']} {rec['mesh']}: record {rec}")
        # decode multiplies every weight on its shard: no site may gather one
        gathered = [site for site, _ in rec["top_collective_sites"] if ">use" in site]
        if SHAPES_BY_NAME[rec["cell"]].kind == "decode" and gathered:
            faults.append(f"{rec['arch']} {rec['cell']} {rec['mesh']}: weight-gather "
                          f"sites {gathered}")
    pinned = next(r for r in out["records"] if r["arch"] == "mamba2-780m"
                  and r["n_chips"] == 256)
    got = {"hlo_dot_flops": pinned["hlo_dot_flops"],
           "collective_bytes": pinned["collectives"]["bytes"]}
    emit({"phase": "dryrun", "check": "pinned_pod1", "got": got, "want": DRYRUN_PINNED})
    if got != DRYRUN_PINNED:
        faults.append(f"the pinned record {got} differs from the CPU's {DRYRUN_PINNED}")
    _dryrun_calibration(state, out["calibration"], faults)
    emit({"phase": "dryrun", "summary": True, "records": len(out["records"]),
          "subprocess_s": wall, "cuda_initialized": out["cuda_initialized"]})
    if faults:
        raise AssertionError("dryrun: " + "; ".join(faults))


def _dryrun_calibration(state, calib: dict, faults: list) -> None:
    """Each one-device record's largest term against the step time its
    phase measured (a roofline is a lower bound), and the train record's
    argument + temp bytes against the train phase's peak memory."""
    measured = {}
    train = state.get("train", {}).get("full_width")
    if train is not None:
        measured["train"] = train["s_per_step_median"]
    timings = state.get("serve", {}).get("timings")
    if timings is not None:
        dec = sorted(timings[1]["decode_ms"])   # the traffic's second group: none checked
        measured["serve_decode"] = dec[len(dec) // 2] * 1e-3
    for name, rec in calib.items():
        bound = max(rec["terms_s"].values())
        row = {"phase": "dryrun", "check": "calibration", "record": name,
               "arch": rec["arch"], "terms_s": rec["terms_s"], "dominant": rec["dominant"],
               "memory": rec["memory"], "bound_s": bound, "measured_s": measured.get(name)}
        if name in measured:
            row["bound_over_measured"] = bound / measured[name]
            if bound > measured[name]:
                faults.append(f"calibration {name}: bound {bound:.4f} s above the "
                              f"measured {measured[name]:.4f} s")
        if name == "train" and train is not None:
            est = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
            peak = train["peak_gib"] * 2 ** 30
            row.update(estimate_gib=est / 2 ** 30, peak_gib=train["peak_gib"],
                       estimate_over_peak=est / peak)
            if abs(est / peak - 1) > DRYRUN_MEM_REL:
                faults.append(f"calibration train: argument + temp {est / 2 ** 30:.2f} GiB "
                              f"against the measured peak {train['peak_gib']:.2f} GiB")
        if name not in measured:
            row["measured_s"] = "not measured: its phase did not run"
        emit(row)


def _card_vs_cpu_tokens(cfg, check: bool):
    """``cfg`` in fp32 with weights from seed 0 served on the card
    (impl="auto": the kernels) and on the CPU (the blocked references):
    4 prompts of 5-39 tokens, batch 2, 8 new tokens.  With ``check`` every
    card launch is held to its plain version (eagerly); without, the card's
    decode step is a CUDA graph.  Returns both token lists and the checked
    launches' stats by kernel."""
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
        # checked launches run eagerly; unchecked, the card replays a CUDA graph
        srv = BatchedServer(cfg, p, batch_size=2, max_len=64,
                            graph=False if check else None)
        hook = (ops.checking(lambda k, st: seen.setdefault(k, []).append(st))
                if check and name == "card" else contextlib.nullcontext())
        with hook:
            outs[name] = [r.output for r in srv.run([Request(i, pr, 8)
                                                     for i, pr in enumerate(prompts)])]
    return outs, seen


def _sign_pair(sample) -> tuple:
    """Two genomes of the rank phase's sample whose measured geomeans differ
    by SIGN_BAND, ordered (slower, faster) by that reading: of those pairs,
    the one the H100 model orders the same way by the widest margin."""
    genomes, card, model = sample["genomes"], sample["card"], sample["h100"]
    best = None
    for i in range(len(genomes)):
        for j in range(len(genomes)):
            rel = card[j] / card[i] - 1.0
            if not SIGN_BAND[0] <= rel <= SIGN_BAND[1] or model[j] <= model[i]:
                continue
            if best is None or model[j] / model[i] > best[0]:
                best = (model[j] / model[i], i, j, rel)
    if best is None:
        raise AssertionError(f"noise: no two genomes of the rank sample differ by "
                             f"{SIGN_BAND} in the order the H100 model gives")
    _, i, j, rel = best
    return genomes[i], genomes[j], rel


def phase_noise(state):
    """The spread of the measured rung, unpaired and paired: NOISE_REPS
    scorings of the seed and the pipelined genome on mha_suite and
    gqa_suite, in turns, each paid anew (``score_uncached``: no memo); then
    NOISE_REPS paired comparisons (``Scorer.paired_gain``) of each genome
    against itself.  Two scorings of one genome differ by at most max / min
    - 1 of its geomean; a genome paired against itself gains at most max
    |gain|.  The commit decides on the paired gain, so a floor below the
    paired spread lets a re-timing of an unchanged kernel commit.  The sign
    check: two genomes of the rank sample SIGN_BAND apart, paired
    NOISE_REPS times, must give gains of one sign (the rank phase runs
    first)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.core.evals import (MEASURED, MEASURED_CALL_SPREAD,
                                        MEASURED_MIN_REL, Scorer)
    from repro_torch.core.evals.scorer import (PAIRED_REPS, TIMING_REPS,
                                               TIMING_WARMUP)
    from repro_torch.core.perfmodel import gqa_suite, mha_suite
    from repro_torch.core.search_space import seed_genome

    genomes = {"seed": seed_genome(), "pipelined": pipelined_genome()}
    spreads, paired, paired_s = {}, {}, {}
    sign = None
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
        for name, g in genomes.items():
            vals = geo[name]
            spreads[(suite_name, name)] = max(vals) / min(vals) - 1.0
            pgs = [scorer.paired_gain(g, g) for _ in range(NOISE_REPS)]
            gains = [pg.gain for pg in pgs]
            paired[(suite_name, name)] = max(abs(x) for x in gains)
            paired_s[(suite_name, name)] = statistics.mean(pg.seconds for pg in pgs)
            # the geomean ratio at each round index, over configs and
            # comparisons: the incumbent runs first in even rounds
            by_round = [float(np.exp(np.mean([np.log(rs[r]) for pg in pgs
                                              for rs in pg.rounds.values()])))
                        for r in range(PAIRED_REPS)]
            emit({"phase": "noise", "suite": suite_name, "genome": name,
                  "scorings": len(vals), "geomeans": vals,
                  "median": statistics.median(vals),
                  "rel_stdev": statistics.stdev(vals) / statistics.mean(vals),
                  "spread_max_over_min": spreads[(suite_name, name)],
                  "wall_s_all_genomes": wall,
                  "paired_gains": gains, "paired_spread_max_abs": paired[(suite_name, name)],
                  "paired_ratio_by_round": by_round,
                  "s_per_paired_decision": paired_s[(suite_name, name)]})
        if suite_name == "mha_suite":         # the sign check
            slow, fast, rel = _sign_pair(state["rank_sample"])
            pgs = [scorer.paired_gain(slow, fast) for _ in range(NOISE_REPS)]
            gains = [pg.gain for pg in pgs]
            sign = {"unpaired_rel": rel, "paired_gains": gains,
                    "one_sign": all(x > 0 for x in gains) or all(x < 0 for x in gains),
                    "s_per_paired_decision": statistics.mean(pg.seconds for pg in pgs),
                    "incumbent": slow.kernel_kwargs(), "candidate": fast.kernel_kwargs()}
            emit({"phase": "noise", "check": "sign", **sign})
        del scorer
        torch.cuda.empty_cache()
    worst = max(spreads.values())
    worst_paired = max(paired.values())
    emit({"phase": "noise", "summary": True, "max_spread": worst,
          "at": "/".join(max(spreads, key=spreads.get)),
          "max_paired_spread": worst_paired, "paired_at": "/".join(max(paired, key=paired.get)),
          "paired_below_unpaired": worst_paired < worst,
          "s_per_paired_decision": {"/".join(k): v for k, v in paired_s.items()},
          "floor_in_force": MEASURED_MIN_REL,
          "floor_over_paired_spread": MEASURED_MIN_REL / worst_paired,
          "call_spread_in_force": MEASURED_CALL_SPREAD,
          "sign_check_one_sign": sign["one_sign"],
          "timer": f"CUDA events, {TIMING_WARMUP} warm-up, median of {TIMING_REPS}",
          "paired_timer": f"1 warm-up each, median of {PAIRED_REPS} rounds in turns"})
    state["noise"] = {"max_spread": worst, "max_paired_spread": worst_paired,
                      "floor": MEASURED_MIN_REL, "sign": sign}
    if MEASURED_MIN_REL < worst_paired:
        raise AssertionError(f"the commit floor {MEASURED_MIN_REL} lies below the "
                             f"measured paired spread {worst_paired}")
    if MEASURED_CALL_SPREAD < worst:
        raise AssertionError(f"the call spread {MEASURED_CALL_SPREAD} lies below the "
                             f"measured unpaired spread {worst}")
    if not sign["one_sign"]:
        raise AssertionError(f"noise: paired gains of two genomes {sign['unpaired_rel']:+.2%} "
                             f"apart change sign: {sign['paired_gains']}")


def check_commits(lineage, phase, decisions) -> list:
    """Every commit's values positive, and every commit after the first
    decided on a paired gain above the commit floor (the paired agent's
    ``decisions``).  Returns those gains."""
    from repro_torch.core.evals import MEASURED_MIN_REL
    committed = {d["genome"]: d["paired"] for d in decisions if d["committed"]}
    for c in lineage.commits:
        if not all(v > 0 and v == v for v in c.values):
            raise AssertionError(f"{phase}: commit {c.version} has a non-positive value")
    gains = []
    for c in lineage.commits[1:]:
        gains.append(committed.get(c.genome.key()))
        if gains[-1] is None or gains[-1] <= MEASURED_MIN_REL:
            raise AssertionError(f"{phase}: commit {c.version} decided on paired gain "
                                 f"{gains[-1]}, not above the floor {MEASURED_MIN_REL}")
    return gains


def paired_summary(agent) -> dict:
    """The paired agent's decisions: how many were paired, the seconds per
    paired decision, and each decision's paired and unpaired gain."""
    timed = [d for d in agent.decisions if d["seconds"] is not None]
    return {"decisions": len(agent.decisions), "paired_decisions": len(timed),
            "s_per_paired_decision": (sum(d["seconds"] for d in timed) / len(timed)
                                      if timed else None),
            "paired_s": sum(d["seconds"] for d in timed),
            "gains_paired_unpaired": [(d["paired"], d["unpaired"])
                                      for d in agent.decisions]}


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


def _rank_genomes() -> list:
    """The rank phase's sample: RANK_GENOMES genomes drawn with RANK_SEED
    (fp32 accumulators), then the seed and the pipelined genome."""
    from repro_torch.core.search_space import seed_genome
    genomes = _draw(RANK_GENOMES, RANK_SEED)
    return genomes + [g for g in (seed_genome(), pipelined_genome()) if g not in genomes]


def phase_rank(state):
    """Rungs 0 and 1 against rung 2: a seeded genome sample scored once
    each at the measured rung on mha_suite, ranked against each rung-0
    model's geomeans and rung 1's (the trace memo emptied first).  Fails
    when rung 1 does not rank with the card (rho <= 0) or costs as much
    host time a scoring as rung 2 costs."""
    import numpy as np
    import torch

    from repro_torch.core import perfmodel, perfmodel_h100
    from repro_torch.core.evals import HLO, MEASURED, Scorer
    from repro_torch.core.evals.scorer import _TRACE_MEMO
    from repro_torch.core.perfmodel import mha_suite
    from repro_torch.kernels.flash_attention import flash_attention

    genomes = _rank_genomes()
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
    # rung 1.  Set-up before the clock, as rung 2's inputs are made before
    # its clock: the process's first meta trace loads PyTorch's meta kernels
    # once.  Then the trace memo is emptied, so the sample pays its tiles'
    # traces; then each genome once more with the memo warm
    rung1_scorer = Scorer(suite=suite, fidelity=HLO, check_correctness=False,
                          machine="h100")
    t1 = time.perf_counter()
    rung1_scorer.score_uncached(genomes[0])
    rung1_setup_s = time.perf_counter() - t1
    _TRACE_MEMO.clear()
    t1 = time.perf_counter()
    rung1 = [rung1_scorer(g).geomean for g in genomes]
    rung1_s = (time.perf_counter() - t1) / len(genomes)
    t1 = time.perf_counter()
    warm = [rung1_scorer.score_uncached(g).geomean for g in genomes]
    rung1_warm_s = (time.perf_counter() - t1) / len(genomes)
    if warm != rung1:
        raise AssertionError("rank: rung 1 with the trace memo warm differs from its first scoring")
    for g, c, h, t, r in zip(genomes, card, h100, tpu, rung1):
        emit({"phase": "rank", "genome": g.kernel_kwargs(), "card_tflops": c,
              "h100_model_tflops": h, "tpu_v5e_model_tflops": t, "rung1_tflops": r})
    out = {"rho_h100_model": spearman(h100, card), "rho_tpu_v5e_model": spearman(tpu, card),
           "rho_rung1": spearman(rung1, card), "rung1_s_per_scoring": rung1_s,
           "rung1_s_per_scoring_memo_warm": rung1_warm_s,
           "rung1_s_setup_first_trace_in_process": rung1_setup_s,
           "rung1_traces": _TRACE_MEMO.stats()["entries"],
           "genomes": len(genomes), "sample_seed": RANK_SEED,
           "estimate_s_h100_model": h100_s, "estimate_s_tpu_v5e_model": tpu_s,
           "model_s_per_scoring_h100": h100_s * len(suite),
           "model_s_per_scoring_tpu_v5e": tpu_s * len(suite),
           "measured_s_per_scoring": wall / len(genomes),
           "launches": launches, "launches_by_body": by_body}
    emit({"phase": "rank", "summary": True, "gate": True, **out})
    if not (out["rho_rung1"] > 0
            and out["rung1_s_per_scoring"] < out["measured_s_per_scoring"]):
        raise AssertionError(
            f"rank: rung 1 rho {out['rho_rung1']} (rung 0 on the H100 model "
            f"{out['rho_h100_model']}), {out['rung1_s_per_scoring']} host s a "
            f"scoring against {out['measured_s_per_scoring']} at rung 2")
    state.update(rank=out, rank_launches=launches,
                 rank_sample={"genomes": genomes, "card": card, "h100": h100},
                 model_checks_s=state.get("model_checks_s", 0.0) + time.perf_counter() - t0)
    del scorer
    torch.cuda.empty_cache()


def phase_evolve(state):
    """The measured evolution twice, in turn: planned from the H100 model
    and Hopper facts (the default), then from the TPU v5e model's profiles
    and facts (the planning A/B); each against the pipelined genome scored
    in this call."""
    import torch

    from repro_torch.core.evals import MEASURED, MEASURED_CALL_SPREAD, InlineBackend, Scorer
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
    # the target compares a search's best with a reading of another call
    target = pipelined * (1.0 - MEASURED_CALL_SPREAD)
    emit({"phase": "evolve", "pipelined_tflops": pipelined, "target_tflops": target})
    state["pipelined_tflops"] = pipelined
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
        gains = check_commits(evo.lineage, "evolve", evo.operator.policy.decisions)
        paired = paired_summary(evo.operator.policy)
        plans[plan] = {"paid_evals_to_pipelined": reached, "commits": len(evo.lineage),
                       "best_tflops": best.geomean, "launches": launches}
        emit({"phase": "evolve", "summary": True, "plan": plan,
              "kb": "hopper" if evo.kb.facts == HOPPER_FACTS else "tpu_v5e", "steps": step,
              "paid_evals": scorer.n_evaluations, "commits": len(evo.lineage),
              "commit_notes": [c.note for c in evo.lineage.commits],
              "commit_gains_paired": gains, "floor": evo.operator.policy.min_rel,
              "agent": type(evo.operator.policy).__name__, **paired,
              "s_per_paid_eval": wall / scorer.n_evaluations,
              "paid_evals_to_pipelined": reached, "pipelined_tflops": pipelined,
              "launches": launches, "launches_by_body": by_body,
              "launches_per_eval": launches / scorer.n_evaluations,
              "wall_s": wall, "best_tflops": best.geomean,
              "best_values": list(best.values), "best_genome": best.genome.kernel_kwargs()})
        if plan == "h100":
            rows = figure_rows("evolve", scorer, {"evolved": best.values,
                                                  "seed": evo.lineage.commits[0].values})
            state.update(launches=launches, best=best.genome, evolve_by_body=by_body,
                         per_eval=launches / scorer.n_evaluations, fig3=rows,
                         evolve_s_per_eval=wall / scorer.n_evaluations)
        else:
            state.update(tpu_plan_launches=launches, model_checks_s=state.get(
                "model_checks_s", 0.0) + t_ref + wall)
        evo.close()
        del evo, scorer
        torch.cuda.empty_cache()
    emit({"phase": "evolve", "planning_ab": True, "gate": False, **{
        f"{plan}_{k}": v for plan, row in plans.items() for k, v in row.items()}})
    state["planning_ab"] = plans


def _draw(n, seed):
    """``n`` genomes drawn as the rank phase draws its sample: fp32
    accumulators, ``numpy.random.default_rng(seed).choice``."""
    import numpy as np

    from repro_torch.core.search_space import full_space
    space = [g for g in full_space() if g.acc_dtype == "f32"]
    rng = np.random.default_rng(seed)
    return [space[i] for i in rng.choice(len(space), n, replace=False)]


def _spans_disjoint(snapshots: dict, phase: str = "backends") -> dict:
    """Every held card-lock section of every process, per card: sorted by
    start, each must begin after the one before it ended."""
    per_card: dict = {}
    for who, st in snapshots.items():
        for uuid, rec in st["card_locks"].items():
            per_card.setdefault(uuid, []).extend((a, b, who) for a, b in rec["spans"])
    out = {}
    for uuid, spans in per_card.items():
        spans.sort()
        overlaps = [(p[2], q[2], p[1] - q[0]) for p, q in zip(spans, spans[1:])
                    if q[0] < p[1]]
        out[uuid] = {"spans": len(spans), "processes": len({w for *_, w in spans}),
                     "overlaps": len(overlaps), "first_overlaps": overlaps[:3]}
        if overlaps:
            raise AssertionError(f"{phase}: {len(overlaps)} locked sections overlap "
                                 f"on card {uuid}: {overlaps[:3]}")
    return out


def _worker_lines(pool, snapshots: dict) -> None:
    """One line per worker of ``pool``: lock waits, sections, peak device
    memory and flash_attention launches by body, all counted in the worker."""
    for pid, st in snapshots.items():
        locks = list(st["card_locks"].values())
        emit({"phase": "backends", "pool": pool, "worker_pid": pid,
              "lock_wait_s": sum(r["wait_s"] for r in locks),
              "locked_sections": sum(r["sections"] for r in locks),
              "peak_memory_gib": (st["peak_memory_bytes"] or 0) / 2**30,
              "launches": st["launches"], "launches_by_body": st["launches_by_body"]})


def _launched_in_workers(pool, snapshots: dict) -> None:
    for pid, st in snapshots.items():
        by_body = st["launches_by_body"]
        if st["launches"] <= 0 or by_body["fp32"] <= 0 or by_body["wgmma"] <= 0:
            raise AssertionError(f"backends: {pool} worker {pid} did not launch "
                                 f"flash_attention on both bodies: {by_body}")


def phase_backends(state):
    """The evaluation backends on the card: a slate of 8 genomes through
    the process and service backends (POOL_WORKERS spawned workers each)
    against inline; the card lock's sections disjoint across every process;
    the kernel launched in the workers; the measured evolution through the
    process backend; a service worker killed with a slate in flight; the
    elastic pool grown and shrunk."""
    import torch

    from repro_torch.core.evals import (MEASURED, MEASURED_CALL_SPREAD,
                                        ElasticProcessPool, EvalSpec,
                                        ProcessBackend, Scorer, make_backend)
    from repro_torch.core.evals.worker import worker_stats
    from repro_torch.core.evolution import ContinuousEvolution
    from repro_torch.core.perfmodel import mha_suite
    from repro_torch.core.search_space import seed_genome

    suite = mha_suite()
    slate = [seed_genome(), pipelined_genome()]
    slate += [g for g in _draw(SLATE_DRAWN, RANK_SEED) if g not in slate]
    extra = [g for g in _draw(2 * REQUEUE_SLATE, RANK_SEED + 1)
             if g not in slate][:REQUEUE_SLATE]
    spec = EvalSpec.resolve(suite, fidelity=MEASURED)
    snapshots: dict = {}          # process -> its latest worker_stats()
    launches: dict = {}           # pool -> flash_attention launches in its workers

    # 1. the slate inline, in this process
    inline = Scorer(suite=suite, fidelity=MEASURED)
    inline.warm()
    want = [inline(g) for g in slate]
    verdicts_extra = [inline.check(g)[0] for g in extra]
    pipelined = state.get("pipelined_tflops", want[1].geomean)
    del inline
    torch.cuda.empty_cache()

    got, timing = {}, {}
    for name in ("process", "service"):
        t0 = time.perf_counter()
        b = make_backend(name, suite=spec, **{
            "max_workers" if name == "process" else "workers": POOL_WORKERS})
        try:
            t1 = time.perf_counter()
            stats = (b.worker_stats() if name == "process"
                     else b.coordinator.worker_stats(timeout=120))
            if len(stats) != POOL_WORKERS:
                raise AssertionError(f"backends: {len(stats)} of {POOL_WORKERS} "
                                     f"{name} workers answered")
            t2 = time.perf_counter()
            got[name] = b.map(slate)
            t3 = time.perf_counter()
            stats = (b.worker_stats() if name == "process"
                     else b.coordinator.worker_stats(timeout=60))
            snapshots.update({f"{name}:{st['pid']}": st for st in stats.values()})
            _worker_lines(name, {st["pid"]: st for st in stats.values()})
            _launched_in_workers(name, {st["pid"]: st for st in stats.values()})
            launches[name] = stats
            # a process pool answers once its initializer has warmed the
            # scorer; a service worker answers while it warms in the
            # background, so its warm-up lands in the slate's seconds
            timing[name] = {"start_s": t1 - t0, "first_reply_s": t2 - t1,
                            "slate_s": t3 - t2}
            if name == "service":
                # 5. requeue on the card: SIGKILL one worker with a slate in flight
                futs = b.submit_many(extra)
                time.sleep(0.6)
                b._procs[0].kill()
                requeued = [f.result(300) for f in futs]
                if [sv.correct for sv in requeued] != verdicts_extra:
                    raise AssertionError("backends: verdicts after the requeue differ "
                                         "from inline's")
                st = b.coordinator.stats()
                events = [e for e in st["events"] if e["event"] in ("leave", "requeue")]
                emit({"phase": "backends", "check": "requeue", "genomes": len(extra),
                      "tasks_requeued": st["tasks_requeued"], "workers_left": st["workers"],
                      "events": events,
                      "geomeans": [sv.geomean for sv in requeued]})
                if st["tasks_requeued"] < 1 or not any(e["event"] == "requeue"
                                                       for e in events):
                    raise AssertionError(f"backends: no requeue after the kill: {events}")
                for s2 in b.coordinator.worker_stats(timeout=60).values():
                    snapshots[f"service:{s2['pid']}"] = s2
        finally:
            b.close()
    for i, g in enumerate(slate):
        row = {"phase": "backends", "genome": g.kernel_kwargs(),
               "inline_tflops": want[i].geomean,
               "process_tflops": got["process"][i].geomean,
               "service_tflops": got["service"][i].geomean,
               "verdicts": [want[i].correct, got["process"][i].correct,
                            got["service"][i].correct]}
        emit(row)
        if not (want[i].correct == got["process"][i].correct == got["service"][i].correct):
            raise AssertionError(f"backends: gate verdicts differ: {row}")
        for name in ("process", "service"):      # scorings of different calls
            rel = got[name][i].geomean / want[i].geomean - 1.0
            if abs(rel) > MEASURED_CALL_SPREAD:
                raise AssertionError(f"backends: {name} geomean {rel:+.2%} off inline's "
                                     f"for {g}: over the call spread {MEASURED_CALL_SPREAD}")

    # 4. the measured evolution through the process backend
    t0 = time.perf_counter()
    evo = ContinuousEvolution(fidelity=MEASURED, eval_backend="process",
                              workers=POOL_WORKERS)
    try:
        t1 = time.perf_counter()
        evo.scorer.worker_stats()               # every worker up and warm
        t2 = time.perf_counter()
        target = pipelined * (1.0 - MEASURED_CALL_SPREAD)
        step, wall, reached = _drive(evo, "backends", EVOLVE_EVALS, target=target,
                                     backend="process")
        agent = evo.operator.policy
        gains = check_commits(evo.lineage, "backends", agent.decisions)
        stats = evo.scorer.worker_stats()
        snapshots.update({f"evolve:{pid}": st for pid, st in stats.items()})
        launches["evolve"] = stats
        _worker_lines("evolve", stats)
        paid = evo.scorer.n_evaluations
        emit({"phase": "backends", "check": "evolution", "backend": "process",
              "workers": POOL_WORKERS, "spawn_s": t1 - t0, "warm_s": t2 - t1,
              "steady_s": wall, "steps": step, "paid_evals": paid,
              "s_per_eval": wall / paid, "inline_s_per_eval": state.get("evolve_s_per_eval"),
              "paid_evals_to_pipelined": reached, "pipelined_tflops": pipelined,
              "commits": len(evo.lineage), "commit_gains_paired": gains,
              "agent": type(agent).__name__, "own_timer": agent._timer is not None,
              **paired_summary(agent), "best_tflops": evo.lineage.best().geomean})
        state["backends_evolution"] = {"s_per_eval": wall / paid, "reached": reached}
        # the pooled backend's yardsticks: a scorer built in this process on
        # first use, timing SDPA under the card lock
        base = evo.scorer.baselines()
        refused = [c.name for c, v in zip(suite, base["expert"]) if v is None]
        emit({"phase": "backends", "check": "baselines", "backend": "process",
              "cudnn_tflops": base["expert"], "flash_tflops": base["fa_reference"],
              "refused": refused})
        if refused or not all(v and v > 0 for v in base["fa_reference"]):
            raise AssertionError(f"backends: baselines refused on {refused}")
    finally:
        evo.close()

    # 6. the elastic pool on the card: rung 0 (H100 model) behind the gate,
    # held open by a modelled latency so the queue builds up
    espec = EvalSpec.resolve(suite, machine="h100", service_latency_s=ELASTIC_LATENCY_S)
    pool = ElasticProcessPool((espec,), min_workers=1, max_workers=POOL_WORKERS,
                              grow_depth=1.0, hysteresis=1, shrink_idle_s=ELASTIC_IDLE_S)
    backend = ProcessBackend(spec=espec, executor=pool)
    try:
        t0 = time.perf_counter()
        els = [f.result(300) for f in [backend.submit(g) for g in slate[2:]]]
        burst_s = time.perf_counter() - t0
        stats = backend.worker_stats()
        snapshots.update({f"elastic:{pid}": st for pid, st in stats.items()})
        launches["elastic"] = stats
        ref = Scorer(suite=suite, machine="h100")
        if [sv.values for sv in els] != [ref(g).values for g in slate[2:]]:
            raise AssertionError("backends: the elastic pool's rung-0 values differ "
                                 "from inline's")
        deadline = time.monotonic() + 60
        while pool.n_workers > 1 and time.monotonic() < deadline:
            time.sleep(ELASTIC_IDLE_S + 0.2)
            pool.submit(worker_stats).result(60)
        st = pool.stats()
        emit({"phase": "backends", "check": "elastic", "start": "spawn",
              "grown": st["grown"], "shrunk": st["shrunk"],
              "peak_workers": st["peak_workers"], "workers": st["workers"],
              "burst_s": burst_s, "resize_events": st["resize_events"]})
        if not (st["grown"] >= 1 and st["peak_workers"] == POOL_WORKERS
                and st["shrunk"] >= 1 and st["workers"] == 1):
            raise AssertionError(f"backends: the elastic pool did not grow to "
                                 f"{POOL_WORKERS} and shrink back: {st}")
    finally:
        backend.close()
        pool.shutdown(wait=True, cancel_futures=True)

    # 2. one timer per card: no two locked sections of any process overlap
    from repro_torch.device import card_lock_stats
    snapshots["parent"] = {"card_locks": card_lock_stats()}
    cards = _spans_disjoint(snapshots)
    emit({"phase": "backends", "check": "lock_spans", "cards": cards})
    by_body: dict = {}
    total = 0
    for stats in launches.values():
        for st in stats.values():
            total += st["launches"]
            for k, v in st["launches_by_body"].items():
                by_body[k] = by_body.get(k, 0) + v
    emit({"phase": "backends", "summary": True, "timing": timing,
          "worker_launches": total, "worker_launches_by_body": by_body,
          "s_per_eval_process": state["backends_evolution"]["s_per_eval"],
          "s_per_eval_inline": state.get("evolve_s_per_eval")})
    state.update(backends_launches=total, backends_by_body=by_body)


def _island_engine(device=None, on_commit=None, **kw):
    """The phase's archipelago: ``scenario_specs()`` (mha, gqa, decode,
    mha-explorer at the suites' full shapes), seed 0, migration every
    ISLAND_INTERVAL steps, rung 0 on the H100 model."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.islands import IslandEvolution, scenario_specs
    return IslandEvolution(config=EngineConfig.from_kwargs(
        specs=scenario_specs(), seed=0, migration_interval=ISLAND_INTERVAL,
        machine="h100", device=device, **kw), on_commit=on_commit)


def _island_prints(eng) -> tuple:
    """Per-island lineage fingerprints and the migration ledger."""
    return ({i.name: [(c.genome.key(), round(c.geomean, 9), c.note)
                      for c in i.lineage.commits] for i in eng.islands},
            eng.migration_stats.to_payload(), eng.migrations_accepted)


def _island_steps(eng, steps, **tags) -> tuple:
    """Run ``eng`` for ``steps`` steps per island; one line per island.
    Returns (report, wall seconds)."""
    t0 = time.perf_counter()
    rep = eng.run(max_steps=steps)
    wall = time.perf_counter() - t0
    for name, r in rep.islands.items():
        emit({"phase": "islands", **tags, "island": name, "commits": r.commits,
              "steps": r.steps, "best_tflops_model": r.best_geomean})
    return rep, wall


def _lock_delta(before: dict, after: dict, since: float) -> dict:
    """This process's card-lock waits and held sections between two
    ``card_lock_stats()`` snapshots; the sections held since ``since``
    (``time.monotonic()``): seconds in all, the longest, the first."""
    out = {"wait_s": 0.0, "sections": 0}
    held = []
    for uuid, rec in after.items():
        prev = before.get(uuid, {"wait_s": 0.0, "sections": 0})
        out["wait_s"] += rec["wait_s"] - prev["wait_s"]
        out["sections"] += rec["sections"] - prev["sections"]
        held += sorted((a, b - a) for a, b in rec["spans"] if a >= since)
    out.update(held_s=sum(d for _, d in held),
               longest_held_s=max((d for _, d in held), default=0.0),
               first_held_s=held[0][1] if held else None)
    return out


def _coverage_timeline(events, suite_of, union) -> list:
    """(seconds, coverage geomean, paid evaluations) after each commit
    event of an island run, replayed as ``bench_islands.py`` does: each
    config under the best island targeting its suite; 0 until every config
    of ``union`` is covered."""
    import math
    best: dict = {}
    out = []
    for t, island, gm, values, paid in sorted(events):
        best[island] = (gm, values)
        per_suite: dict = {}
        for name, (g, vals) in best.items():
            key = suite_of[name]
            if key not in per_suite or g > per_suite[key][0]:
                per_suite[key] = (g, vals)
        covered = {c: v for key, (_, vals) in per_suite.items()
                   for c, v in zip(key, vals)}
        cov = 0.0
        if set(covered) == union and all(v > 0 for v in covered.values()):
            cov = math.exp(sum(math.log(v) for v in covered.values()) / len(covered))
        out.append((t, cov, paid))
    return out


def phase_islands(state):
    """The island engine on the card (rung 0, H100 model, scenario_specs()):
    card against CPU, resume identity, pipelined stepping on spawned
    workers, a measured reading of each island's best genome, and a race
    against the serial loop to one coverage target."""
    import shutil

    import torch

    from repro_torch.core.evals import MEASURED, Scorer
    from repro_torch.core.evals.scorer import _CHECK_MEMO
    from repro_torch.core.evolution import ContinuousEvolution
    from repro_torch.core.islands import IslandEvolution
    from repro_torch.core.perfmodel import suite_by_name
    from repro_torch.device import card_lock_stats
    from repro_torch.kernels.flash_attention import flash_attention

    # 1. the card against the CPU, in this process, through the thread backend
    launches: dict = {}
    reset_counts(flash_attention)
    locks0, since = card_lock_stats(), time.monotonic()
    card = _island_engine()
    try:
        rep, wall = _island_steps(card, ISLAND_STEPS, run="card")
    finally:
        card.close()
    locks1 = card_lock_stats()
    card_by_body = dict(flash_attention.launches_by_body)
    launches["card"] = flash_attention.launches
    reset_counts(flash_attention)
    cpu = _island_engine("cpu")
    try:
        _, wall_cpu = _island_steps(cpu, ISLAND_STEPS, run="cpu")
    finally:
        cpu.close()
    cpu_launches = flash_attention.launches
    want = _island_prints(card)
    spans = _spans_disjoint({"parent": {"card_locks": locks1}}, "islands")
    emit({"phase": "islands", "check": "card_vs_cpu", "equal": want == _island_prints(cpu),
          "card_s": wall, "cpu_s": wall_cpu, "paid_evals": rep.evaluations,
          "cache_hits": rep.cache_hits, "commits": rep.commits,
          "migrations_accepted": rep.migrations_accepted,
          "migration_edges": {f"{card.islands[s].name}->{card.islands[d].name}":
                              [st.accepts, st.attempts]
                              for (s, d), st in sorted(card.migration_stats.edges.items())},
          "coverage_tflops_model": rep.coverage_geomean,
          "launches": launches["card"], "launches_by_body": card_by_body,
          "cpu_launches": cpu_launches, "card_lock": _lock_delta(locks0, locks1, since),
          "lock_spans": spans})
    if want != _island_prints(cpu):
        raise AssertionError("islands: the card's lineages differ from the CPU's")
    if card_by_body["fp32"] <= 0 or cpu_launches:
        raise AssertionError(f"islands: gate launches card {card_by_body}, cpu {cpu_launches}")

    # 2. killed after ISLAND_RESUME_AT steps, resumed from its file, finished
    root = os.path.join(HERE, "results", "chip_smoke_islands")
    shutil.rmtree(root, ignore_errors=True)
    path = os.path.join(root, "archipelago.json")
    reset_counts(flash_attention)
    t0 = time.perf_counter()
    first = _island_engine(persist_path=path)
    try:
        _island_steps(first, ISLAND_RESUME_AT, run="before_kill")
    finally:
        first.close()
    with open(path) as f:
        machine = json.load(f)["machine"]
    resumed = IslandEvolution.resume(path)
    try:
        _island_steps(resumed, ISLAND_STEPS - ISLAND_RESUME_AT, run="resumed")
    finally:
        resumed.close()
    launches["resume"] = flash_attention.launches
    same = _island_prints(resumed) == want
    emit({"phase": "islands", "check": "resume", "equal": same, "machine": machine,
          "topology_state": resumed.topology.state(), "wall_s": time.perf_counter() - t0,
          "launches": launches["resume"]})
    if not same or machine != "h100":
        raise AssertionError("islands: the resumed run differs from the uninterrupted one")

    # 3. pipelined stepping on the process backend, POOL_WORKERS spawned workers
    reset_counts(flash_attention)
    t0 = time.perf_counter()
    piped = _island_engine(backend="process", max_workers=POOL_WORKERS, pipeline=True,
                           prefetch_budget=ISLAND_PREFETCH_BUDGET)
    try:
        piped.prewarm_eval_pool()
        t1 = time.perf_counter()
        rep3, wall3 = _island_steps(piped, ISLAND_STEPS, run="pipelined_process")
        stats = next(iter(piped.scorers.values())).worker_stats()
    finally:
        piped.close()
    launches["parent_pipelined"] = flash_attention.launches
    snapshots = {f"islands:{pid}": st for pid, st in stats.items()}
    snapshots["parent"] = {"card_locks": card_lock_stats()}
    spans = _spans_disjoint(snapshots, "islands")
    for pid, st in stats.items():
        locks = list(st["card_locks"].values())
        emit({"phase": "islands", "pool": "process", "worker_pid": pid,
              "lock_wait_s": sum(r["wait_s"] for r in locks),
              "locked_sections": sum(r["sections"] for r in locks),
              "peak_memory_gib": (st["peak_memory_bytes"] or 0) / 2**30,
              "launches": st["launches"], "launches_by_body": st["launches_by_body"]})
    worker_launches = sum(st["launches"] for st in stats.values())
    worker_by_body: dict = {}
    for st in stats.values():
        for k, v in st["launches_by_body"].items():
            worker_by_body[k] = worker_by_body.get(k, 0) + v
    same = _island_prints(piped) == want
    emit({"phase": "islands", "check": "pipelined_process", "equal": same,
          "workers": len(stats), "spawn_warm_s": t1 - t0, "steps_s": wall3,
          "paid_evals": rep3.evaluations, "proposed": rep3.proposed,
          "prefetch_caps": [isl.prefetch_k for isl in piped.islands],
          "worker_launches": worker_launches, "worker_launches_by_body": worker_by_body,
          "parent_launches": launches["parent_pipelined"], "lock_spans": spans})
    if not same:
        raise AssertionError("islands: pipelined process-pool lineages differ from step 1's")
    if len(stats) != POOL_WORKERS or worker_by_body.get("fp32", 0) <= 0 \
            or rep3.proposed <= 0:
        raise AssertionError(f"islands: {len(stats)} workers, launches {worker_by_body}, "
                             f"{rep3.proposed} proposals")

    # 4. a reading: each island's best genome once at the measured rung on its
    # own suite, beside cuDNN and flash, and the pipelined genome on mha_suite
    reset_counts(flash_attention)
    t0 = time.perf_counter()
    by_suite: dict = {}
    for isl, spec in zip(card.islands, card.specs):
        by_suite.setdefault(spec.target_suite, []).append((isl.name, isl.lineage.best().genome))
    by_suite["mha"].append(("pipelined", pipelined_genome()))
    reading = {}
    for suite_name, entries in by_suite.items():
        scorer = Scorer(suite=suite_by_name(suite_name), fidelity=MEASURED)
        for cfg in scorer.suite:
            scorer.full_inputs(cfg)
        columns = {}
        for name, genome in entries:
            sv = scorer(genome)
            if not (sv.correct and all(v > 0 and v == v and v != float("inf")
                                       for v in sv.values)):
                raise AssertionError(f"islands: {name}'s best on {suite_name}: "
                                     f"{sv.failure} {sv.values}")
            columns[name] = list(sv.values)
            reading[name] = {"suite": suite_name, "geomean_tflops": sv.geomean,
                             "genome": genome.kernel_kwargs()}
        figure_rows("islands", scorer, columns)
        del scorer
        torch.cuda.empty_cache()
    launches["measured"] = flash_attention.launches
    by_body4 = dict(flash_attention.launches_by_body)
    emit({"phase": "islands", "check": "measured_reading", "reading": reading,
          "launches": launches["measured"], "launches_by_body": by_body4,
          "wall_s": time.perf_counter() - t0})
    if by_body4["wgmma"] <= 0:
        raise AssertionError(f"islands: the reading never took the wgmma body: {by_body4}")

    # 5. the race: the four islands and the serial loop to one coverage target
    reset_counts(flash_attention)
    union = "mha+gqa+decode"
    _CHECK_MEMO.clear()                # each side pays its own gates
    evo = ContinuousEvolution(target_suite=union, machine="h100")
    serial = []
    t_serial = time.perf_counter()

    def on_serial_commit(island):
        serial.append((time.perf_counter() - t_serial, island.lineage.best().geomean,
                       evo.scorer.n_evaluations))
    evo.island.on_commit = on_serial_commit
    evo.run(max_steps=RACE_SERIAL_STEPS)
    serial_wall = time.perf_counter() - t_serial
    evo.close()
    target = max((c for _, c, _ in serial), default=0.0)

    _CHECK_MEMO.clear()
    events = []

    def on_island_commit(ev):
        events.append((ev["t"], ev["island"], ev["geomean"], ev["values"],
                       sum(s.n_evaluations for s in race.scorers.values())))
    race = _island_engine(on_commit=on_island_commit)
    union_cfgs = {c.name for c in suite_by_name(union)}
    suite_of = {i.name: tuple(c.name for c in i.scorer.suite) for i in race.islands}
    try:
        rep5, race_wall = _island_steps(race, RACE_ISLAND_STEPS, run="race")
    finally:
        race.close()
    launches["race"] = flash_attention.launches
    timeline = _coverage_timeline(events, suite_of, union_cfgs)
    hit_s = next(((t, p) for t, c, p in serial if c >= target), (None, None))
    hit_i = next(((t, p) for t, c, p in timeline if c >= target), (None, None))
    emit({"phase": "islands", "check": "race", "target_coverage_tflops_model": target,
          "serial": {"seconds_to_target": hit_s[0], "paid_evals_to_target": hit_s[1],
                     "wall_s": serial_wall, "steps": RACE_SERIAL_STEPS,
                     "paid_evals": evo.scorer.n_evaluations, "commits": len(evo.lineage)},
          "islands": {"seconds_to_target": hit_i[0], "paid_evals_to_target": hit_i[1],
                      "wall_s": race_wall, "steps_per_island": RACE_ISLAND_STEPS,
                      "paid_evals": rep5.evaluations, "commits": rep5.commits,
                      "final_coverage_tflops_model": max((c for _, c, _ in timeline),
                                                         default=0.0)},
          "launches": launches["race"]})
    total = sum(launches.values())
    by_path = dict(launches, workers_pipelined=worker_launches)
    emit({"phase": "islands", "summary": True, "launches": total,
          "worker_launches": worker_launches, "launches_by_path": by_path})
    state.update(islands_launches=total, islands_worker_launches=worker_launches,
                 islands_by_body={"card": card_by_body, "workers": worker_by_body,
                                  "measured": by_body4})


def launch_seconds(n: int = LAUNCH_REPS) -> float:
    """Seconds per launch of flash_attention's fp32 body at its smallest
    shape, (1, 1, 16, 64), ``n`` back to back through the wrapper (CUDA
    events): rung 1's launch overhead as this port issues a launch."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(1, 1, 16, 64, device="cuda")
    for _ in range(10):
        flash_attention(q, q, q, block_q=16, block_k=16)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        flash_attention(q, q, q, block_q=16, block_k=16)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / n


def _inversions(pred, meas) -> int:
    """Pairwise order disagreements of two rankings."""
    import itertools
    return sum(1 for i, j in itertools.combinations(range(len(pred)), 2)
               if (pred[i] - pred[j]) * (meas[i] - meas[j]) < 0)


def phase_cascade(state):
    """The evaluation cascade through the island engine on the card: the
    islands phase's archipelago with cascade_eta=3 and slates of up to
    1 + 8 genomes, rung 0 on the H100 model with every gate on the fp32
    kernel, rung 1 traced on the meta device, rung 2 timed on the wgmma
    body, thread backend.  Six gates (see the module docstring); the rank
    inversions of rung 0 against rung 2, before and after calibration, are
    printed and not gated."""
    import json as _json
    import shutil

    import torch

    from repro_torch.core.evals import (FIDELITIES, HLO, MEASURED, PERFMODEL,
                                        Scorer, make_backend)
    from repro_torch.core.evals.scorer import _CHECK_MEMO, _TRACE_MEMO, LAUNCH_S
    from repro_torch.core.islands import IslandEvolution
    from repro_torch.core.perfmodel import PerfModelCalibration, mha_suite
    from repro_torch.core.search_space import KernelGenome
    from repro_torch.device import card_lock_stats
    from repro_torch.kernels.flash_attention import flash_attention

    _TRACE_MEMO.clear()                # rung 1 pays its traces in this phase
    launch_s = launch_seconds()
    emit({"phase": "cascade", "launch_overhead_s": launch_s, "launch_s_in_force": LAUNCH_S,
          "launches_timed": LAUNCH_REPS, "shape": [1, 1, 16, 64], "body": "fp32"})
    eta, slate = CASCADE_ETA, CASCADE_SLATE

    def run(steps=ISLAND_STEPS, **kw):
        eng = _island_engine(**kw)
        try:
            rep = eng.run(max_steps=steps)
        finally:
            eng.close()
        return eng, rep

    # 1. lineages: the cascade off, promotion off, promotion on
    t0 = time.perf_counter()
    off, _ = run()
    quiet, _ = run(cascade_eta=eta, cascade_slate=slate, cascade_promote=False)
    locks0, since = card_lock_stats(), time.monotonic()
    _CHECK_MEMO.clear()                # the promoting run pays its own gates
    reset_counts(flash_attention)
    t1 = time.perf_counter()
    on, rep = run(cascade_eta=eta, cascade_slate=slate)
    wall_on = time.perf_counter() - t1
    launches, by_body = flash_attention.launches, dict(flash_attention.launches_by_body)
    spans = _spans_disjoint({"parent": {"card_locks": card_lock_stats()}}, "cascade")
    want = _island_prints(off)
    same = {"promotion_off": _island_prints(quiet) == want, "promotion_on": _island_prints(on) == want}
    totals = on.cascade_totals()
    emit({"phase": "cascade", "check": "lineages", "equal": same, "eta": eta,
          "cascade_slate": slate, "steps": ISLAND_STEPS, "wall_s_promoting": wall_on,
          "wall_s_all_three": time.perf_counter() - t0, "totals": totals,
          "commits": rep.commits, "paid_evals_rung0": rep.evaluations,
          "launches": launches, "launches_by_body": by_body,
          "card_lock": _lock_delta(locks0, card_lock_stats(), since), "lock_spans": spans})
    for entry in on.cascade_log:
        emit({"phase": "cascade", "log": True, **{k: entry[k] for k in (
            "epoch", "island", "slate", "evals", "promoted")}})
    if not all(same.values()):
        raise AssertionError(f"cascade: lineages differ from the cascade-free run: {same}")

    # 2. promote fractions: every logged pass, and one full 9-genome slate
    rates_ok = bool(on.cascade_log)
    for entry in on.cascade_log:
        n0, n1, n2 = (entry["evals"][f] for f in FIDELITIES)
        rates_ok = rates_ok and n1 <= max(1, n0 // eta) and n2 <= max(1, n1 // eta)
    full = make_backend("cascade", suite="mha", machine="h100", eta=eta)
    try:
        t2 = time.perf_counter()
        log9 = full.run_cascade(_draw(eta * eta, CASCADE_SEED))
        full_s = time.perf_counter() - t2
    finally:
        full.close()
    r1, r2 = log9["evals"][HLO] / log9["slate"], log9["evals"][MEASURED] / log9["slate"]
    emit({"phase": "cascade", "check": "promote_fractions", "engine_ok": rates_ok,
          "full_slate": log9["slate"], "full_evals": log9["evals"], "rung1_fraction": r1,
          "rung2_fraction": r2, "full_wall_s": full_s})
    if not (rates_ok and log9["slate"] == eta * eta and r1 <= 1 / eta and r2 <= 1 / eta ** 2):
        raise AssertionError(f"cascade: promote fractions broken: {log9['evals']}")

    # 3. cost: the cascade's card seconds per rung against the whole slate
    # flat at rung 2.  Rungs 0 and 2 hold the card for their seconds (every
    # rung-0 second of the run counted, stepping included); rung 1 runs no
    # kernel, so its seconds are the host's, printed beside and not gated
    suite_of = {i.name: sp.target_suite for i, sp in zip(on.islands, on.specs)}
    n0 = {key: 0 for key in on.cascades}
    for entry in on.cascade_log:
        n0[suite_of[entry["island"]]] += entry["evals"][PERFMODEL]
    per_rung = dict.fromkeys(FIDELITIES, 0.0)
    flat = 0.0
    for key, casc in on.cascades.items():
        st = casc.cache.stats()
        for fid, sec in st["eval_seconds"].items():
            per_rung[fid] += sec
        paid2 = st["per_fidelity"].get(MEASURED, 0)
        if paid2:
            flat += n0[key] * st["eval_seconds"][MEASURED] / paid2
    cost = per_rung[PERFMODEL] + per_rung[MEASURED]
    emit({"phase": "cascade", "check": "cost", "seconds_per_rung": per_rung,
          "card_s": cost, "flat_rung2_s": flat, "rung1_host_s": per_rung[HLO],
          "with_rung1_host_s": cost + per_rung[HLO], "slate_evals_rung0": n0,
          "paid_per_rung": {k: c.cache.stats()["per_fidelity"] for k, c in on.cascades.items()}})
    if not 0 < cost < flat:
        raise AssertionError(f"cascade: {cost} card s against {flat} s flat at rung 2")

    # 4. rung 1 on the card equals rung 1 on the CPU, traced anew
    checked = 0
    _TRACE_MEMO.clear()
    for key, casc in on.cascades.items():
        rung1 = casc.rungs[1]
        cpu = Scorer(suite=rung1.suite, check_correctness=False, fidelity=HLO,
                     device="cpu", machine="h100")
        keys = {g for e in on.cascade_log if suite_of[e["island"]] == key
                for g in e["promoted"][HLO]}
        for gk in sorted(keys):
            g = KernelGenome.from_dict(_json.loads(gk))
            if rung1.cache.peek(rung1.score_key(g)).values != cpu(g).values:
                raise AssertionError(f"cascade: rung 1 of {gk} on {key} differs card / cpu")
            checked += 1
    emit({"phase": "cascade", "check": "rung1_card_vs_cpu", "equal": True, "genomes": checked})

    # 5. rung 2 on the wgmma body; lock sections disjoint (checked above)
    if by_body["wgmma"] <= 0 or by_body["fp32"] <= 0 or totals["evals"][MEASURED] <= 0:
        raise AssertionError(f"cascade: launches {by_body}, totals {totals}")

    # the calibration's effect, not gated: rung 0 against rung 2 over every
    # genome the run timed, raw and with the run's final factors
    rows = []
    for key, casc in on.cascades.items():
        rung0, rung1, rung2 = casc.rungs
        for gk in sorted({g for e in on.cascade_log if suite_of[e["island"]] == key
                          for g in e["promoted"][MEASURED]}):
            g = KernelGenome.from_dict(_json.loads(gk))
            sv0, sv2 = rung0.cache.peek(rung0.score_key(g)), rung2.cache.peek(rung2.score_key(g))
            sv1 = rung1.cache.peek(rung1.score_key(g))
            rows.append((key, sv0.geomean, sv2.geomean, sv0.dominant_bottleneck(),
                         sv1.geomean))
    cal = PerfModelCalibration()
    cal.load_state(totals["calibration"])
    raw = [a for _, a, _, _, _ in rows]
    meas = [b for _, _, b, _, _ in rows]
    emit({"phase": "cascade", "calibration": True, "gate": False, "timed_genomes": len(rows),
          "factors": cal.factors, "observations": cal.observations,
          "inversions_raw": _inversions(raw, meas),
          "inversions_calibrated": _inversions([cal.corrected(d, a) for _, a, _, d, _ in rows],
                                               meas),
          "inversions_rung1": _inversions([r for *_, r in rows], meas),
          "pairs": len(rows) * (len(rows) - 1) // 2,
          "rows": [{"suite": k, "rung0": a, "rung2": b, "class": d, "rung1": r}
                   for k, a, b, d, r in rows]})

    # 6. killed after ISLAND_RESUME_AT steps, resumed from its file; the
    # engines above and their full-shape inputs freed first
    promotions = [e["promoted"] for e in on.cascade_log]
    del off, quiet, on, full
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "cascade", "device_memory_gib": {"free": free / 2**30, "total": total / 2**30,
          "allocated": torch.cuda.memory_allocated() / 2**30,
          "reserved": torch.cuda.memory_reserved() / 2**30}})
    root = os.path.join(HERE, "results", "chip_smoke_cascade")
    shutil.rmtree(root, ignore_errors=True)
    path = os.path.join(root, "archipelago.json")
    t3 = time.perf_counter()
    run(ISLAND_RESUME_AT, cascade_eta=eta, cascade_slate=slate, persist_path=path)
    with open(path) as f:
        at_kill = _json.load(f)["cascade"]
    resumed = IslandEvolution.resume(path)
    try:
        adopted = (resumed.calibration.state() == at_kill["calibration"]
                   and resumed.cascade_log == at_kill["log"])
        resumed.run(max_steps=ISLAND_STEPS - ISLAND_RESUME_AT)
    finally:
        resumed.close()
    same = _island_prints(resumed) == want
    emit({"phase": "cascade", "check": "resume", "equal": same, "adopted": adopted,
          "calibration_at_kill": at_kill["calibration"], "log_at_kill": len(at_kill["log"]),
          "promotions_equal_uninterrupted": [
              e["promoted"] for e in resumed.cascade_log] == promotions,
          "wall_s": time.perf_counter() - t3})
    if not (same and adopted):
        raise AssertionError("cascade: the resumed run differs from the uninterrupted one")
    state.update(cascade_launches=launches, cascade_by_body=by_body, cascade=totals)


def _fleet_launches(snapshots: dict) -> tuple:
    """flash_attention launches counted in the workers: (total, by body)."""
    total, by_body = 0, {}
    for st in snapshots.values():
        total += st["launches"]
        for k, v in st["launches_by_body"].items():
            by_body[k] = by_body.get(k, 0) + v
    return total, by_body


def phase_frontier(state):
    """The search frontier on the card: one SearchFrontier of POOL_WORKERS
    spawned workers; two jobs of priority FRONTIER_PRIORITIES, equal budgets,
    the same seed, rung 0 on the H100 model and every gate on the fp32
    kernel in a worker; the first submitted in process, the second over
    the wire through FrontierClient, its events streamed.  Both must reach
    done with the fingerprint of the same seed through
    IslandEvolution(backend="service") on the card, every process's
    card-lock sections must be disjoint, and the workers must launch the
    fp32 body."""
    import threading

    from repro_torch.core import (EngineConfig, EvalConfig, FrontierClient,
                                  IslandEvolution, MigrationConfig, SearchFrontier,
                                  SearchJob, lineage_fingerprint)
    from repro_torch.core.perfmodel import suite_by_name
    from repro_torch.device import card_lock_stats

    job = dict(suite=FRONTIER_SUITE, budget=FRONTIER_BUDGET, seed=FRONTIER_SEED,
               n_islands=FRONTIER_ISLANDS,
               steps=FRONTIER_STEPS, migration_interval=2, machine="h100")
    t0 = time.perf_counter()
    frontier = SearchFrontier(workers=POOL_WORKERS)
    wire: dict = {"events": [], "error": None}

    def over_the_wire():
        try:
            with FrontierClient(frontier.address, name="wire-tenant") as client:
                wire["job"] = client.submit(SearchJob(priority=FRONTIER_PRIORITIES[1], **job))
                for ev in client.stream(wire["job"]):
                    wire["events"].append(ev)
        except Exception as e:            # reported below, after the fleet is down
            wire["error"] = repr(e)
    try:
        t1 = time.perf_counter()
        local = frontier.submit(SearchJob(priority=FRONTIER_PRIORITIES[0], **job))
        reader = threading.Thread(target=over_the_wire)
        reader.start()
        both_running, deadline = None, time.monotonic() + 600
        while reader.is_alive() or frontier.stats()["jobs"][local]["status"] in (
                "queued", "running"):
            st = frontier.stats()
            if [j["status"] for j in st["jobs"].values()] == ["running", "running"]:
                both_running = st["coordinator"]["tenants"]
            if time.monotonic() > deadline:
                raise AssertionError("frontier: the jobs did not finish in 600 s")
            time.sleep(0.05)
        reader.join(60)
        wall = time.perf_counter() - t1
        final = frontier.stats()
        snaps = frontier.coordinator.worker_stats(timeout=60)
    finally:
        frontier.close()
    if wire["error"] or not wire["events"]:
        raise AssertionError(f"frontier: the wire tenant failed: {wire['error']}")
    jobs = {"in_process": (local, frontier.job_events(local)[-1]),
            "over_the_wire": (wire["job"], wire["events"][-1])}
    kinds = [ev.kind for ev in wire["events"]]

    # the same seed through IslandEvolution(backend="service") on the card
    t2 = time.perf_counter()
    direct = IslandEvolution(config=EngineConfig(
        n_islands=FRONTIER_ISLANDS, suite=suite_by_name(FRONTIER_SUITE), seed=FRONTIER_SEED,
        evals=EvalConfig(backend="service", service_workers=POOL_WORKERS, machine="h100"),
        migration=MigrationConfig(interval=2)))
    try:
        direct.run(max_steps=FRONTIER_STEPS)
        want = json.loads(json.dumps(lineage_fingerprint(direct)))
        direct_snaps = direct.service_coordinator.worker_stats(timeout=60)
    finally:
        direct.close()
    direct_s = time.perf_counter() - t2

    snapshots = {f"frontier:{st['pid']}": st for st in snaps.values()}
    snapshots.update({f"direct:{st['pid']}": st for st in direct_snaps.values()})
    snapshots["parent"] = {"card_locks": card_lock_stats()}
    spans = _spans_disjoint(snapshots, "frontier")
    launches, by_body = _fleet_launches(snaps)
    direct_launches, direct_by_body = _fleet_launches(direct_snaps)
    tenants = final["coordinator"]["tenants"]
    for who, (jid, done) in jobs.items():
        fp = json.loads(json.dumps(done.data.get("fingerprint")))
        row = final["jobs"][jid]
        emit({"phase": "frontier", "job": who, "id": jid, "status": done.kind,
              "priority": row["priority"], "budget": row["budget"],
              "paid_evals": row["spent"], "steps": row["steps_done"],
              "best_geomean_tflops_model": row["best_geomean"],
              "granted": tenants[jid]["granted"],
              "granted_contended": tenants[jid]["granted_contended"],
              "completed": tenants[jid]["completed"],
              "while_both_running": (both_running or {}).get(jid),
              "equal_to_direct": fp == want})
        if done.kind != "done" or fp != want:
            raise AssertionError(f"frontier: the {who} job ended {done.kind}, "
                                 f"fingerprint equal to the direct run: {fp == want}")
    if kinds[:2] != ["accepted", "started"] or "progress" not in kinds:
        raise AssertionError(f"frontier: the wire stream was {kinds}")
    for pid, st in snaps.items():
        locks = list(st["card_locks"].values())
        emit({"phase": "frontier", "worker": pid,
              "lock_wait_s": sum(r["wait_s"] for r in locks),
              "locked_sections": sum(r["sections"] for r in locks),
              "launches": st["launches"], "launches_by_body": st["launches_by_body"]})
    emit({"phase": "frontier", "summary": True, "workers": len(snaps),
          "spawn_s": t1 - t0, "jobs_wall_s": wall, "direct_s": direct_s,
          "wire_events": len(kinds), "lock_spans": spans,
          "lock_wait_s": sum(r["wait_s"] for st in snaps.values()
                             for r in st["card_locks"].values()),
          "worker_launches": launches, "worker_launches_by_body": by_body,
          "direct_worker_launches": direct_launches,
          "direct_worker_launches_by_body": direct_by_body})
    if len(snaps) != POOL_WORKERS or by_body.get("fp32", 0) <= 0:
        raise AssertionError(f"frontier: {len(snaps)} workers answered, fp32 launches "
                             f"{by_body}")
    state.update(frontier_worker_launches=launches + direct_launches,
                 frontier_by_body={"frontier": by_body, "direct": direct_by_body})


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
    gains = check_commits(evo.lineage, "gqa", evo.operator.policy.decisions)
    best = evo.lineage.best()
    emit({"phase": "gqa", "summary": True, "plan": scorer.plan_machine, "steps": step,
          "paid_evals": scorer.n_evaluations, "commits": len(evo.lineage),
          "commit_notes": [c.note for c in evo.lineage.commits],
          "commit_gains_paired": gains, "floor": evo.operator.policy.min_rel,
          "agent": type(evo.operator.policy).__name__,
          **paired_summary(evo.operator.policy),
          "s_per_paid_eval": wall / scorer.n_evaluations,
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
    _encdec_times(state)


def _decode_row(q, k, v, vl, valid, library=None) -> dict:
    """flash_decode at one shape: its two bodies in turns (simt, wgmma,
    wgmma, simt), CUDA events with the L2 flushed, each as the host drives
    it (``ms``) and as the card runs it (``device_ms``: the host's enqueue
    hidden, ``time_cold_ms(cushion=True)``); the plain version (one
    reading), the bound, and ``library`` (one PyTorch call, the same two
    readings) where given."""
    from repro_torch.core.evals.scorer import time_cuda_ms
    from repro_torch.kernels import flash_decode as fd

    B, Hq, D = q.shape
    splits = fd.kernel_splits(q, k)
    run = {body: (lambda body=body: fd.flash_decode(q, k, v, vl, impl="kernel", body=body))
           for body in fd.BODIES}
    t = in_turns(lambda body: time_cold_ms(run[body]), "simt", "wgmma")
    dev = in_turns(lambda body: time_cold_ms(run[body], cushion=True), "simt", "wgmma")
    b_ms, b_by = decode_bound(B, Hq, k.shape[1], D, valid)
    row = {"splits": splits, "ms": t["wgmma"]["ms"], "readings": t["wgmma"]["readings"],
           "device_ms": dev["wgmma"]["ms"], "device_readings": dev["wgmma"]["readings"],
           "simt_ms": t["simt"]["ms"], "simt_readings": t["simt"]["readings"],
           "simt_device_ms": dev["simt"]["ms"], "simt_device_readings": dev["simt"]["readings"],
           "plain_ms": time_cuda_ms(lambda: fd.flash_decode_plain(q, k, v, vl, splits=splits),
                                    warmup=1, reps=1),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if library is not None:
        try:
            row.update(library_ms=time_cold_ms(library),
                       library_device_ms=time_cold_ms(library, cushion=True))
        except (RuntimeError, TypeError) as e:        # recorded, not hidden
            row["library_error"] = str(e)[:160]
    return row


def _encdec_times(state):
    """Both attention kernels in seamless-m4t-medium's roles off the causal
    path (bf16, 16 heads of 64, the direct part's shapes): flash_attention
    at the encoder's self-attention (ENCDEC_FRAMES frames, non-causal) and at
    the cross-attention (ENCDEC_PROMPT decoder rows against the frames):
    kernel ms, bound, plain ms (one reading) and SDPA's ms; flash_decode
    over the cross cache (valid_len = ENCDEC_FRAMES): ``_decode_row``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.evals.scorer import time_cuda_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME

    B, H, D, Se = SERVE_BATCH, 16, 64, ENCDEC_FRAMES
    g = torch.Generator(device="cuda").manual_seed(8)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    out = {"flash_attention": {}, "flash_decode": {}}
    k, v = rand(B, H, Se, D), rand(B, H, Se, D)
    kw = dict(DEFAULT_ATTN_GENOME, causal=False)
    for role, Sq in (("encoder", Se), ("cross", ENCDEC_PROMPT)):
        q = rand(B, H, Sq, D)
        nbytes = 2 * 2 * B * H * Sq * D + 2 * 2 * B * H * Se * D    # q, o; k, v
        b_ms, b_by = _bound(nbytes, 4.0 * B * H * Sq * Se * D)
        before = fa.flash_attention.launches_by_body["wgmma"]
        ms = time_cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=10)
        out["flash_attention"][role] = {
            "shape": f"q ({B}, {H}, {Sq}, {D}), k/v ({B}, {H}, {Se}, {D}) bf16, non-causal",
            "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "wgmma": fa.flash_attention.launches_by_body["wgmma"] > before,
            "plain_ms": time_cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                                     warmup=1, reps=1),
            "library_ms": time_cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                       reps=10), "library": "sdpa"}
    q = rand(B, H, D)
    valid = [Se] * B
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    out["flash_decode"]["cross_cache"] = {
        "shape": f"q ({B}, {H}, {D}), cache ({B}, {H}, {Se}, {D}) bf16, valid_len {Se}",
        **_decode_row(q, k, v, vl, valid, library=lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v)),
        "library": "sdpa over the whole cross cache, L2 flushed"}
    del q, k, v
    torch.cuda.empty_cache()
    for name, rows in out.items():
        for role, row in rows.items():
            emit({"phase": "times", "check": "encdec", "gate": False, "kernel": name,
                  "role": role, **row})
    state["encdec_times"] = out


def _head_dim_times(state):
    """Both attention kernels at the registry's head dims off the compiled
    widths, at the served prompt length, beside the compiled width in
    turns: flash_attention at h2o-danube-3-4b's 120 (zero-padded to 128)
    against 128 (GQA 32 / 8, causal), and at phi-3-vision-4.2b's 96 (MHA,
    the mma_sync body) beside SDPA; flash_decode at 120 and 96 (the wgmma
    body in 128-wide tiles, no copy) against 128, L2 flushed, device times
    beside.  Readings, not checks."""
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
        run = {D: lambda: fd.flash_decode(q, k, v, vl),
               128: lambda: fd.flash_decode(q_w, k_w, v_w, vl)}
        t = in_turns(lambda d: time_cold_ms(run[d]), 128, D)
        dev = in_turns(lambda d: time_cold_ms(run[d], cushion=True), 128, D)
        out["flash_decode"][D] = {
            "arch": arch, "shape": f"q ({B}, {Hq}, {D}), cache ({B}, {Hkv}, {L}, {D}), "
                                   f"valid_len {S + 16}",
            "body": fd.decode_body(q.dtype, D), "ms": t[D]["ms"], "readings": t[D]["readings"],
            "device_ms": dev[D]["ms"], "device_readings": dev[D]["readings"],
            "ms_at_128": t[128]["ms"], "device_ms_at_128": dev[128]["ms"],
            "bound_ms": decode_bound(B, Hq, Hkv, D, [S + 16] * B)[0],
            "bound_ms_at_128": decode_bound(B, Hq, Hkv, 128, [S + 16] * B)[0]}
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
    Each kernel's two bodies are timed in turns; flash_decode's beside
    their device times (``_decode_row``), after a writing flush too, and
    the wgmma body over a sweep of split counts."""
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
    row = _decode_row(q, k, v, vl, valid, library=lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))
    # the same two bodies after a flush that writes (as the earlier
    # readings were taken), and the wgmma body over a sweep of split counts
    row["ms_after_write_flush"] = {
        body: time_cold_ms(lambda body=body: fd.flash_decode(q, k, v, vl, impl="kernel",
                                                              body=body), flush="write")
        for body in fd.BODIES}
    sweep = {n: {"ms": time_cold_ms(lambda: fd.flash_decode(q, k, v, vl, splits=n)),
                 "device_ms": time_cold_ms(lambda: fd.flash_decode(q, k, v, vl, splits=n),
                                           cushion=True)}
             for n in DECODE_SWEEP}
    emit({"phase": "times", "check": "flash_decode_split_sweep", "gate": False,
          "body": "wgmma", "wrapper_splits": row["splits"], "by_splits": sweep})
    out["flash_decode"] = {
        "shape": f"q ({B}, {Hq}, {D}), cache ({B}, {Hkv}, {L}, {D}) bf16, valid_len {valid[0]}",
        **row, "library": "sdpa over the cache, valid_len mask, L2 flushed"}
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
    train_launches = state.get("train", {}).get("launches", {})
    mesh_launches = state.get("mesh", {}).get("launches", {})
    long_decode = state.get("long_decode", {})
    long_launches = long_decode.get("launches", {})
    encdec = state.get("serve_encdec", {})
    encdec_launches = encdec.get("launches", {})
    encdec_times = state.get("encdec_times", {})
    fa_serve = served.get("flash_attention", {})
    entries = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:251",
        "launches": state.get("launches", 0) + state.get("tpu_plan_launches", 0)
        + state.get("rank_launches", 0) + state.get("gqa_launches", 0)
        + state.get("decode_suite_launches", 0) + serve_launches.get("flash_attention", 0)
        + state.get("backends_launches", 0) + state.get("islands_launches", 0)
        + state.get("islands_worker_launches", 0) + state.get("cascade_launches", 0)
        + state.get("frontier_worker_launches", 0)
        + encdec_launches.get("flash_attention", 0) + mesh_launches.get("flash_attention", 0),
        "launches_by_path": {"evolve": state.get("launches", 0),
                             "backends_workers": state.get("backends_launches", 0),
                             "islands": state.get("islands_launches", 0),
                             "islands_workers": state.get("islands_worker_launches", 0),
                             "cascade": state.get("cascade_launches", 0),
                             "frontier_workers": state.get("frontier_worker_launches", 0),
                             "evolve_tpu_plan": state.get("tpu_plan_launches", 0),
                             "rank": state.get("rank_launches", 0),
                             "gqa": state.get("gqa_launches", 0),
                             "decode_suite": state.get("decode_suite_launches", 0),
                             "serve": serve_launches.get("flash_attention", 0),
                             "serve_encdec": encdec_launches.get("flash_attention", 0),
                             "train": train_launches.get("flash_attention", 0),
                             "mesh": mesh_launches.get("flash_attention", 0)},
        "launches_by_body": {"evolve": state.get("evolve_by_body"),
                             "backends_workers": state.get("backends_by_body"),
                             "islands": state.get("islands_by_body"),
                             "cascade": state.get("cascade_by_body"),
                             "frontier_workers": state.get("frontier_by_body"),
                             "gqa": state.get("gqa_by_body"),
                             "decode_suite": state.get("decode_suite_by_body"),
                             "serve": serve.get("by_body"),
                             "serve_encdec": encdec.get("by_body")},
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
        "head_dims": state.get("head_dim_times", {}).get("flash_attention"),
        "row_shards": state.get("row_shards"),
        "encdec": encdec_times.get("flash_attention"),
        "max_abs_err_serve_encdec_bf16": encdec.get("err", {}).get("flash_attention")}]
    for name, src, replaces, err in (
            ("flash_decode", "flash_decode.cu", "src/repro/kernels/flash_decode.py:67",
             state.get("decode_err")),
            ("ssd_chunked", "ssd.cu", "src/repro/kernels/ssd.py:73", state.get("ssd_err"))):
        t = served.get(name, {})
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": serve_launches.get(name, 0) + encdec_launches.get(name, 0)
            + mesh_launches.get(name, 0) + long_launches.get(name, 0),
            "launches_by_path": {"serve": serve_launches.get(name, 0),
                                 "long_decode": long_launches.get(name, 0),
                                 "serve_encdec": encdec_launches.get(name, 0),
                                 "train": train_launches.get(name, 0),
                                 "mesh": mesh_launches.get(name, 0)},
            "max_abs_err": err, "max_abs_err_served_bf16": serve_err.get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"), "shape": t.get("shape")}
        if name == "flash_decode":
            entry.update(splits=t.get("splits", state.get("decode_splits")),
                         device_ms=t.get("device_ms"), simt_ms=t.get("simt_ms"),
                         simt_device_ms=t.get("simt_device_ms"),
                         library_device_ms=t.get("library_device_ms"),
                         ms_after_write_flush=t.get("ms_after_write_flush"),
                         launches_by_body={"serve": serve.get("decode_by_body"),
                                           "long_decode": long_decode.get(
                                               "flash_decode_launches_by_body"),
                                           "serve_encdec": encdec.get("decode_by_body"),
                                           "mesh": state.get("mesh", {}).get("serve", {})
                                           .get("decode_by_body")},
                         head_dims=state.get("head_dim_times", {}).get("flash_decode"),
                         long_context=state.get("decode_shards"),
                         rank_shape=state.get("decode_rank_shape"),
                         long_decode={k: long_decode.get(k) for k in (
                             "ms_per_step_median", "tokens_per_s", "peak_gib",
                             "launches_checked", "max_abs_err")} if long_decode else None,
                         encdec=encdec_times.get("flash_decode"),
                         max_abs_err_serve_encdec_bf16=encdec.get("err", {}).get(name))
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
    state: dict = {"phases": phases}
    if "device" in phases:
        emit({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        device_check()
    runners = {"build": lambda st: phase_build(), "kernel": phase_kernel,
               "decode_kernel": phase_decode_kernel, "ssd_kernel": phase_ssd_kernel,
               "serve": phase_serve, "long_decode": phase_long_decode,
               "serve_encdec": phase_serve_encdec,
               "train": phase_train, "mesh": phase_mesh, "dryrun": phase_dryrun,
               "noise": phase_noise,
               "rank": phase_rank,
               "evolve": phase_evolve, "backends": phase_backends,
               "islands": phase_islands, "cascade": phase_cascade,
               "frontier": phase_frontier,
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
