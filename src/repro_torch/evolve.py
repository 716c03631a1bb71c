"""AVO evolution of the attention kernel on the card — the port's
counterpart of ``examples/evolve_attention.py``: one lineage, or an
archipelago of islands.

  python -m repro_torch.evolve --commits 4 --max-steps 12          # measured, on the card
  python -m repro_torch.evolve --gqa --commits 2 --max-steps 4     # GQA transfer (paper §4.3)
  python -m repro_torch.evolve --fidelity perfmodel --device cpu   # rung 0, plain path
  python -m repro_torch.evolve --fidelity perfmodel --machine h100 --device cpu
  python -m repro_torch.evolve --backend process --workers 2      # spawned workers on the card
  python -m repro_torch.evolve --islands 4 --scenario-sweep        # islands, rung 0, on the card
  python -m repro_torch.evolve --islands 3 --device cpu            # islands, plain path
  python -m repro_torch.evolve --islands 4 --pipeline --backend process --prefetch-budget 6

``--islands N`` runs the island engine (``core/islands.py``): N lineages on
``--suite`` with diverse initial genomes (``--scenario-sweep``: one
specialist island per suite family), migration along ``--topology`` every
epoch, persisted to ``archipelago.json`` (``archipelago_sweep.json``) and
resumed from it on the next run.  Islands score at rung 0 (the default
``--fidelity perfmodel`` there; the measured rung comes to islands with the
evaluation cascade, ROADMAP Queue 1 item 6), through the ``thread`` backend
unless ``--backend`` says otherwise, with every island's gate on the card.

``--backend`` picks the evaluation service: ``inline`` (the default, in this
process), ``thread``, ``process`` (spawned worker processes on the card) or
``service`` (a coordinator on loopback with ``--workers`` local worker
processes).  On the card every worker's gate and timing hold the card's
lock, so workers overlap host work and the card times one at a time.

Every paid evaluation runs the flash-attention kernel twice: in the
correctness gate (fp32, proxy shapes) and, with ``--fidelity measured`` (the
default), timed at the suite's full shapes in bf16.  ``perfmodel`` scores
with a model: ``--machine tpu_v5e`` (the default) is the reference's TPU v5e
model, ``--machine h100`` the model of this port's kernel on the card; their
TFLOP/s are a model's output, not the card's.  The agent plans from the
H100 model and its Hopper facts at the measured rung and under
``--machine h100``, from the TPU model and facts under ``tpu_v5e``.  The lineage is persisted after every commit.  ``--gqa`` adapts
the best genome of ``lineage_mha.json`` to ``gqa_suite`` and persists to
``lineage_gqa.json``.  The closing line gives the geomeans of the paper's
two yardsticks (``Scorer.baselines()``): at the measured rung the measured
cuDNN and FlashAttention SDPA backends, at rung 0 the modelled expert and FA
genomes.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.core.config import EngineConfig
from repro_torch.core.evals import MACHINES, MEASURED, PERFMODEL
from repro_torch.core.evolution import ContinuousEvolution, default_agent
from repro_torch.core.islands import IslandEvolution, scenario_specs
from repro_torch.core.perfmodel import suite_by_name
from repro_torch.core.population import Lineage
from repro_torch.core.topology import topology_names
from repro_torch.core.variation import AgenticVariationOperator
from repro_torch.device import device_name


def baseline_line(scorer, key: str) -> str:
    """The geomean of one yardstick over the suite, or which configs it
    refused."""
    vals = scorer.baselines()[key]
    if all(v is not None and v > 0 for v in vals):
        return f"{float(np.exp(np.mean(np.log(vals)))):.1f}"
    refused = [c.name for c, v in zip(scorer.suite, vals) if v is None]
    return f"none (refused on {len(refused)} of {len(vals)} configs: {refused[0]})"


def run_islands(args) -> None:
    """The island engine at rung 0, resumed from (and persisted to) one
    archipelago file per mode."""
    kw = dict(seed=args.seed, prefetch=args.prefetch, backend=args.backend,
              topology=args.topology, pipeline=args.pipeline,
              elastic_workers=args.elastic_workers,
              prefetch_budget=args.prefetch_budget,
              migrant_policy=args.migrant_policy, migrant_k=args.migrant_k,
              device=args.device, machine=args.machine)
    if args.backend == "service":
        kw["service_workers"] = 2 if args.workers is None else args.workers
    elif args.workers is not None:
        kw["max_workers"] = args.workers
    mode = "pipelined" if args.pipeline else "barrier"
    if args.scenario_sweep:
        path = os.path.join(args.out, "archipelago_sweep.json")
        cfg = EngineConfig.from_kwargs(specs=scenario_specs(), **kw)
    else:
        path = os.path.join(args.out, "archipelago.json")
        cfg = EngineConfig.from_kwargs(n_islands=args.islands,
                                       suite=suite_by_name(args.suite), **kw)
    engine = IslandEvolution.resume(path, config=cfg)
    try:
        scorer = next(iter(engine.scorers.values()))
        print(f"{len(engine.islands)} islands ("
              + ", ".join(i.name for i in engine.islands)
              + f"; topology {args.topology}, {mode} stepping) scoring on "
              f"{device_name(scorer.device)} at rung 0 through the "
              f"{args.backend} backend, planning from the {engine.machine} model")
        rep = engine.run(max_steps=args.max_steps, target_commits=args.commits,
                         verbose=True)
        print(f"\n{rep.commits} commits across {len(engine.islands)} islands / "
              f"{rep.internal_attempts} internal attempts / "
              f"{rep.migrations_accepted} migrations accepted")
        print(f"evaluations: {rep.evaluations} paid, {rep.cache_hits} "
              f"shared-cache hits" + (f", {rep.proposed} speculative proposals"
                                      if args.pipeline else ""))
        if rep.eval_pool:
            p = rep.eval_pool
            if "grown" in p:                   # elastic process pool
                print(f"elastic pool: {p['workers']} workers now (peak "
                      f"{p['peak_workers']}, grew {p['grown']}x, shrank "
                      f"{p['shrunk']}x over {p['tasks_completed']} tasks)")
            else:                              # service coordinator registry
                print(f"eval service: {p['workers']} workers / "
                      f"{p['total_slots']} slots ({p['tasks_requeued']} "
                      f"requeued over {p['tasks_completed']} tasks)")
        if engine.migration_stats.edges:
            rates = ", ".join(
                f"{engine.islands[s].name}->{engine.islands[d].name} "
                f"{st.accepts}/{st.attempts}"
                for (s, d), st in sorted(engine.migration_stats.edges.items()))
            print(f"migration acceptance per edge: {rates}")
        print(f"global best: {rep.best_geomean:.1f} TFLOPS on "
              f"'{rep.best_island}' ({engine.machine} model)")
        print(f"scenario coverage geomean: {rep.coverage_geomean:.1f} TFLOPS")
        for name, r in rep.islands.items():
            print(f"  {name:14s} commits={r.commits:3d} "
                  f"best={r.best_geomean:7.1f} interventions={r.interventions}")
        print(f"gates ran on {device_name(scorer.device)}; archipelago "
              f"persisted to {path} (+ per-island files)")
    finally:
        engine.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.evolve")
    ap.add_argument("--commits", type=int, default=12)
    ap.add_argument("--max-steps", type=int, default=80)
    ap.add_argument("--suite", default="mha",
                    help="registered suite name or '+'-union (default mha)")
    ap.add_argument("--gqa", action="store_true",
                    help="adapt the best genome of lineage_mha.json to gqa_suite "
                         "(overrides --suite)")
    ap.add_argument("--fidelity", choices=(PERFMODEL, MEASURED), default=None,
                    help="measured: CUDA-event time of the kernel at the full "
                         "suite shapes (the default of one lineage); "
                         "perfmodel: rung 0's model (the default, and the "
                         "only rung, of --islands)")
    ap.add_argument("--machine", choices=MACHINES, default=None,
                    help="rung 0's model: tpu_v5e (default, the reference's) "
                         "or h100; the measured rung takes h100 only")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--backend", choices=("inline", "thread", "process", "service"),
                    default=None,
                    help="evaluation backend (default: inline, in this "
                         "process; thread with --islands)")
    ap.add_argument("--workers", type=int, default=None,
                    help="worker count of a thread, process or service backend "
                         "(default: 2 on the card)")
    ap.add_argument("--islands", type=int, default=0,
                    help="run N islands in parallel instead of one lineage")
    ap.add_argument("--scenario-sweep", action="store_true",
                    help="islands: one specialist island per suite family "
                         "(mha, gqa, decode, mha-explorer)")
    ap.add_argument("--seed", type=int, default=0,
                    help="islands: operator seeds and diverse initial genomes")
    ap.add_argument("--topology", choices=topology_names(), default="ring",
                    help="islands: migration graph (ring, star, all-to-all, "
                         "adaptive)")
    ap.add_argument("--pipeline", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="islands: propose -> submit -> harvest stepping "
                         "(lineages identical to --no-pipeline)")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="islands: KB candidate edits speculatively scored "
                         "per step (cache warming only)")
    ap.add_argument("--prefetch-budget", type=int, default=None,
                    help="islands: shared speculative-evaluation budget, "
                         "re-divided across islands every epoch")
    ap.add_argument("--elastic-workers", type=int, default=0,
                    help="islands: cap of an elastic worker-process pool "
                         "(needs --backend process)")
    ap.add_argument("--migrant-policy", choices=("best", "top-k"),
                    default="best",
                    help="islands: what a donor sends per migration edge")
    ap.add_argument("--migrant-k", type=int, default=3,
                    help="islands: k for --migrant-policy top-k")
    ap.add_argument("--out", default=os.path.join("results", "torch"),
                    help="directory for the persisted lineage")
    args = ap.parse_args(argv)
    islands = bool(args.islands or args.scenario_sweep)
    if islands and args.fidelity == MEASURED:
        ap.error("--islands scores at rung 0: the measured rung comes to the "
                 "island engine with the evaluation cascade (ROADMAP Queue 1 "
                 "item 6); use --fidelity perfmodel")
    if args.fidelity is None:
        args.fidelity = PERFMODEL if islands else MEASURED
    if args.backend is None:
        args.backend = "thread" if islands else "inline"
    if args.fidelity == MEASURED and args.machine not in (None, "h100"):
        ap.error("--fidelity measured plans from the card's model: "
                 "--machine must be h100")
    if args.workers is not None and args.backend == "inline":
        ap.error("--workers needs --backend thread, process or service")
    if islands:
        run_islands(args)
        return

    operator = None
    suite = args.suite
    if args.gqa:
        mha_path = os.path.join(args.out, "lineage_mha.json")
        seed = (Lineage.load(mha_path).best().genome
                if os.path.exists(mha_path) else None)
        suite = "gqa"
        operator = AgenticVariationOperator(default_agent(args.fidelity, seed=seed))
        print(f"adapting MHA-evolved genome to GQA: {seed}")
    path = os.path.join(args.out, f"lineage_{suite.replace('+', '_')}.json")
    evo = ContinuousEvolution.resume(path, target_suite=suite, operator=operator,
                                     fidelity=args.fidelity, device=args.device,
                                     machine=args.machine,
                                     eval_backend=args.backend, workers=args.workers)
    print(f"scoring on {device_name(evo.scorer.device)} at fidelity "
          f"{args.fidelity} through the {args.backend} backend "
          f"({evo.scorer.max_workers} worker{'s' * (evo.scorer.max_workers != 1)}), "
          f"planning from the {evo.scorer.plan_machine} model")
    rep = evo.run(max_steps=args.max_steps, target_commits=args.commits,
                  verbose=True)
    traj = evo.lineage.trajectory()
    print(f"\n{rep.commits} commits / {rep.internal_attempts} internal "
          f"attempts / {rep.interventions} supervisor interventions / "
          f"{evo.scorer.n_evaluations} paid evaluations")
    if traj["running_best"]:
        names = (("cuDNN", "flash") if args.fidelity == MEASURED
                 else ("expert", "FA"))
        print(f"running-best geomean: {traj['running_best'][0]:.1f} -> "
              f"{traj['running_best'][-1]:.1f} TFLOPS ({args.fidelity}; "
              f"{names[0]} line {baseline_line(evo.scorer, 'expert')}, "
              f"{names[1]} line {baseline_line(evo.scorer, 'fa_reference')})")
        print(f"best genome: {evo.lineage.best().genome}")
    print(f"lineage persisted to {path}")
    evo.close()


if __name__ == "__main__":
    main()
