"""Serial AVO evolution of the attention kernel on the card — the port's
counterpart of ``examples/evolve_attention.py``'s serial mode.

  python -m repro_torch.evolve --commits 4 --max-steps 12          # measured, on the card
  python -m repro_torch.evolve --gqa --commits 2 --max-steps 4     # GQA transfer (paper §4.3)
  python -m repro_torch.evolve --fidelity perfmodel --device cpu   # rung 0, plain path
  python -m repro_torch.evolve --fidelity perfmodel --machine h100 --device cpu
  python -m repro_torch.evolve --backend process --workers 2      # spawned workers on the card

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

from repro_torch.core.evals import MACHINES, MEASURED, PERFMODEL
from repro_torch.core.evolution import ContinuousEvolution, default_agent
from repro_torch.core.population import Lineage
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.evolve")
    ap.add_argument("--commits", type=int, default=12)
    ap.add_argument("--max-steps", type=int, default=80)
    ap.add_argument("--suite", default="mha",
                    help="registered suite name or '+'-union (default mha)")
    ap.add_argument("--gqa", action="store_true",
                    help="adapt the best genome of lineage_mha.json to gqa_suite "
                         "(overrides --suite)")
    ap.add_argument("--fidelity", choices=(PERFMODEL, MEASURED), default=MEASURED,
                    help="measured: CUDA-event time of the kernel at the full "
                         "suite shapes (default); perfmodel: the reference's "
                         "TPU v5e model")
    ap.add_argument("--machine", choices=MACHINES, default=None,
                    help="rung 0's model: tpu_v5e (default, the reference's) "
                         "or h100; the measured rung takes h100 only")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--backend", choices=("inline", "thread", "process", "service"),
                    default="inline",
                    help="evaluation backend (default inline: in this process)")
    ap.add_argument("--workers", type=int, default=None,
                    help="worker count of a thread, process or service backend "
                         "(default: 2 on the card)")
    ap.add_argument("--out", default=os.path.join("results", "torch"),
                    help="directory for the persisted lineage")
    args = ap.parse_args(argv)
    if args.fidelity == MEASURED and args.machine not in (None, "h100"):
        ap.error("--fidelity measured plans from the card's model: "
                 "--machine must be h100")
    if args.workers is not None and args.backend == "inline":
        ap.error("--workers needs --backend thread, process or service")

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
