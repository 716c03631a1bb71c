"""Roofline report: digest results/dryrun_torch/*.json into the per-(arch x
shape) three-term table (compute / memory / collective seconds per rank on
the H100), dominant bottleneck, MODEL_FLOPS/HLO_FLOPs ratio, and a one-line
"what to move next" diagnosis per cell.  The counterpart of
``repro.launch.roofline``; it reads either package's records.

  python -m repro_torch.launch.roofline                 # print table (single-pod)
  python -m repro_torch.launch.roofline --markdown      # markdown table
  python -m repro_torch.launch.roofline --mesh pod2     # multi-pod view
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.core.perfmodel_h100 import PEAK_FLOPS
from repro_torch.launch.dryrun import RESULTS_DIR

CELL_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh_tag: str = "pod1", out_dir: str = RESULTS_DIR) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, f"*__{mesh_tag}.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    recs.sort(key=lambda r: (r["arch"], CELL_ORDER.index(r["cell"])
                             if r["cell"] in CELL_ORDER else 9))
    return recs


def diagnose(rec: dict) -> str:
    """One sentence: what would move the dominant term down."""
    dom = rec["dominant"]
    coll = rec["collectives"]["bytes"]
    top = max(coll, key=coll.get) if coll else "none"
    if dom == "collective":
        return (f"cut {top} traffic (top site: "
                f"{(rec.get('top_collective_sites') or [['?']])[0][0][:60]}) "
                f"via sharding that keeps the operand local")
    if dom == "memory":
        if rec["cell"].startswith("decode") or rec["cell"].startswith("long"):
            return "decode is HBM-bound by weights+cache residency: raise batch per chip or quantize cache"
        return "cut activation traffic: fuse/remat less, larger microbatch, bf16 master copies"
    return ("tensor-core-bound: good; next lever is reducing non-useful FLOPs "
            "(remat recompute)")


def rows_for(recs: list[dict]) -> list[list]:
    rows = []
    for r in recs:
        t = r["terms_s"]
        bound = max(t.values())
        # fraction of the ideal roofline: ideal = model work at peak; achieved
        # bound-term time is the modelled step floor.  PEAK_FLOPS is the one
        # machine-model source of truth (perfmodel_h100) — the evaluation
        # cascade's rung-1 roofline and this report must agree on it.
        ideal = r["model_flops_per_chip"] / PEAK_FLOPS
        frac = ideal / bound if bound > 0 else 0.0
        rows.append([
            r["arch"], r["cell"],
            f"{t['compute']:.3e}", f"{t['memory']:.3e}",
            f"{t['collective']:.3e}", r["dominant"],
            f"{r['useful_flops_frac']:.2f}", f"{frac:.2f}",
            diagnose(r),
        ])
    return rows


HEADER = ["arch", "cell", "compute_s", "memory_s", "collective_s",
          "dominant", "useful_frac", "roofline_frac", "next lever"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    recs = load(args.mesh, args.dir)
    if not recs:
        raise FileNotFoundError(
            f"no dry-run records for {args.mesh} under {args.dir}; run "
            f"`python -m repro_torch.launch.dryrun --all` first")
    rows = rows_for(recs)

    if args.markdown:
        print("| " + " | ".join(HEADER) + " |")
        print("|" + "---|" * len(HEADER))
        for r in rows:
            print("| " + " | ".join(str(x) for x in r) + " |")
    else:
        w = [20, 12, 10, 10, 10, 11, 7, 7, 40]
        print("  ".join(h.ljust(x) for h, x in zip(HEADER, w)))
        for r in rows:
            print("  ".join(str(x).ljust(wi)[:wi + 24] for x, wi in zip(r, w)))

    doms = {}
    for r in recs:
        doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    print(f"\n{len(recs)} cells [{args.mesh}]; dominant-term counts: {doms}")


if __name__ == "__main__":
    main()
