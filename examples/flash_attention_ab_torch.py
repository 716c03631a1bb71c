"""Time the port's ``flash_attention`` kernel at ``q_offset`` 0 from two
checkouts of the repo, in turns, on one card, and check that both give the
same output bits.

    python examples/flash_attention_ab_torch.py --trees OLD NEW

Each turn (OLD, NEW, NEW, OLD by default) is a subprocess that imports
``repro_torch`` from one checkout's ``src/`` (its kernels built under that
checkout's ``build/kernels/``), draws the inputs from a seeded CUDA
generator, and times every case with CUDA events (the median of
``--reps``).  The cases: ``mha_causal_s4096`` (q, K/V (8, 16, 4096, 128)
bf16, causal) with the default genome (block_skip, the grid walk) and with
the loop walk, and the served prefill's shape (q (4, 32, 1892, 128) against
K/V (4, 8, 1892, 128), causal).  Prints the card's name and power limit,
then as its last line one JSON object: each case's ms in every turn, and
whether both checkouts' outputs are the same bits.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

CASES = {
    "mha_causal_s4096": ((8, 16, 16, 4096, 128), {}),
    "mha_causal_s4096_loop_walk": ((8, 16, 16, 4096, 128), {"kv_in_grid": False}),
    "served_prefill": ((4, 32, 8, 1892, 128), {}),
}


def child(reps: int) -> None:
    import torch

    from repro_torch.core.evals.scorer import time_cuda_ms
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ops import DEFAULT_ATTN_GENOME

    out = {}
    for name, ((B, Hq, Hkv, S, D), over) in CASES.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((B, h, S, D), generator=g, device="cuda").to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        kw = dict(DEFAULT_ATTN_GENOME, causal=True, **over)
        o = flash_attention(q, k, v, impl="kernel", **kw)
        ms = time_cuda_ms(lambda: flash_attention(q, k, v, impl="kernel", **kw), reps=reps)
        digest = hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        out[name] = {"ms": ms, "sha256": digest}
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--order", default="old,new,new,old")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.reps)
        return 0
    if not args.trees:
        ap.error("--trees OLD NEW is required")
    trees = dict(zip(("old", "new"), (os.path.abspath(t) for t in args.trees)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    turns = []
    for who in args.order.split(","):
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[who], "src"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               "--reps", str(args.reps)], env=env, cwd=trees[who],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"the {who} turn failed with exit code {proc.returncode}")
        turns.append((who, json.loads(proc.stdout.strip().splitlines()[-1])))
    result = {}
    for name in CASES:
        digests = {t[name]["sha256"] for _, t in turns}
        result[name] = {"ms": [[who, t[name]["ms"]] for who, t in turns],
                        "same_bits": len(digests) == 1}
    print(json.dumps(result))
    return 0 if all(r["same_bits"] for r in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
