"""End-to-end training example of the PyTorch port (the counterpart of
examples/train_lm.py): train a ~100M-param qwen2-family model with the
port's stack — data pipeline, AdamW + cosine schedule, microbatched
gradient accumulation, checkpointing, restart.

  PYTHONPATH=src python examples/train_lm_torch.py                      # on the card
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30 --simulate-crash 12
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30 --resume

Checkpoints go to results/train_lm_torch/ (every 5 steps with fewer than
100 steps, else every 50).
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import (batch_to_device, init_train_state,  # noqa: E402
                                      make_train_step)
from repro_torch.optim import AdamWConfig, AdamWState  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "results", "train_lm_torch")


def model_100m():
    """qwen2-family scaled to ~100M params (12L, d=768, vocab 32k)."""
    base = get_arch("qwen2-7b")
    return dataclasses.replace(
        base, name="qwen2-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_head=64, d_ff=2048, vocab_size=32768, remat=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-crash", type=int, default=0,
                    help="exit at this step (fault-tolerance demo; restart with --resume)")
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = model_100m()
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.batch}x{args.seq} tokens/step, {args.microbatches} microbatches, "
          f"compression={args.compression}, device={device}")

    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      total_steps=args.steps, weight_decay=0.1)
    step_fn = make_train_step(cfg, opt, n_microbatches=args.microbatches,
                              compression=args.compression, compute_dtype=torch.float32)
    pipe = TokenPipeline(cfg, args.seq, args.batch, seed=0)
    ckpt = Checkpointer(OUT, keep=2)
    every = 5 if args.steps < 100 else 50

    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start, tree, extra = ckpt.restore(device=device)
        params, residual = tree["params"], tree.get("residual")
        o = tree["opt_state"]
        opt_state = AdamWState(o["step"], o["mu"], o["nu"])
        pipe.load_state_dict(extra["pipeline"])
        print(f"resumed from step {start} (loss there {extra['loss']:.4f})")
    else:
        params, opt_state, residual = init_train_state(
            cfg, torch.Generator(device=device).manual_seed(0), device=device,
            compression=args.compression)

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        if args.simulate_crash and step == args.simulate_crash and not args.resume:
            print(f"[simulated crash at step {step}; restart with --resume]")
            raise SystemExit(17)
        batch = batch_to_device(pipe.next_batch(), device)
        params, opt_state, residual, m = step_fn(params, opt_state, residual, batch)
        losses.append(float(m["loss"]))
        if step % 5 == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
            print(f"step {step:4d}  loss {losses[-1]:.4f}  lr {m['lr']:.2e}  "
                  f"gnorm {float(m['grad_norm']):.2f}  {tok_s:,.0f} tok/s")
        if (step + 1) % every == 0:
            tree = {"params": params, "opt_state": opt_state._asdict()}
            if residual is not None:
                tree["residual"] = residual
            ckpt.save(step + 1, tree,
                      extra={"pipeline": pipe.state_dict(), "loss": losses[-1]})

    uniform = float(np.log(cfg.vocab_size))
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(uniform baseline {uniform:.3f})")
    if losses[-1] >= losses[0]:
        raise SystemExit("training did not improve")


if __name__ == "__main__":
    main()
