"""Serve a model with batched requests: prefill and lockstep greedy decode
with KV caches (ring buffers on sliding-window layers) and Mamba states.
The counterpart of ``examples/serve_batched.py``.

    python -m repro_torch.serve --device cpu --reduced          # CPU, tiny
    python -m repro_torch.serve --arch jamba-v0.1-52b --n-layers 16 \\
        --prompt-len 1000 2048 --new-tokens 32 --max-len 4096    # on the card
    python -m repro_torch.serve --arch seamless-m4t-medium \\
        --prompt-len 1000 2048 --new-tokens 32 --max-len 4096    # whole

On the card the model runs in bf16 through the sm_90a kernels, its decode
step captured once in a CUDA graph and replayed; with ``--device cpu`` it
runs in fp32 through the plain PyTorch references, eagerly.
Weights are random, drawn from ``--seed`` on the device.  An
encoder-decoder's encoder reads zero frames, as in the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import device_name, resolve_device
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import init_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny same-family config (CPU tests)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut depth to this many layers (a multiple of the pattern)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(3, 12),
                    metavar=("LO", "HI"), help="prompt lengths drawn in [LO, HI)")
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    print(f"serving {cfg.name} on {device_name(dev)}: {cfg.n_layers} layers, "
          f"d_model={cfg.d_model}, vocab={cfg.vocab_size}, {dtype}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev, dtype=dtype)

    rng = np.random.default_rng(args.seed)
    lo, hi = args.prompt_len
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (int(rng.integers(lo, hi)),)),
                    max_new_tokens=args.new_tokens) for i in range(args.requests)]
    server = BatchedServer(cfg, params, batch_size=args.batch_size,
                           max_len=args.max_len, compute_dtype=dtype)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = server.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in done)
    for r in done:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.output}")
    step = (f"a CUDA graph ({len(server.graph_log['capture_ms'])} captures)"
            if server.graph else "eager")
    print(f"\n{total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s, "
          f"prefill included, decode step {step}, on {device_name(dev)})")


if __name__ == "__main__":
    main()
