"""The dry run: trace every (architecture x shape cell) on a 256-rank mesh
(data=16, model=16) and a 512-rank mesh (pod=2, data=16, model=16), and
read each rank's roofline terms from the trace.  The counterpart of
``repro.launch.dryrun``.

  python -m repro_torch.launch.dryrun --arch qwen2-7b --cell train_4k
  python -m repro_torch.launch.dryrun --all                 # every cell x 2 meshes
  python -m repro_torch.launch.dryrun --all --mesh single   # the 256-rank mesh only

Where the JAX package compiles against ``ShapeDtypeStruct``s on 512 host
devices, the port runs its own sharded train step, prefill and decode step
as rank 0 of a fake process group (``torch.distributed``'s ``fake``
backend: every collective returns at once and moves nothing) on a mesh of
device type "cpu", with every tensor on the ``meta`` device
(``launch.specs``).  Nothing is allocated and no device is touched.
``launch.trace_analysis.trace_step`` counts each op the rank dispatches,
its collectives by kind and mesh axis, and the peak of its live bytes.
Attention takes ``impl="blocked"``, as the JAX package's dry run does: the
kernels run on a card only.

Records land one JSON file per cell and mesh under
``results/dryrun_torch/`` (``{arch}__{cell}__pod1|pod2.json``), cached
unless ``--force``; ``python -m repro_torch.launch.roofline`` reads them.
A cell that raises is printed and counted, and the CLI exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES_BY_NAME, ArchConfig, ShapeCell, cells_for
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.perfmodel_h100 import HBM_BW, PEAK_FLOPS
from repro_torch.distributed import context as ctx
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.trace_analysis import NVLINK_BW, _tensors, trace_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# -- the card and its links (NVIDIA H100 SXM5 80GB; PEAK_FLOPS and HBM_BW
# are perfmodel_h100's data-sheet numbers) -----------------------------------
HBM_BYTES = 80 * 2**30       # HBM3 per card (data sheet: 80 GB)
HEADROOM = 0.5 * 2**30       # kept free by the auto-fit, as the JAX package keeps it
NODE_CARDS = 8               # cards per HGX H100 node, all to all over NVLink 4
IB_BW = 50e9                 # 400 Gb/s NDR InfiniBand, one adapter per card (ConnectX-7)


def link_bw(mesh, axis: str) -> float:
    """Bytes/s of the link the groups along ``axis`` ("world": every rank)
    cross: NVLink inside one node of :data:`NODE_CARDS` cards, InfiniBand
    once a group spans nodes.  Ranks are numbered node-major (rank r on
    node r // 8)."""
    if axis == "world":
        ranks = mesh.mesh.reshape(1, -1)
    else:
        i = list(mesh.mesh_dim_names).index(axis)
        ranks = mesh.mesh.movedim(i, -1).reshape(-1, mesh.size(i))
    nodes = ranks // NODE_CARDS
    return NVLINK_BW if bool((nodes == nodes[:, :1]).all()) else IB_BW


class Traced(NamedTuple):
    """One cell's trace on this rank: the counter, the bytes of the
    arguments and outputs (distinct local storages), the microbatches."""
    counter: object
    argument_bytes: int
    output_bytes: int
    n_microbatches: Optional[int]


def _storage_bytes(*trees) -> int:
    """The bytes of the distinct storages of the tensors in ``trees`` (of a
    DTensor, its local shard)."""
    seen = {}
    for t in _tensors(trees):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def default_nm(cfg: ArchConfig, cell: ShapeCell, mesh) -> int:
    """The JAX package's dry-run microbatch rule: ``default_microbatches``
    on this mesh's data-parallel and model shards (the model axis counts
    only where it divides the vocab)."""
    from repro_torch.launch.train import default_microbatches
    names = list(mesh.mesh_dim_names)
    dp = 1
    for a in ("pod", "data"):
        if a in names:
            dp *= mesh.size(names.index(a))
    mdl = mesh.size(names.index("model")) if "model" in names else 1
    return default_microbatches(cfg, cell.global_batch, seq_len=cell.seq_len,
                                dp_shards=dp,
                                model_shards=(mdl if cfg.vocab_size % mdl == 0 else 1))


def trace_cell(cfg: ArchConfig, cell: ShapeCell, mesh, *,
               n_microbatches: Optional[int] = None,
               param_dtype: torch.dtype = torch.float32) -> Traced:
    """Trace one dry-run cell as rank 0 of ``mesh`` (None: one device),
    with blocked attention and, for a train cell, uncompressed gradients.
    ``n_microbatches`` None takes :func:`default_nm` (one on one device)."""
    ctx.set_mesh(mesh)
    params, _ = S.param_specs(cfg, param_dtype)
    if cell.kind == "train":
        from repro_torch.launch.train import make_train_step
        nm = n_microbatches
        if nm is None:
            nm = default_nm(cfg, cell, mesh) if mesh is not None else 1
        step = make_train_step(cfg, n_microbatches=nm, compression="none",
                               impl="blocked")
        args = (params, S.opt_specs(params), None, S.batch_specs(cfg, cell))
        out, counter = trace_step(step, *args)
        return Traced(counter, _storage_bytes(args), _storage_bytes(out), nm)
    if cell.kind == "prefill":
        from repro_torch.models import prefill
        batch = S.batch_specs(cfg, cell)
        extras = {k: v for k, v in batch.items() if k in ("prefix_embeds", "enc_frames")}
        with torch.no_grad():
            out, counter = trace_step(
                prefill, params, cfg, batch["tokens"], cell.seq_len,
                compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                impl="blocked", **extras)
        return Traced(counter, _storage_bytes(params, batch["tokens"], extras),
                      _storage_bytes(out), None)
    if cell.kind == "decode":
        from repro_torch.models import decode_step
        cache = S.cache_specs(cfg, cell)
        token = S.token_specs(cfg, cell)
        with torch.no_grad():
            out, counter = trace_step(decode_step, params, cfg, cache, token,
                                      compute_dtype=torch.bfloat16, impl="blocked")
        return Traced(counter, _storage_bytes(params, cache, token),
                      _storage_bytes(out), None)
    raise ValueError(f"unknown cell kind {cell.kind!r}")


def analyze(cfg: ArchConfig, cell: ShapeCell, traced: Traced, mesh) -> dict:
    """One record, with the JAX package's keys.  ``hlo_flops``,
    ``hlo_bytes`` and ``hlo_dot_flops`` are the meta trace's counts for
    this rank (the names are the JAX package's, whose numbers come from
    the compiled HLO); ``cost_analysis_raw`` repeats them, since the port
    has no compiler's own estimate.  ``memory``: the rank's arguments
    (parameters, optimiser state, the global batch every rank takes, the
    cache), what the step returns (the updated state included, as XLA
    counts donated outputs), and ``temp_bytes``, the peak of the tensors
    the step created and held at once.  The collective term prices each
    mesh axis's bytes on the link its groups cross (:func:`link_bw`)."""
    c = traced.counter
    s = c.summary()
    n_chips = mesh.size() if mesh is not None else 1
    by_axis = dict(c.coll_axis_bytes)
    bw = {a: link_bw(mesh, a) for a in by_axis}
    flops, bytes_accessed = s["flops"], s["bytes_accessed"]
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = sum(b / bw[a] for a, b in by_axis.items())
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}

    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    model_flops = (6 if cell.kind == "train" else 2) * cfg.active_param_count() * tokens
    return {
        "arch": cfg.name, "cell": cell.name,
        "mesh": list(mesh.mesh.shape) if mesh is not None else [],
        "n_chips": n_chips,
        "hlo_flops": flops, "hlo_bytes": bytes_accessed,
        "hlo_dot_flops": s["dot_flops"],
        "collectives": {"bytes": s["collective_bytes"],
                        "count": s["collective_count"],
                        "total_bytes": s["collective_total_bytes"],
                        "by_axis": by_axis, "link_bw": bw},
        "top_collective_sites": [[site[:140], b] for site, b in c.top_collective_sites(8)],
        "top_dot_sites": [[site[:140], f] for site, f in c.top_dot_sites(8)],
        "memory": {"argument_bytes": traced.argument_bytes,
                   "output_bytes": traced.output_bytes,
                   "temp_bytes": c.peak_bytes, "generated_code_bytes": 0},
        "cost_analysis_raw": {"flops": flops, "bytes_accessed": bytes_accessed},
        "terms_s": terms,
        "dominant": max(terms, key=terms.get),
        "model_flops": model_flops,
        "model_flops_per_chip": model_flops / n_chips,
        "useful_flops_frac": (model_flops / n_chips) / (flops if flops else 1.0),
    }


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of ``world_size``
    ranks (destroying a default group of another size first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        ctx.set_mesh(None)
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def production_mesh(multi_pod: bool):
    """The 256- or 512-rank production mesh over a fake group."""
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def run_cell(arch: str, cell_name: str, *, multi_pod: bool, force: bool = False,
             out_dir: str = RESULTS_DIR) -> dict:
    mesh_tag = "pod2" if multi_pod else "pod1"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{cell_name}__{mesh_tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_arch(arch)
    cell = SHAPES_BY_NAME[cell_name]
    mesh = production_mesh(multi_pod)
    nm = None
    # auto-fit, as the JAX package's: while the train step's live temp
    # exceeds the card, double the microbatches and trace again
    hbm_limit = HBM_BYTES - HEADROOM
    prev_temp = None
    t0 = time.time()
    for _ in range(4):
        traced = trace_cell(cfg, cell, mesh, n_microbatches=nm)
        temp = traced.counter.peak_bytes
        if cell.kind != "train" or temp <= hbm_limit:
            break
        if prev_temp is not None and temp > prev_temp * 0.9:
            break               # more microbatches do not shrink the live set
        prev_temp = temp
        nxt = traced.n_microbatches * 2
        if cell.global_batch % nxt:
            break
        print(f"  [auto-fit] {arch}/{cell_name}: temp {temp / 2**30:.1f} GiB > "
              f"{hbm_limit / 2**30:.1f} GiB at nm={traced.n_microbatches}; "
              f"retry nm={nxt}", flush=True)
        nm = nxt
    wall = time.time() - t0
    rec = analyze(cfg, cell, traced, mesh)
    if traced.n_microbatches is not None:
        rec["n_microbatches"] = traced.n_microbatches
    rec["wall_s"] = {"trace": round(wall, 1)}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def iter_matrix():
    for arch in sorted(ARCHS):
        for cell in cells_for(arch):
            yield arch, cell.name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (see configs/registry.py)")
    ap.add_argument("--cell", help="shape cell name", default=None)
    ap.add_argument("--all", action="store_true", help="full assigned matrix")
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    if args.all:
        todo = list(iter_matrix())
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        cells = [args.cell] if args.cell else [c.name for c in cells_for(args.arch)]
        todo = [(args.arch, c) for c in cells]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = []
    for multi_pod in meshes:            # one fake group per mesh
        tag = "pod2" if multi_pod else "pod1"
        for arch, cell in todo:
            try:
                rec = run_cell(arch, cell, multi_pod=multi_pod,
                               force=args.force, out_dir=args.out)
                t = rec["terms_s"]
                print(f"OK   {arch:22s} {cell:12s} {tag}  "
                      f"compute={t['compute']:.3e}s memory={t['memory']:.3e}s "
                      f"coll={t['collective']:.3e}s dominant={rec['dominant']:10s} "
                      f"useful={rec['useful_flops_frac']:.2f} "
                      f"wall={rec.get('wall_s')}", flush=True)
            except Exception as e:  # a failing cell is a fault of the port's sharding
                failures.append((arch, cell, tag, repr(e)[:300]))
                print(f"FAIL {arch:22s} {cell:12s} {tag}  {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nall cells traced")


if __name__ == "__main__":
    main()
