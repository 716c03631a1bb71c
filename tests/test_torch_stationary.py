"""Decode from the weight shards (``spmd.stationary``, ``spmd.dot``,
``spmd.lookup``) on gloo ranks of the CPU, against ``h @ use(W)`` and
against the JAX package.

Inside ``decode_step`` every product takes its weight's local shard: a
contracting dim sharded over an axis takes this rank's slice of the
activation and sums the fp32 partials over the axis; an output dim takes
this rank's columns and gathers them; rows split over the data ranks are
exchanged first and cut back after.  Nothing gathers a weight.

* (a) Every route of ``spmd.dot`` and ``spmd.lookup`` (contracting over
  "data", output over "data", output over "model" with the heads whole and
  named, contracting over "model", the 3-D expert weights EP and TP and
  whole, the tied head transposed, the head tied and untied with a vocab
  that divides no model axis named over "model" (each rank its own
  columns, as ``Shard`` splits them: ``spmd.part``), the table lookup
  with the vocab over "model" and whole), with the rows split (a batch of
  4) and whole (a batch of 1), against the same call outside the scope
  (``h @ use(W, *spec)``).  fp32; within ``PRODUCT_REL`` = 1e-6 relative to the largest
  magnitude.  With every axis of size 1 but "pod" the route issues no
  collective.
* (b) An unhandled placement raises: an expert dim sharded over "model"
  that the spec does not name, a weight sharded over "pod", a ``Partial``
  weight, and an input that requires grad.
* (c) Decode of five reduced architectures at a batch of 4 and of 1:
  greedy tokens equal to the JAX package's ``decode_step`` and the
  one-device port's, logits within ``REL`` (1e-5 relative,
  ``test_torch_mesh.py``'s) of both.
* Worlds (spawned gloo ranks meeting through a ``file://`` store, as
  ``test_torch_mesh.py`` spawns them): (data=2, model=2), (data=1,
  model=3) and (pod=2, data=1, model=1).
* (d) On the dry run's fake process group (data=2, model=2), no
  collective of a decode step has a product weight's storage as its
  operand, at a batch of 4 and of 1; the same instrument sees the weight
  gathers of a prefill.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_mesh import (ARCHS5, NEW, REL, S, _cfg, _inputs, _jax_weights, _place, _rel,
                             _weights, _whole)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCT_REL = 1e-6            # fp32 product on the shards against h @ use(W)
BATCHES = (4, 1)
# name: (weight shape, its placement spec, the block's spec, transposed)
CASES = {
    "contract_data": ((24, 12), ("data", None), (), False),
    "out_data": ((24, 12), (None, "data"), (), False),
    "out_model_heads_whole": ((24, 12), ("data", "model"), (), False),
    "out_model_named": ((24, 12), ("data", "model"), (None, "model"), False),
    "contract_model_out_data": ((24, 12), ("model", "data"), (), False),
    "contract_model_named": ((24, 12), ("model", "data"), ("model", None), False),
    "expert_ep": ((6, 24, 12), ("model", "data", None), ("model", None, None), False),
    "expert_tp_up": ((6, 24, 12), (None, "data", "model"), (None, None, "model"), False),
    "expert_tp_down": ((6, 12, 24), (None, "model", "data"), (None, "model", None), False),
    "expert_whole": ((6, 24, 12), (None, "data", None), (), False),
    "head_tied": ((36, 24), ("model", "data"), ("model", None), True),
    "head_tied_vocab_whole": ((36, 24), (None, "data"), (), True),
    # a vocab of 35 divides no model axis of 2 or 3: each rank its own columns
    "head_vocab_uneven": ((24, 35), ("data", None), (None, "model"), False),
    "head_tied_vocab_uneven": ((35, 24), (None, "data"), ("model", None), True),
}
LOOKUPS = {"lookup": ("model", "data"), "lookup_vocab_whole": (None, "data")}
TABLE = (36, 24)


# ---------------------------------------------------------------------------
# (a), (b): the products on each rank
# ---------------------------------------------------------------------------


def _weight(shape, spec, seed):
    """A weight drawn alike on every rank, placed by ``spec``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed.sharding import placements
    full = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))
    mesh = ctx.get_mesh()
    return distribute_tensor(full, mesh, placements(spec, mesh), src_data_rank=None)


def _local_input(shape, spec, transposed, rows, seed):
    """This rank's input of a product: the rows of a global input (along
    the slots of an expert weight) cut to its data-parallel shard where
    they split, and its part of each dim the block's spec splits."""
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed import spmd
    nd = len(shape)
    spec = tuple(spec) + (None,) * (nd - len(spec))
    kd = nd - 1 if transposed else nd - 2
    k = shape[kd]
    row = 1 if nd == 3 else 0
    g = (shape[0], rows, k) if nd == 3 else (rows, k)
    h = torch.from_numpy(np.random.default_rng(seed).standard_normal(g).astype(np.float32))
    if spmd.batch_sharded(rows):
        h = h.chunk(spmd.dp_size(), row)[spmd.dp_rank()]
    m, r = ctx.axis_size("model"), spmd.rank("model")
    if spec[kd] == "model":
        h = h.chunk(m, -1)[r]
    if nd == 3 and spec[0] == "model":
        h = h.chunk(m, 0)[r]
    return h


def _columns(shape, spec, transposed) -> int:
    """A product's output columns on this rank: ``Shard``'s part of the
    output dim where the block's spec names "model" there, else all."""
    from torch.distributed.tensor import Shard
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed import spmd
    od = len(shape) - (2 if transposed else 1)
    n = shape[od]
    if (tuple(spec) + (None,) * len(shape))[od] != "model":
        return n
    parts, _ = Shard(0)._split_tensor(torch.empty(n), ctx.axis_size("model"),
                                      with_padding=False)
    return parts[spmd.rank("model")].numel()


def _products() -> dict:
    """Every case at a batch of 4 and of 1: the largest relative error of
    the stationary route against the same call outside the scope, the
    collectives the route issued, and its output columns beside
    ``_columns``."""
    from repro_torch.distributed import spmd
    out = {}
    for batch in BATCHES:
        with spmd.rows(spmd.batch_sharded(batch)):
            for i, (name, (shape, place, spec, tr)) in enumerate(CASES.items()):
                w = _weight(shape, place, i)
                h = _local_input(shape, spec, tr, batch, 100 + i)
                want = spmd.dot(h, w, *spec, transposed=tr)
                spmd.counts.update(products=0, collectives=0)
                with torch.no_grad(), spmd.stationary():
                    got = spmd.dot(h, w, *spec, transposed=tr)
                out[(name, batch)] = (_rel(got, want), dict(
                    spmd.counts, columns=(got.shape[-1], want.shape[-1],
                                          _columns(shape, spec, tr))))
            for i, (name, place) in enumerate(LOOKUPS.items()):
                table = _weight(TABLE, place, 50 + i)
                ids = spmd.local_rows(torch.from_numpy(
                    np.random.default_rng(60 + i).integers(0, TABLE[0], (batch,))))
                want = spmd.lookup(table, ids, torch.float32)
                spmd.counts.update(products=0, collectives=0)
                with torch.no_grad(), spmd.stationary():
                    got = spmd.lookup(table, ids, torch.float32)
                out[(name, batch)] = (_rel(got, want), dict(spmd.counts))
    return out


def _refusals() -> dict:
    """Whether each unhandled placement raised (None: the world cannot
    place it)."""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import placements
    mesh = ctx.get_mesh()
    h = torch.ones((6, 4, 24))

    def raises(call, exc) -> bool:
        try:
            with spmd.stationary():
                call()
        except exc:
            return True
        return False
    grad = torch.ones((4, 24), requires_grad=True)
    out = {"requires_grad": raises(lambda: spmd.dot(grad, _weight((24, 12), ("data", None), 0)),
                                   RuntimeError)}
    if ctx.axis_size("model") > 1:     # experts over "model", the block computing all
        w = _weight((6, 24, 12), ("model", None, None), 0)
        out["expert_dim"] = raises(lambda: spmd.dot(h, w), ValueError)
    if ctx.axis_size("data") > 1:
        pl = tuple(Partial() if n == "data" else Replicate() for n in mesh.mesh_dim_names)
        part = spmd.Local(torch.ones((24, 12)), pl)
        with torch.no_grad():
            out["partial"] = raises(lambda: spmd.dot(h[0], part), ValueError)
    if "pod" in mesh.mesh_dim_names:
        pod = spmd.Local(torch.ones((12, 12)), placements(("pod", None), mesh))
        with torch.no_grad():
            out["pod"] = raises(lambda: spmd.dot(h[0, :, :12], pod), ValueError)
    return out


# ---------------------------------------------------------------------------
# (c): decode
# ---------------------------------------------------------------------------


def _decode(arch, npw, batch):
    """Prefill the first ``batch`` prompts and NEW greedy decode steps
    through the kernel wrappers (their plain versions on CPU tensors):
    the logits of every step (whole) and the tokens."""
    from repro_torch.models import decode_step, prefill
    cfg = _cfg(arch)
    params = _place(_weights(cfg, npw), cfg)
    toks, frames = _inputs(cfg)
    toks = toks[:batch]
    frames = None if frames is None else frames[:batch]
    kw = dict(compute_dtype=torch.float32, impl="kernel")
    with torch.no_grad():
        logits, cache = prefill(params, cfg, toks, S + NEW, enc_frames=frames,
                                cache_dtype=torch.float32, **kw)
        steps = [_whole(logits)]
        for _ in range(NEW):
            logits, cache = decode_step(params, cfg, cache, torch.argmax(steps[-1], -1), **kw)
            steps.append(_whole(logits))
    logits = torch.stack(steps, 1)
    return {"logits": logits, "tokens": torch.argmax(logits, -1)}


def _world(rank, model, pod, weights):
    from repro_torch.distributed import context as ctx
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=model, device="cpu", pod=pod)
    ctx.set_mesh(mesh)
    out = {"mesh": {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)},
           "products": _products(), "refusals": _refusals()}
    for arch in ARCHS5:
        for batch in BATCHES:
            out[(arch, batch)] = _decode(arch, weights[arch], batch)
    ctx.set_mesh(None)
    return out


WORLDS = {"data2_model2": (4, dict(model=2, pod=None)),
          "model3": (3, dict(model=3, pod=None)),
          "pod2": (2, dict(model=1, pod=2))}


def _rank_main(rank, world, store, out_dir, job, kw):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group
    torch.set_num_threads(1)
    init_process_group(store, rank, world, device="cpu")
    try:
        result = _world(rank, **kw)
        # every rank's product errors and refusals: the largest error, all refused
        results = [None] * world
        dist.all_gather_object(results, {"products": result["products"],
                                         "refusals": result["refusals"]})
        if rank == 0:
            result["products_all"] = [r["products"] for r in results]
            result["refusals_all"] = [r["refusals"] for r in results]
            torch.save(result, os.path.join(out_dir, f"{job}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(tmp, job, **kw):
    world, mesh_kw = WORLDS[job]
    procs = mp.start_processes(_rank_main, args=(world, os.path.join(tmp, f"store-{job}"),
                                                 tmp, job, dict(mesh_kw, **kw)),
                               nprocs=world, start_method="spawn", join=False)

    def finish():
        while not procs.join():
            pass
        return torch.load(os.path.join(tmp, f"{job}.pt"), weights_only=False)
    return finish


def _jax_decode(arch, batch):
    """The JAX package's prefill and NEW greedy decode steps on the same
    weights and prompts: fp32 through its blocked references."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.models import decode_step, prefill
    jcfg = JAX_ARCHS[arch].reduced()
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_weights(arch))
    toks, frames = _inputs(_cfg(arch))
    f32 = dict(compute_dtype=jnp.float32, impl="blocked")
    logits, cache = prefill(jp, jcfg, jnp.asarray(toks[:batch].numpy()), S + NEW,
                            cache_dtype=jnp.float32,
                            enc_frames=None if frames is None else
                            jnp.asarray(frames[:batch].numpy()), **f32)
    steps = [np.asarray(logits)]
    for _ in range(NEW):
        logits, cache = decode_step(jp, jcfg, cache,
                                    jnp.asarray(np.argmax(steps[-1], -1), jnp.int32), **f32)
        steps.append(np.asarray(logits))
    return np.stack(steps, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks (spawned first, run meanwhile), the one-device
    port's decode and the JAX package's."""
    tmp = str(tmp_path_factory.mktemp("stationary"))
    weights = {arch: _jax_weights(arch) for arch in ARCHS5}
    running = {job: _spawn(tmp, job, weights=weights) for job in WORLDS}
    one = {(arch, b): _decode(arch, weights[arch], b) for arch in ARCHS5 for b in BATCHES}
    jax_ref = {(arch, b): _jax_decode(arch, b) for arch in ARCHS5 for b in BATCHES}
    return {job: finish() for job, finish in running.items()}, one, jax_ref


@pytest.mark.parametrize("m", [2, 3, 4, 16])
def test_part_is_shards_split(m):
    """``spmd.part`` (a rank's part of a dim that ``m`` ranks split) on
    every size up to 3m + 2 and every rank: the elements of DTensor's
    ``Shard`` split, an empty part on a rank past the end, where
    ``torch.chunk`` returns fewer than m pieces (5 over 4: 2, 2, 1, 0)."""
    from torch.distributed.tensor import Shard
    from repro_torch.distributed.spmd import part
    assert len(torch.arange(5).chunk(4)) == 3
    for n in range(3 * m + 3):
        pieces, _ = Shard(0)._split_tensor(torch.arange(n), m, with_padding=False)
        for r in range(m):
            assert torch.equal(torch.arange(n).narrow(0, *part(n, m, r)), pieces[r]), (n, m, r)


@pytest.mark.parametrize("job", list(WORLDS))
def test_products_on_the_shards_match_use(runs, job):
    ranks, _, _ = runs
    res = ranks[job]
    names = list(CASES) + list(LOOKUPS)
    for per_rank in res["products_all"]:
        assert set(per_rank) == {(n, b) for n in names for b in BATCHES}
        for key, (err, counts) in per_rank.items():
            assert err <= PRODUCT_REL, (job, key, err)
            assert counts["products"] == 1, (job, key, counts)
            if "columns" in counts:            # a product's, not a lookup's
                assert len(set(counts["columns"])) == 1, (job, key, counts)
            if res["mesh"]["data"] == res["mesh"]["model"] == 1:
                assert counts["collectives"] == 0, (job, key, counts)
    if job == "data2_model2":            # the routes that move activations did
        got = res["products_all"][0]
        for name in ("contract_data", "out_data", "out_model_heads_whole", "expert_tp_down",
                     "lookup"):
            for b in BATCHES:
                assert got[(name, b)][1]["collectives"] > 0, (name, b)


@pytest.mark.parametrize("job", list(WORLDS))
def test_unhandled_placements_raise(runs, job):
    ranks, _, _ = runs
    expect = {"data2_model2": {"requires_grad", "expert_dim", "partial"},
              "model3": {"requires_grad", "expert_dim"},
              "pod2": {"requires_grad", "pod"}}[job]
    for refusals in ranks[job]["refusals_all"]:
        assert set(refusals) == expect
        assert all(refusals.values()), (job, refusals)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("arch", ARCHS5)
@pytest.mark.parametrize("job", list(WORLDS))
def test_decode_matches_jax_and_one_device(runs, job, arch, batch):
    ranks, one, jax_ref = runs
    got, want, ref = ranks[job][(arch, batch)], one[(arch, batch)], jax_ref[(arch, batch)]
    assert got["logits"].shape == want["logits"].shape == ref.shape
    assert torch.equal(got["tokens"], want["tokens"])
    assert np.array_equal(got["tokens"].numpy(), np.argmax(ref, -1))
    assert _rel(got["logits"], want["logits"]) <= REL
    assert _rel(got["logits"], ref) <= REL


# ---------------------------------------------------------------------------
# (d): no weight crosses a collective, on the dry run's fake group
# ---------------------------------------------------------------------------

_FAKE = """
import json, torch
import torch.distributed as dist
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import context as ctx
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decode_step, prefill
from repro_torch.tree import tree_map_with_path
PRODUCTS = {"wq", "wk", "wv", "wo", "c_wq", "c_wk", "c_wv", "c_wo", "w_gate", "w_up",
            "w_down", "router", "in_proj", "out_proj", "embed", "lm_head"}
dryrun.fake_world(4)
ctx.set_mesh(make_host_mesh(model=2, device="cpu"))
seen = []
def operand(i):
    def wrap(fn):
        def call(*args, **kw):
            seen.append((args[i].untyped_storage()._cdata, args[i].numel()))
            return fn(*args, **kw)
        return call
    return wrap
dist.all_gather = operand(1)(dist.all_gather)
dist.all_reduce = operand(0)(dist.all_reduce)
dist.all_to_all_single = operand(1)(dist.all_to_all_single)
out = {}
for arch in ("qwen2-7b", "mixtral-8x22b", "jamba-v0.1-52b", "seamless-m4t-medium"):
    cfg = get_arch(arch).reduced()
    params, _ = specs.param_specs(cfg)
    weights = set()
    tree_map_with_path(lambda path, t: weights.add(t._local_tensor.untyped_storage()._cdata)
                       if str(path[-1]) in PRODUCTS else None, params)
    for batch in (4, 1):
        cell = ShapeCell("d", 16, batch, "decode")
        del seen[:]
        with torch.no_grad():
            decode_step(params, cfg, specs.cache_specs(cfg, cell), specs.token_specs(cfg, cell),
                        compute_dtype=torch.bfloat16, impl="blocked")
        out[f"{arch} decode {batch}"] = [len(seen), sum(s in weights for s, _ in seen)]
    del seen[:]
    batch = specs.batch_specs(cfg, ShapeCell("p", 16, 4, "prefill"))
    extras = {k: v for k, v in batch.items() if k == "enc_frames"}
    with torch.no_grad():
        prefill(params, cfg, batch["tokens"], 16, compute_dtype=torch.bfloat16, impl="blocked",
                **extras)
    out[f"{arch} prefill"] = [len(seen), sum(s in weights for s, _ in seen)]
print(json.dumps(out))
"""


def test_no_weight_crosses_a_collective_in_decode():
    """Reduced qwen2-7b, mixtral-8x22b, jamba-v0.1-52b and
    seamless-m4t-medium on a fake (data=2, model=2) mesh, every tensor on
    meta: the operand of every all-gather, all-reduce and all-to-all of a
    decode step, against the local shards of every product weight (the
    projections, experts, router, ``in_proj`` / ``out_proj``, the table and
    the head).  The prefill, which gathers its weights, is the control."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", _FAKE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    for key, (n, weights) in got.items():
        assert n > 0, key
        if "decode" in key:
            assert weights == 0, (key, got)
        else:
            assert weights > 0, (key, got)
