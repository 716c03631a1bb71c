"""The port under a device mesh, on gloo ranks of the CPU, against the JAX
package and against the one-device port, from the same weights: the JAX
package's ``init_params`` draws them, and every rank and the parent carry
them across with ``params_from_jax``.

Ranks are spawned (``torch.multiprocessing``, ``spawn``) and meet through a
``file://`` store under ``tmp_path``: no TCP port is fixed, so the suite's
xdist workers do not collide.  This module imports JAX only inside the
functions that run in the parent: a spawned rank imports the module, then
only torch and ``repro_torch``, and gets the JAX weights as numpy arrays.
One spawn per world runs several checks; the parent computes its
references (the JAX package's, cached across the tests, and the one-device
port's) while the ranks run.

Worlds:
  * 4 ranks as (data=2, model=2): Q heads, experts and vocab sharded;
  * 3 ranks as (data=1, model=3): the reduced models' 4 heads and vocab of
    256 do not divide 3 (the loss pads the vocab, ``pad_vocab``; elsewhere
    each model rank computes its own 86, 86 or 84 columns), and an expert
    hidden dim of 48 does (TP over the experts).  At S = 16, which 3 does not divide either, every
    self-attention takes the head fallback; at S = ``ROW_S`` = 18 it takes
    the JAX package's row split (query rows over "model", the kernel's
    ``q_offset``), where the reduced windows of 16 meet the offset; and
    with a cache of ``ROW_MAX`` = 30 keys, which 3 divides, decode splits
    each full-attention cache's length over "model" (10 slots a rank;
    windowed layers keep their 16);
  * 2 ranks as (pod=2, data=1, model=1): the compressed reduction.

Tolerances (fp32 everywhere), against the JAX package: logits, train-step
losses and gradient norms within 1e-5 relative (to the largest magnitude);
each gradient leaf within 1e-4 of its largest magnitude
(``test_torch_train.py``'s), and so each updated parameter leaf, which
moves by about its gradient here (``_train``); greedy tokens equal; MoE
dispatch (per-shard, global, the auxiliary loss) within 1e-5.  Against the one-device port, where the mesh changes only the
order of sums: logits, losses, gradient norms and updated parameters within
1e-5 relative, gradient leaves within 1e-4, tokens equal.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

REL = 1e-5
GRAD_REL = 1e-4       # per gradient leaf, of its largest magnitude (test_torch_train's)
ARCHS5 = ("qwen2-7b", "mixtral-8x22b", "jamba-v0.1-52b", "gemma2-27b",
          "seamless-m4t-medium")
TRAIN_ARCHS = ("qwen2-7b", "mixtral-8x22b", "jamba-v0.1-52b")
B, S, NEW = 4, 16, 4
ROW_S = 18                      # a sequence 3 divides: the row split on model=3
ROW_MAX = 30                    # a cache length 3 divides: decode splits it over model=3
MOE_B, MOE_S = 4, 128           # 256 tokens a data shard: per-shard dispatch
OPT = dict(lr=1.0, eps=1.0, warmup_steps=1, total_steps=10)   # see _train


# ---------------------------------------------------------------------------
# the computations, run alike with and without a mesh
# ---------------------------------------------------------------------------


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


# reduced configurations with fields replaced alike in both packages, by
# the name the ranks and the parent know them by
VARIANTS = {"qwen2-7b kv2": ("qwen2-7b", dict(n_kv_heads=2))}


def _cfg(arch):
    from repro_torch.configs.registry import ARCHS
    base, fields = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(ARCHS[base].reduced(), **fields)


def _jax_cfg(arch):
    """The JAX package's counterpart of ``_cfg``."""
    from repro.configs.registry import ARCHS as JAX_ARCHS
    base, fields = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(JAX_ARCHS[base].reduced(), **fields)


def _weights(cfg, npw):
    """The port's parameters from the JAX package's (numpy) weights."""
    from repro_torch.models import params_from_jax
    return params_from_jax(cfg, npw)


def _place(params, cfg):
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed.sharding import distribute_params
    mesh = ctx.get_mesh()
    return params if mesh is None else distribute_params(params, mesh, cfg)


def _inputs(cfg, s=S):
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, s)))
    frames = (torch.from_numpy(rng.standard_normal((B, s, cfg.d_model)).astype(np.float32))
              if cfg.enc_dec else None)
    return toks, frames


def _head_layout(t, heads):
    """Append to ``heads`` (a list; None: nothing) every rank's vocab
    columns of the logits DTensor ``t`` in rank order, and its whole
    shape.  Every rank calls it: the columns are gathered."""
    import torch.distributed as dist
    if heads is None:
        return
    cols = [None] * dist.get_world_size()
    dist.all_gather_object(cols, t.to_local().shape[-1])
    heads.append((tuple(cols), tuple(t.full_tensor().shape)))


def _logits(arch, npw, s=S, heads=None):
    """``lm_logits``, whole; ``heads`` gets their layout (``_head_layout``)."""
    from repro_torch.models import lm_logits
    cfg = _cfg(arch)
    toks, frames = _inputs(cfg, s)
    out = lm_logits(_place(_weights(cfg, npw), cfg), cfg, toks, enc_frames=frames,
                    compute_dtype=torch.float32, impl="blocked")
    _head_layout(out, heads)
    return _whole(out)


def _greedy(arch, npw, s=S, cache_out=None, max_len=None, heads=None):
    """Prefill and NEW decode steps through the kernel wrappers (their plain
    versions on CPU tensors), greedy, in a cache of ``max_len`` (default
    ``s + NEW``).  ``cache_out`` (a list) gets the leaves of the cache
    ``prefill`` returns, whole; ``heads`` the layout of each call's
    logits (``_head_layout``)."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.tree import tree_leaves
    cfg = _cfg(arch)
    params = _place(_weights(cfg, npw), cfg)
    toks, frames = _inputs(cfg, s)
    kw = dict(compute_dtype=torch.float32, impl="kernel")
    with torch.no_grad():
        logits, cache = prefill(params, cfg, toks, max_len or s + NEW, enc_frames=frames,
                                cache_dtype=torch.float32, **kw)
        if cache_out is not None:
            cache_out.extend(_whole(t).clone() for t in tree_leaves(cache["layers"]))
        _head_layout(logits, heads)
        out = [torch.argmax(_whole(logits), -1)]
        for _ in range(NEW):
            logits, cache = decode_step(params, cfg, cache, out[-1], **kw)
            _head_layout(logits, heads)
            out.append(torch.argmax(_whole(logits), -1))
    return torch.stack(out, 1)


def _train(arch, npw, steps=2, s=S):
    """``steps`` train steps in 2 microbatches; the losses, gradient norms
    and the updated parameters (whole).  AdamW's eps and lr are 1.0 here:
    with the default eps of 1e-8 the update is lr * sign(g) for every
    gradient element above 1e-8, so the elements whose gradients are
    smallest (and carry the largest relative rounding of a changed
    summation order) move by a whole step either way; with eps above every
    |g| the update is linear in the gradient (momentum, the second moment,
    bias corrections, weight decay and clipping all still apply), and the
    parameters differ as little as the gradients do.  The same
    configuration runs the JAX package's step in ``_jax_case``."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import batch_to_device, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    cfg = _cfg(arch)
    params = _place(_weights(cfg, npw), cfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(**OPT), n_microbatches=2,
                           compute_dtype=torch.float32)
    pipe = TokenPipeline(cfg, s, B, seed=1)
    losses, norms = [], []
    for _ in range(steps):
        params, opt, _, m = step(params, opt, None, batch_to_device(pipe.next_batch(), "cpu"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "params": tree_map(lambda t: _whole(t.detach()).clone(), params)}


def _grads(arch, npw, s=S):
    """One backward of ``lm_loss`` (under a mesh, reduced to the parameters'
    placements): every gradient leaf, whole."""
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import collectives
    from repro_torch.distributed import context as ctx
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import lm_loss
    from repro_torch.tree import tree_leaves, tree_map
    cfg = _cfg(arch)
    params = _place(_weights(cfg, npw), cfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = batch_to_device(TokenPipeline(cfg, s, B, seed=1).next_batch(), "cpu")
    lm_loss(params, cfg, batch, compute_dtype=torch.float32, impl="blocked").backward()
    grads = tree_map(lambda p: p.grad, params)
    if ctx.get_mesh() is not None:
        grads, _ = collectives.reduce_gradients(grads, params)
    return tree_map(lambda t: _whole(t).clone(), grads)


def _moe_cfg(arch, **moe):
    cfg = _cfg(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def _moe_inputs(cfg, seed=5):
    rng = np.random.default_rng(seed)
    # a shared component skews the routing, so some experts overflow
    return (rng.standard_normal((MOE_B, MOE_S, cfg.d_model))
            + 2.0 * rng.standard_normal(cfg.d_model)).astype(np.float32)


def _moe(cfg, p: dict, x: np.ndarray, aux: bool = False):
    """``moe_apply`` on x (with ``aux``, also the auxiliary loss); under the
    mesh, on this rank's rows with the expert weights placed as the model
    places a period's, the rows of every rank gathered after."""
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.models.moe import moe_apply
    xt, pt = torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}
    if ctx.get_mesh() is None:
        return moe_apply(xt, pt, cfg, torch.float32, return_aux=aux)
    stacked = distribute_params({"dec": {"pos0": {"moe": {k: v[None] for k, v in
                                                          pt.items()}}}}, ctx.get_mesh(), cfg)
    pt = {k: spmd.unstack(v)[0] for k, v in stacked["dec"]["pos0"]["moe"].items()}
    with spmd.rows(spmd.batch_sharded(xt.shape[0])):
        out = moe_apply(spmd.local_rows(xt), pt, cfg, torch.float32, return_aux=aux)
        y = out[0] if aux else out
        y = spmd.gather_rows(y, partial=False) if spmd.rows_sharded() else y
    return (y, out[1]) if aux else y


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _world_models(rank, model, moe_cases, weights, row_s=None, grad_archs=(), archs=ARCHS5,
                  train_archs=TRAIN_ARCHS):
    """Every check at S of ``archs`` (gradients and train steps of
    ``train_archs``), with the Mamba blocks of each arch's logits call
    that projected only this rank's columns counted (``ssm.counts``), the
    attentions of each call that projected only this rank's KV heads
    (``attention.counts["kv_columns"]``) and the ``lm_loss`` calls of
    each gradient and train run that took the log-softmax over the vocab
    shards (``transformer.counts``); the gradients of ``grad_archs`` too;
    with ``row_s``, also the five archs' logits, prefill caches and greedy tokens
    and qwen2-7b's gradients and train step at ``row_s``, with the
    self-attentions that took the row split counted per call, and the five
    archs' prefill caches, their layouts and greedy tokens at ``row_s`` in a
    cache of ``ROW_MAX``, with the decode attentions whose cache length
    split over "model" counted per arch (``attention.counts``)."""
    from repro_torch.distributed import context as ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention, ssm, transformer
    mesh = make_host_mesh(model=model, device="cpu")
    ctx.set_mesh(mesh)
    out = {"mesh": {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}}
    attention.counts.update(row_split=0, length_model=0)

    def counted(key, run):              # run(), its attentions on their own KV heads
        attention.counts["kv_columns"] = 0
        out[key] = run()
        out[("kv_columns",) + key] = attention.counts["kv_columns"]
    for arch in archs:
        ssm.counts["own_columns"] = 0
        transformer.counts["head_columns"] = 0
        out[("heads", arch)] = []
        counted(("logits", arch), lambda: _logits(arch, weights[arch], heads=out[("heads", arch)]))
        out[("own_columns", arch)] = ssm.counts["own_columns"]
        out[("head_columns", arch, "logits")] = transformer.counts["head_columns"]
        transformer.counts["head_columns"] = 0
        out[("cache", arch)] = []
        counted(("greedy", arch), lambda: _greedy(arch, weights[arch],
                                                  cache_out=out[("cache", arch)],
                                                  heads=out[("heads", arch)]))
        out[("head_columns", arch, "greedy")] = transformer.counts["head_columns"]
    for arch in train_archs + tuple(grad_archs):
        transformer.counts["loss_shards"] = 0
        counted(("grads", arch), lambda: _grads(arch, weights[arch]))
        out[("loss_shards", arch, "grads")] = transformer.counts["loss_shards"]
        if arch in train_archs:
            transformer.counts["loss_shards"] = 0
            counted(("train", arch), lambda: _train(arch, weights[arch]))
            out[("loss_shards", arch, "train")] = transformer.counts["loss_shards"]
    out["row_split_at_S"] = attention.counts["row_split"]
    out["length_model_at_S"] = attention.counts["length_model"]
    if row_s is not None:
        attention.counts["length_model"] = 0
        for arch in ARCHS5:
            attention.counts["row_split"] = 0
            out[("logits", arch, row_s)] = _logits(arch, weights[arch], row_s)
            out[("row_split", arch)] = attention.counts["row_split"]
            out[("cache", arch, row_s)] = []
            out[("greedy", arch, row_s)] = _greedy(arch, weights[arch], row_s,
                                                   cache_out=out[("cache", arch, row_s)])
        transformer.counts["loss_shards"] = 0
        out[("grads", "qwen2-7b", row_s)] = _grads("qwen2-7b", weights["qwen2-7b"], row_s)
        out[("train", "qwen2-7b", row_s)] = _train("qwen2-7b", weights["qwen2-7b"], s=row_s)
        out[("loss_shards", "qwen2-7b", row_s)] = transformer.counts["loss_shards"]
        out["length_model_at_row_s"] = attention.counts["length_model"]
        for arch in ARCHS5:
            attention.counts["length_model"] = 0
            out[("cache", arch, row_s, ROW_MAX)] = []
            out[("greedy", arch, row_s, ROW_MAX)] = _greedy(
                arch, weights[arch], row_s, cache_out=out[("cache", arch, row_s, ROW_MAX)],
                max_len=ROW_MAX)
            out[("length_model", arch)] = attention.counts["length_model"]
            out[("cache_layout", arch, ROW_MAX)] = _cache_layouts(arch, weights[arch], row_s,
                                                                  ROW_MAX)
    for name, (arch, moe_kw, p, x) in moe_cases.items():
        out[("moe", name)] = _moe(_moe_cfg(arch, **moe_kw), p, x)
        out[("moe_aux", name)] = _moe(_moe_cfg(arch, **moe_kw), p, x, aux=True)
    for arch in ("jamba-v0.1-52b", "seamless-m4t-medium"):
        if arch in archs:
            out[("cache_layout", arch)] = _cache_layouts(arch, weights[arch])
    from repro_torch.launch.train import default_microbatches
    out["microbatches"] = {arch: default_microbatches(_cfg(arch), 256, 4096)
                           for arch in ("qwen2-7b", "gemma2-27b")}
    ctx.set_mesh(None)
    return out


def _cache_layouts(arch, npw, s=S, max_len=S + NEW):
    """The placements of every leaf of the cache ``prefill`` returns and of
    the zero cache ``init_decode_cache`` makes under the mesh (equal), with
    their global shapes and this rank's local ones."""
    from repro_torch.models import init_decode_cache, prefill
    from repro_torch.tree import tree_map_with_path
    cfg = _cfg(arch)
    toks, frames = _inputs(cfg, s)
    with torch.no_grad():
        _, cache = prefill(_place(_weights(cfg, npw), cfg), cfg, toks, max_len,
                           enc_frames=frames, cache_dtype=torch.float32,
                           compute_dtype=torch.float32, impl="kernel")
    zero = init_decode_cache(cfg, B, max_len, cache_dtype=torch.float32,
                             enc_len=s if cfg.enc_dec else 0)

    def layout(tree):
        found = {}
        tree_map_with_path(lambda p, t: found.__setitem__(
            p, (tuple(t.placements), tuple(t.shape), tuple(t.to_local().shape))), tree)
        return found
    return layout(cache["layers"]), layout(zero["layers"])


def _world_pod(rank, steps, weights):
    """Per-rank partial gradients reduced over pod=2, each compression; the
    int8 error feedback over ``steps`` steps of one gradient."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.distributed import collectives
    from repro_torch.distributed import context as ctx
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=1, device="cpu", pod=2)
    ctx.set_mesh(mesh)
    rng = np.random.default_rng(100 + rank)
    local = {"a": torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal((256,)).astype(np.float32))}
    params = {k: DTensor.from_local(torch.zeros_like(v), mesh, [Replicate()] * 3)
              for k, v in local.items()}

    def partial(tree):
        return {k: DTensor.from_local(v.clone(), mesh, [Partial(), Replicate(), Replicate()])
                for k, v in tree.items()}

    out = {"parts": {k: torch.stack([torch.empty_like(v)] * 2) for k, v in local.items()}}
    for k, v in local.items():               # every rank's partial, for the parent
        dist.all_gather(list(out["parts"][k].unbind(0)), v)
    for method in ("none", "bf16"):
        g, _ = collectives.reduce_gradients(partial(local), params, method)
        out[method] = {k: v.to_local().clone() for k, v in g.items()}
    residual = collectives.compress_init(params)
    acc = {k: torch.zeros_like(v) for k, v in local.items()}
    for i in range(steps):
        g, residual = collectives.reduce_gradients(partial(local), params, "int8_ef",
                                                   residual)
        if i == 0:
            out["int8_ef"] = {k: v.to_local().clone() for k, v in g.items()}
        for k in acc:
            acc[k] += g[k].to_local()
    out["int8_ef_mean"] = {k: v / steps for k, v in acc.items()}
    out["train"] = _train("qwen2-7b", weights)   # each pod's gradient, summed by the hook
    ctx.set_mesh(None)
    return out


def _world_pod_one(rank):
    """pod=1 (with data=2, model=2 beside it): reduce_gradients equals
    apply_grad_compression of the full gradients exactly."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed import collectives
    from repro_torch.distributed import context as ctx
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=2, device="cpu", pod=1)
    ctx.set_mesh(mesh)
    rng = np.random.default_rng(11)
    full = {"a": torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((256,)).astype(np.float32))}
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import placements
    specs = {"a": (("data",), "model"), "b": ("model",)}
    params = {k: distribute_tensor(torch.zeros_like(v), mesh, placements(specs[k], mesh),
                                   src_data_rank=None) for k, v in full.items()}
    assert list(params["a"].placements) == [Replicate(), Shard(0), Shard(1)]
    out = {}
    for method in ("bf16", "int8_ef"):
        # every rank's partial over the one pod is the whole gradient
        grads = {k: DTensor.from_local(v.clone(), mesh, [Partial(), Replicate(), Replicate()])
                 for k, v in full.items()}
        res = collectives.compress_init(params) if method == "int8_ef" else None
        g, res = collectives.reduce_gradients(grads, params, method, res)
        out[method] = {k: v.full_tensor() for k, v in g.items()}
        if res is not None:
            out["residual"] = {k: v.full_tensor() for k, v in res.items()}
    ctx.set_mesh(None)
    return out


WORLDS = {"models": _world_models, "pod": _world_pod, "pod_one": _world_pod_one}


def _rank_main(rank, world, store, out_dir, job, kw):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group
    torch.set_num_threads(1)
    init_process_group(store, rank, world, device="cpu")
    try:
        result = WORLDS[job](rank, **kw)
        if rank == 0:
            torch.save(result, os.path.join(out_dir, "result.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world, job, **kw):
    """Start the ranks; returns ``finish()``, which waits for them (raising
    a rank's error) and returns rank 0's result.  The parent computes its
    references in between."""
    procs = mp.start_processes(_rank_main, args=(world, str(tmp_path / "store"),
                                                 str(tmp_path), job, kw),
                               nprocs=world, start_method="spawn", join=False)

    def finish():
        while not procs.join():
            pass
        return torch.load(tmp_path / "result.pt", weights_only=False)
    return finish


# ---------------------------------------------------------------------------
# the parent: the JAX package's results and the one-device port's
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(np.array(t), dtype=torch.float64) for t in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@functools.lru_cache(maxsize=None)
def _jax_weights(arch) -> dict:
    """The JAX package's weights of ``arch`` (seed 0), as numpy."""
    import jax
    from repro.models import init_params
    jp = init_params(_jax_cfg(arch), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _jax_inputs(arch, s):
    """The JAX package's reduced config, weights, tokens and frames."""
    import jax
    import jax.numpy as jnp
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_weights(arch))
    toks, frames = _inputs(_cfg(arch), s)
    jf = None if frames is None else jnp.asarray(frames.numpy())
    return _jax_cfg(arch), jp, jnp.asarray(toks.numpy()), jf


@functools.lru_cache(maxsize=None)
def _jax_greedy(arch, s, max_len) -> dict:
    """The JAX package's prefill of the ranks' prompts in a cache of
    ``max_len`` and NEW greedy decode steps, fp32 through its blocked
    references: the leaves of the cache its prefill returns and the
    tokens."""
    import jax
    import jax.numpy as jnp
    from repro.models import decode_step, prefill
    jcfg, jp, jt, jf = _jax_inputs(arch, s)
    f32 = dict(compute_dtype=jnp.float32, impl="blocked")
    logits, cache = prefill(jp, jcfg, jt, max_len, enc_frames=jf, cache_dtype=jnp.float32,
                            **f32)
    ref = {"cache": [np.asarray(t) for t in jax.tree_util.tree_leaves(cache["layers"])]}
    out = [np.argmax(np.asarray(logits), -1)]
    for _ in range(NEW):
        logits, cache = decode_step(jp, jcfg, cache, jnp.asarray(out[-1], jnp.int32), **f32)
        out.append(np.argmax(np.asarray(logits), -1))
    ref["greedy"] = torch.from_numpy(np.stack(out, 1))
    return ref


@functools.lru_cache(maxsize=None)
def _jax_case(arch, s=S) -> dict:
    """The JAX package's results on the ranks' weights and inputs: logits,
    greedy tokens, the leaves of the cache its prefill returns (in a cache
    of s + NEW), every gradient leaf of ``lm_loss`` and two train steps (at
    ``ROW_S``, of qwen2-7b only), all fp32 through its blocked
    references."""
    import jax.numpy as jnp
    from repro.models import lm_logits
    jcfg, jp, jt, jf = _jax_inputs(arch, s)
    f32 = dict(compute_dtype=jnp.float32, impl="blocked")
    ref = {"logits": np.asarray(lm_logits(jp, jcfg, jt, enc_frames=jf, **f32)),
           **_jax_greedy(arch, s, s + NEW)}
    if arch not in TRAIN_ARCHS or (s != S and arch != "qwen2-7b"):
        return ref
    ref["grads"] = _jax_grads(arch, s)
    ref["train"] = _jax_train(arch, s)
    return ref


@functools.lru_cache(maxsize=None)
def _jax_train(arch, s=S) -> dict:
    """Two of the JAX package's train steps on the ranks' weights and
    batches (``_train``'s configuration): losses, gradient norms and the
    updated parameters' leaves."""
    import jax
    import jax.numpy as jnp
    from repro.launch.train import make_train_step
    from repro.optim import AdamWConfig, adamw_init
    from repro_torch.data import TokenPipeline
    jcfg, jp, _, _ = _jax_inputs(arch, s)
    f32 = dict(compute_dtype=jnp.float32, impl="blocked")
    step = jax.jit(make_train_step(jcfg, AdamWConfig(**OPT), n_microbatches=2, **f32))
    params, opt, pipe = jp, adamw_init(jp), TokenPipeline(_cfg(arch), s, B, seed=1)
    losses, norms = [], []
    for _ in range(2):
        jb = {k: jnp.asarray(v) for k, v in pipe.next_batch().items()}
        params, opt, _, m = step(params, opt, None, jb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "params": [np.asarray(t) for t in jax.tree_util.tree_leaves(params)]}


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, s=S) -> list:
    """Every gradient leaf of the JAX package's ``lm_loss`` on the ranks'
    weights and first batch, fp32 through its blocked references."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm_loss
    from repro_torch.data import TokenPipeline
    jcfg, jp, _, _ = _jax_inputs(arch, s)
    batch = {k: jnp.asarray(v)
             for k, v in TokenPipeline(_cfg(arch), s, B, seed=1).next_batch().items()}
    f32 = dict(compute_dtype=jnp.float32, impl="blocked")
    # jax flattens dicts in sorted-key order, as tree_leaves does
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(
        jax.grad(lambda p: lm_loss(p, jcfg, batch, **f32))(jp))]


def _jax_moe_case(arch, seed, **moe):
    """JAX weights of one MoE period and an input, as numpy."""
    import jax
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.models import init_params as jax_init_params
    jcfg = JAX_ARCHS[arch].reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))["dec"]["pos0"]["moe"]
    jp = {k: np.array(v)[0] for k, v in jp.items()}
    return jcfg, jp, _moe_inputs(_moe_cfg(arch, **moe))


def _jax_moe(jcfg, jp, x):
    """The JAX package's ``moe_apply`` (global dispatch) with its auxiliary
    loss."""
    import jax.numpy as jnp
    from repro.models.moe import moe_apply
    y, aux = moe_apply(jnp.asarray(x), jp, jcfg, jnp.float32, return_aux=True)
    return np.asarray(y), float(aux)


def _references(s=S, train_archs=TRAIN_ARCHS, grad_archs=(), archs=ARCHS5) -> dict:
    """The one-device results the ranks' are held to, beside JAX's."""
    ref = {}
    for arch in archs:
        npw = _jax_weights(arch)
        ref[("logits", arch)] = _logits(arch, npw, s)
        ref[("cache", arch)] = []
        ref[("greedy", arch)] = _greedy(arch, npw, s, cache_out=ref[("cache", arch)])
    for arch in train_archs + tuple(grad_archs):
        npw = _jax_weights(arch)
        ref[("grads", arch)] = _grads(arch, npw, s)
        if arch in train_archs:
            ref[("train", arch)] = _train(arch, npw, s=s)
    return ref


def _check_train(got, want, jax_ref, what):
    """Train-step results against the one-device port's and JAX's."""
    from repro_torch.tree import tree_leaves
    for key in ("losses", "grad_norms"):
        for a, b, j in zip(got[key], want[key], jax_ref[key]):
            assert abs(a - b) <= REL * abs(b), (what, key, got[key], want[key])
            assert abs(a - j) <= REL * abs(j), (what, key, got[key], jax_ref[key])
    leaves = tree_leaves(got["params"])
    assert len(leaves) == len(jax_ref["params"])
    for a, b, j in zip(leaves, tree_leaves(want["params"]), jax_ref["params"]):
        assert a.shape == b.shape == j.shape
        assert _rel(a, b) <= REL, (what, _rel(a, b))
        assert _rel(a, j) <= GRAD_REL, (what, "jax", _rel(a, j))


def _check_models(res, ref):
    from repro_torch.launch.train import default_microbatches
    mesh = res["mesh"]
    for arch, nm in res["microbatches"].items():    # read from the mesh
        cfg = _cfg(arch)
        mdl = mesh["model"] if cfg.vocab_size % mesh["model"] == 0 else 1
        assert nm == default_microbatches(cfg, 256, 4096, dp_shards=mesh["data"],
                                          model_shards=mdl), arch
    for arch in ("jamba-v0.1-52b", "seamless-m4t-medium"):
        got, zero = res[("cache_layout", arch)]
        assert got == zero, arch
    for arch in ARCHS5:
        jax_ref = _jax_case(arch)
        got, want = res[("logits", arch)], ref[("logits", arch)]
        assert got.shape == want.shape == jax_ref["logits"].shape
        assert _rel(got, jax_ref["logits"]) <= REL, (arch, "jax", _rel(got, jax_ref["logits"]))
        assert _rel(got, want) <= REL, (arch, _rel(got, want))
        _check_leaves(res[("cache", arch)], ref[("cache", arch)], jax_ref["cache"],
                      (arch, "cache"))
        assert torch.equal(res[("greedy", arch)], jax_ref["greedy"]), arch
        assert torch.equal(res[("greedy", arch)], ref[("greedy", arch)]), arch
    for arch in TRAIN_ARCHS:
        _check_grads(res[("grads", arch)], ref[("grads", arch)], _jax_grads(arch), arch)
        _check_train(res[("train", arch)], ref[("train", arch)], _jax_case(arch)["train"], arch)
        # every loss call took the log-softmax over the vocab shards: one
        # backward, then _train's 2 steps of 2 microbatches
        assert res[("loss_shards", arch, "grads")] == 1, arch
        assert res[("loss_shards", arch, "train")] == 2 * 2, arch


def _check_grads(got, want, jax_ref, what):
    """Every gradient leaf against the one-device port's and JAX's."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(got)
    assert len(leaves) == len(jax_ref), what
    for a, b, j in zip(leaves, tree_leaves(want), jax_ref):
        assert a.shape == b.shape == j.shape
        assert _rel(a, j) <= GRAD_REL, (what, "jax", _rel(a, j))
        assert _rel(a, b) <= GRAD_REL, (what, _rel(a, b))


def test_mesh_data2_model2_matches_one_device(tmp_path):
    """(data=2, model=2): logits of five reduced architectures, prefill
    caches, greedy tokens, gradients and two train steps against the JAX
    package and the one-device port, jamba's 14 Mamba blocks a forward
    each projecting only its model rank's columns of ``in_proj`` (4 of 8
    SSD heads; ``ssm.counts``); gemma2-27b's gradients too (a tied head
    under a softcap of 30), every loss call on the vocab shards
    (``transformer.counts["loss_shards"]``); per-shard MoE dispatch (256
    tokens a shard, capacity
    factor 1.0 so experts overflow) against the JAX package's
    ``_moe_apply_global(groups=2)``, with the experts EP over model."""
    import jax.numpy as jnp
    from repro.models.moe import _moe_apply_global as jax_grouped
    jcfg, jp, x = _jax_moe_case("mixtral-8x22b", 3, capacity_factor=1.0)
    grad_archs = ("gemma2-27b",)
    finish = _spawn(tmp_path, 4, "models", model=2, weights={a: _jax_weights(a) for a in ARCHS5},
                    moe_cases={"grouped": ("mixtral-8x22b", dict(capacity_factor=1.0), jp, x)},
                    grad_archs=grad_archs)
    ref = _references(grad_archs=grad_archs)
    for arch in ARCHS5:                 # the JAX package's, while the ranks run
        _jax_case(arch)
    for arch in grad_archs:
        _jax_grads(arch)
    res = finish()
    for arch in grad_archs:
        _check_grads(res[("grads", arch)], ref[("grads", arch)], _jax_grads(arch), arch)
        assert res[("loss_shards", arch, "grads")] == 1, arch
    assert res["mesh"] == {"data": 2, "model": 2}
    assert res["length_model_at_S"] == 0         # the Q heads split over "model"
    for arch in ARCHS5:                 # jamba's 8 SSD heads, 4 a model rank
        assert res[("own_columns", arch)] == _mamba_blocks(_cfg(arch)), arch
    _check_heads(res, (128,) * 4, 0)    # a vocab of 256 divides 2: evenly
    _check_models(res, ref)
    want = np.asarray(jax_grouped(jnp.asarray(x), jp, jcfg, jnp.float32, groups=2))
    got = res[("moe", "grouped")].numpy()
    assert _rel(got, want) <= REL
    # the groups matter here: global dispatch gives another answer
    flat, aux = _jax_moe(jcfg, jp, x)
    assert _rel(flat, want) > 10 * REL
    # asked for the auxiliary loss, the mesh dispatches globally, as JAX does
    got, got_aux = res[("moe_aux", "grouped")]
    assert _rel(got, flat) <= REL and abs(float(got_aux) - aux) <= REL * aux
    one, one_aux = _moe(_moe_cfg("mixtral-8x22b", capacity_factor=1.0), jp, x, aux=True)
    assert _rel(got, one) <= REL and abs(float(got_aux) - float(one_aux)) <= REL * aux


@pytest.fixture(scope="module")
def model3_world(tmp_path_factory):
    """One spawn of 3 ranks as (data=1, model=3) for the model=3 tests:
    every check at S, the row split's at ROW_S and the decode's in a cache
    of ROW_MAX; the one-device and JAX references of each are computed
    while the ranks run."""
    moe_kw = dict(capacity_factor=1.0, d_ff_expert=48)
    jcfg, jp, x = _jax_moe_case("mixtral-8x22b", 4, **moe_kw)
    finish = _spawn(tmp_path_factory.mktemp("model3"), 3, "models", model=3,
                    weights={a: _jax_weights(a) for a in ARCHS5},
                    moe_cases={"tp": ("mixtral-8x22b", moe_kw, jp, x)}, row_s=ROW_S)
    ref = _references()
    rows = _references(ROW_S, train_archs=("qwen2-7b",))
    for arch in ARCHS5:
        rows[("cache", arch, ROW_MAX)] = []
        rows[("greedy", arch, ROW_MAX)] = _greedy(arch, _jax_weights(arch), ROW_S,
                                                  cache_out=rows[("cache", arch, ROW_MAX)],
                                                  max_len=ROW_MAX)
    for arch in ARCHS5:                 # the JAX package's, while the ranks run
        _jax_case(arch)
        _jax_case(arch, ROW_S)
        _jax_greedy(arch, ROW_S, ROW_MAX)
    res = finish()
    assert res["mesh"] == {"data": 1, "model": 3}
    return {"res": res, "ref": ref, "rows": rows, "moe": (jcfg, jp, x, moe_kw)}


def test_mesh_model3_head_fallback_and_pad_vocab(model3_world):
    """(data=1, model=3) at S = 16: 4 heads, 1-4 KV heads, the sequence and
    a vocab of 256 divide no axis of 3, so attention runs whole on every
    model rank (no self-attention takes the row split) and the loss pads
    the vocab to 258; an expert hidden dim of 48 is TP over model.  Every
    result against the JAX package and the one-device port."""
    from repro_torch.tree import tree_leaves
    res, ref = model3_world["res"], model3_world["ref"]
    jcfg, jp, x, moe_kw = model3_world["moe"]
    assert res["row_split_at_S"] == 0
    assert res["length_model_at_S"] == 0         # 3 divides no cache length of 20 or 16
    for arch in ARCHS5:                 # jamba's 8 SSD heads do not divide 3
        assert res[("own_columns", arch)] == 0, arch
    _check_models(res, ref)
    want, aux = _jax_moe(jcfg, jp, x)
    one, one_aux = _moe(_moe_cfg("mixtral-8x22b", **moe_kw), jp, x, aux=True)
    assert _rel(res[("moe", "tp")], want) <= REL and _rel(res[("moe", "tp")], one) <= REL
    got, got_aux = res[("moe_aux", "tp")]
    assert _rel(got, want) <= REL and abs(float(got_aux) - aux) <= REL * aux
    assert abs(float(got_aux) - float(one_aux)) <= REL * aux
    assert len(tree_leaves(res[("train", "qwen2-7b")]["params"])) > 0


def _check_heads(res, columns, per_call):
    """Each arch's ``lm_logits`` call, then its prefill and NEW decode
    steps: ``per_call`` head calls each took the uneven vocab split
    (``transformer.counts["head_columns"]``), every rank held ``columns``
    of the vocab, and the whole logits are (B, S, V), then (B, V)."""
    for arch in ARCHS5:
        V = _cfg(arch).vocab_size
        assert res[("head_columns", arch, "logits")] == per_call, arch
        assert res[("head_columns", arch, "greedy")] == per_call * (1 + NEW), arch
        assert res[("heads", arch)] == [(columns, (B, S, V))] + [(columns, (B, V))] * (1 + NEW)


def test_mesh_model3_head_splits_the_vocab_unevenly(model3_world):
    """(data=1, model=3) at S = 16: a vocab of 256 does not divide 3, so
    outside the loss each model rank computes only its own columns of the
    head (tied and untied), as DTensor's ``Shard`` splits them: 86, 86
    and 84.  ``lm_logits``, ``prefill`` and each decode step return the
    logits sharded so, whole (B, S, 256) and (B, 256) through
    ``full_tensor()``; one head call of each took the split.  Their values
    and tokens are held to the JAX package's and the one-device port's in
    ``test_mesh_model3_head_fallback_and_pad_vocab``."""
    _check_heads(model3_world["res"], (86, 86, 84), 1)


def _mamba_blocks(cfg) -> int:
    """The Mamba blocks of one ``lm_logits`` call."""
    return cfg.n_periods * sum(1 for b in cfg.pattern if b.kind == "mamba")


def _self_attentions(cfg) -> int:
    """The self-attentions of one ``lm_logits`` call: the decoder's and,
    in an encoder-decoder, the encoder's (each encoder layer has one)."""
    per = sum(1 for b in cfg.pattern if b.kind == "attn")
    return cfg.n_periods * per + (cfg.n_enc_layers if cfg.enc_dec else 0)


def _check_leaves(got, want, jax_ref, what):
    assert len(got) == len(want) == len(jax_ref), what
    for a, b, j in zip(got, want, jax_ref):
        assert a.shape == b.shape == j.shape, what
        assert _rel(a, j) <= REL, (what, "jax", _rel(a, j))
        assert _rel(a, b) <= REL, (what, _rel(a, b))


def test_mesh_model3_row_split_matches_jax_and_one_device(model3_world):
    """(data=1, model=3) at S = ROW_S = 18: the reduced models' 4 Q heads
    do not divide 3 and the sequence does, so every self-attention (the
    decoder's, and seamless's non-causal encoder's over 18 frames) takes the
    JAX package's row split: each model rank attends its 6 query rows
    (``q_offset`` 0, 6, 12; reduced windows of 16 meet the offset) against
    all 18 keys, and the output rows are gathered over "model".  Five
    archs' logits, prefill caches and greedy tokens (prefill through the
    kernel wrappers: the plain version with its offset), qwen2-7b's
    gradient leaves and two train steps, against the JAX package and the
    one-device port at the file's tolerances, every loss call on the vocab
    shards (``transformer.counts["loss_shards"]``)."""
    res, rows = model3_world["res"], model3_world["rows"]
    assert res["length_model_at_row_s"] == 0     # 3 divides no cache length of 22 or 16
    for arch in ARCHS5:
        cfg = _cfg(arch)
        assert res[("row_split", arch)] == _self_attentions(cfg), arch
        jax_ref = _jax_case(arch, ROW_S)
        got, want = res[("logits", arch, ROW_S)], rows[("logits", arch)]
        assert got.shape == want.shape == jax_ref["logits"].shape == (B, ROW_S, cfg.vocab_size)
        assert _rel(got, jax_ref["logits"]) <= REL, (arch, "jax", _rel(got, jax_ref["logits"]))
        assert _rel(got, want) <= REL, (arch, _rel(got, want))
        _check_leaves(res[("cache", arch, ROW_S)], rows[("cache", arch)], jax_ref["cache"],
                      (arch, "cache"))
        assert torch.equal(res[("greedy", arch, ROW_S)], jax_ref["greedy"]), arch
        assert torch.equal(res[("greedy", arch, ROW_S)], rows[("greedy", arch)]), arch
    jax_ref = _jax_case("qwen2-7b", ROW_S)
    _check_grads(res[("grads", "qwen2-7b", ROW_S)], rows[("grads", "qwen2-7b")],
                 jax_ref["grads"], "qwen2-7b row split")
    _check_train(res[("train", "qwen2-7b", ROW_S)], rows[("train", "qwen2-7b")],
                 jax_ref["train"], "qwen2-7b row split")
    assert res[("loss_shards", "qwen2-7b", ROW_S)] == 1 + 2 * 2   # every loss call


def _full_attentions(cfg) -> int:
    """The decoder's self-attention layers without a window."""
    return cfg.n_periods * sum(1 for b in cfg.pattern if b.kind == "attn" and not b.window)


def test_mesh_model3_decode_splits_the_cache_length_over_model(model3_world):
    """(data=1, model=3) at S = ROW_S = 18 with a cache of ROW_MAX = 30:
    the reduced models' 4 Q heads and 1-4 KV heads divide no model axis of
    3, so decode keeps all heads on every model rank, and 3 divides the 30
    slots of each full-attention cache: each rank holds 10 of them (prefill
    and ``init_decode_cache`` alike), the rank that owns the token's slot
    writes it, each decodes its live keys in partial mode and the partials
    are merged over "model".  At the first step (position 18, 19 live keys)
    rank 2's slots [20, 30) hold none, and over the NEW = 4 steps the
    token's slot moves from rank 1's shard to rank 2's.  Windowed layers
    (a ring of 16, which 3 does not divide) keep their length whole:
    mixtral's reduced layers all have a window, so none of its attentions
    splits.  Greedy tokens equal to the JAX package's and the one-device
    port's, the whole prefill cache within the file's tolerances of both,
    and the split counted once a full-attention layer and step
    (``attention.counts["length_model"]``)."""
    from torch.distributed.tensor import Shard
    from repro_torch.models.attention import cache_len
    res, rows = model3_world["res"], model3_world["rows"]
    for arch in ARCHS5:
        cfg = _cfg(arch)
        assert res[("length_model", arch)] == NEW * _full_attentions(cfg), arch
        jax_ref = _jax_greedy(arch, ROW_S, ROW_MAX)
        _check_leaves(res[("cache", arch, ROW_S, ROW_MAX)], rows[("cache", arch, ROW_MAX)],
                      jax_ref["cache"], (arch, "cache", ROW_MAX))
        assert torch.equal(res[("greedy", arch, ROW_S, ROW_MAX)], jax_ref["greedy"]), arch
        assert torch.equal(res[("greedy", arch, ROW_S, ROW_MAX)],
                           rows[("greedy", arch, ROW_MAX)]), arch
        got, zero = res[("cache_layout", arch, ROW_MAX)]
        assert got == zero, arch
        for i, blk in enumerate(cfg.pattern):
            if blk.kind != "attn":
                continue
            placements, shape, local = got[("pos" + str(i), "k")]
            Lc = cache_len(blk, ROW_MAX)
            split = not blk.window
            assert Lc == (ROW_MAX if split else 16) and shape[3] == Lc, (arch, i)
            assert local[3] == (Lc // 3 if split else Lc), (arch, i, local)
            assert (placements[-1] == Shard(3)) == split, (arch, i, placements)
    assert sum(res[("length_model", arch)] for arch in ARCHS5) > 0


def test_pod2_compressed_reduction(tmp_path):
    """pod=2: the bf16 and int8_ef reductions of two ranks' partial
    gradients within their quantisation bounds of the exact sum; int8 error
    feedback drives the mean over steps to the exact sum; no compression
    is the exact sum; two train steps over the two pods equal the JAX
    package's and one device's."""
    steps = 40
    finish = _spawn(tmp_path, 2, "pod", steps=steps, weights=_jax_weights("qwen2-7b"))
    ref = _train("qwen2-7b", _jax_weights("qwen2-7b"))
    jax_ref = _jax_case("qwen2-7b")["train"]
    res = finish()
    # the train step over two pods (uncompressed) is JAX's and one device's
    _check_train(res["train"], ref, jax_ref, "pod=2")
    for k, parts in res["parts"].items():
        exact = parts.double().sum(0)
        assert torch.allclose(res["none"][k].double(), exact, atol=1e-6)
        # bf16: each partial and the sum rounded to 8 significant bits
        bound = 3 * 2 ** -8 * parts.double().abs().sum(0) + 1e-12
        assert bool(((res["bf16"][k].double() - exact).abs() <= bound).all()), k
        # int8: one shared scale max|g| / 127; each rank's code rounds by half a step
        scale = parts.abs().max().double() / 127
        err = (res["int8_ef"][k].double() - exact).abs().max()
        assert err <= 2 * 0.5 * scale * 1.0001, (k, float(err), float(scale))
        # error feedback: the mean of many compressed sums converges
        mean_err = (res["int8_ef_mean"][k].double() - exact).abs().max()
        assert mean_err <= 0.02 and mean_err < err, (k, float(mean_err), float(err))


def test_pod1_reduction_equals_round_trip(tmp_path):
    """With one pod, the reduction is ``apply_grad_compression`` of the
    full gradients, exactly (int8: codes, scale and residual)."""
    from repro_torch.distributed import collectives
    res = _spawn(tmp_path, 4, "pod_one")()
    rng = np.random.default_rng(11)
    full = {"a": torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((256,)).astype(np.float32))}
    for method in ("bf16", "int8_ef"):
        r0 = collectives.compress_init(full) if method == "int8_ef" else None
        want, r1 = collectives.apply_grad_compression(full, method, r0)
        for k in full:
            assert torch.equal(res[method][k], want[k]), (method, k)
            if r1 is not None:
                assert torch.equal(res["residual"][k], r1[k]), k


def test_the_mesh_path_has_no_fallback(tmp_path):
    """Without a card the card mesh raises (nothing falls back to gloo), and
    a kernel wrapper handed a DTensor raises rather than running its plain
    version through DTensor's dispatch."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd as sm
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_process_group(str(tmp_path / "card"), 0, 1)
        assert not dist.is_initialized()
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(device="cpu")
    init_process_group(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        mesh = make_host_mesh(device="cpu")
        with pytest.raises(ValueError, match="256"):
            make_production_mesh(device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                make_host_mesh()
        d = lambda *s: DTensor.from_local(torch.randn(*s), mesh, [Replicate()] * 2)  # noqa: E731
        calls = {"flash_attention": lambda: fa.flash_attention(d(1, 2, 16, 16), d(1, 2, 16, 16),
                                                               d(1, 2, 16, 16)),
                 "flash_decode": lambda: fd.flash_decode(
                     d(1, 2, 16), d(1, 2, 16, 16), d(1, 2, 16, 16),
                     torch.full((1,), 16, dtype=torch.int32)),
                 "ssd_chunked": lambda: sm.ssd_chunked(
                     d(1, 32, 2, 16), d(1, 32, 2).abs(), -d(2).abs(), d(1, 32, 1, 16),
                     d(1, 32, 1, 16), chunk=16)}
        for name, call in calls.items():
            with pytest.raises(TypeError, match="DTensor"):
                call()
    finally:
        dist.destroy_process_group()
