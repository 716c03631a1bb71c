"""Long-context decode with the attention cache's length sharded over the
data-parallel ranks, against the JAX package.

Where the data axes do not divide the decode batch (a batch of 1) and do
divide an attention cache's length, the port splits that length over them
(``context.length_spec``), as the JAX package's ``cache_shardings`` puts
the cache's largest dim over (pod, data).  Each rank decodes its shard
with ``flash_decode``'s partial mode, and the ranks' (o, M, l) are merged
(``spmd.merge_over``, ``flash_decode.merge_partials``).

* (a) The length entry against ``cache_shardings`` on a
  ``jax.sharding.AbstractMesh``: equal for a batch-1 cache; a batch that
  divides keeps its rows over the data axes (the JAX package puts the
  length there instead: a kept difference); one data rank never splits.
  Where no head count divides "model" (reduced and full qwen2-7b), the
  length goes over "model" and the rows stay over "data", where
  ``cache_shardings`` puts the length over "data" (and, at full size, the
  batch over "model"): the kept difference, stated.
* (b) The partial decode of 1, 2, 4 and 8 length shards (the plain
  version through the kernel wrapper, and the reference), merged, against
  the JAX package's ``ops.decode_attention`` over the whole cache, rep 4,
  softcap on and off, with shards past ``valid_len``.  fp32; 1e-5 absolute
  on outputs of scale ~1 (``test_torch_decode.py``'s).  An empty shard
  gives o = 0, M = -1e30, l = 0 exactly.
* (c) Reduced jamba, gemma2 and seamless at a batch of 1 on gloo ranks
  (the spawn harness of ``test_torch_mesh.py``): 2 ranks (data=2), 4 ranks
  (pod=2, data=2) and 4 ranks (data=2, model=2).  gemma2 decodes past its
  window, so its ring wraps; seamless's self-attention cache splits and
  its cross cache (random frames) stays whole.  Greedy tokens equal to the
  JAX package's ``decode_step`` and the unsharded port's, logits within
  ``REL`` (1e-5 relative to the largest magnitude) of both; every rank
  holds Lc / dp keys of each attention cache, and the shards together
  equal the unsharded cache within ``REL``; ``BatchedServer`` serves a
  batch of 1 with the unsharded server's tokens.
* (d) A ``long_500k`` dry-run record of jamba at full width and 8 layers
  (one period) on the fake 256-rank mesh: against the same trace with the
  length kept whole, the attention's dot FLOPs and cache bytes a rank fall
  to 1/16, and the gathered partials add B x Hq x (D + 2) fp32 a rank to
  the collective bytes over "data".
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_mesh import REL, _cfg, _jax_weights, _place, _rel, _weights, _whole

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=0)             # fp32 decode, outputs of scale ~1
ARCHS2 = ("jamba-v0.1-52b", "gemma2-27b")
MESH_ARCHS = ARCHS2 + ("seamless-m4t-medium",)     # (c): its cross cache stays whole
LS, LML, LNEW = 12, 32, 10      # prompt, max_len, decode steps: gemma2's ring of 16 wraps
SERVE_PROMPTS = (12, 7)         # BatchedServer's two requests, one at a time


# ---------------------------------------------------------------------------
# (a) the layout rule against cache_shardings
# ---------------------------------------------------------------------------


class _Mesh:
    """The two things the layout rules read of a ``DeviceMesh``: its axis
    names and sizes (rank 0 of every axis)."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, i):
        return self._sizes[i]

    def get_local_rank(self, axis):
        return 0


def _entry(e):
    """A spec entry as a tuple of axis names (None as ())."""
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def _port_kv_specs(arch, axes, batch, max_len=64, full=False):
    """{pos: the k leaf's spec} of every attention position under ``axes``
    (the reduced config, or with ``full`` the registry's)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import context as ctx
    from repro_torch.models.transformer import _cache_specs
    cfg = get_arch(arch) if full else _cfg(arch)
    ctx.set_mesh(_Mesh(**axes))
    try:
        return {f"pos{i}": _cache_specs(cfg, blk, batch, max_len)["k"]
                for i, blk in enumerate(cfg.pattern) if blk.kind == "attn"}
    finally:
        ctx.set_mesh(None)


def _jax_kv_specs(arch, axes, batch, max_len=64, full=False):
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.distributed.sharding import cache_shardings
    from repro.models import init_decode_cache
    jcfg = JAX_ARCHS[arch] if full else JAX_ARCHS[arch].reduced()
    cache = jax.eval_shape(lambda: init_decode_cache(jcfg, batch, max_len))
    sh = cache_shardings(cache, AbstractMesh(tuple(axes.values()), tuple(axes)), jcfg)
    return {pos: tuple(sh["layers"][pos]["k"].spec)
            for pos in _port_kv_specs(arch, axes, batch, max_len, full)}


@pytest.mark.parametrize("arch", ARCHS2)
@pytest.mark.parametrize("axes", [dict(data=2, model=1), dict(data=2, model=2),
                                  dict(pod=2, data=2, model=1)],
                         ids=["data2", "data2_model2", "pod2_data2"])
def test_length_entry_equals_cache_shardings(arch, axes):
    port = _port_kv_specs(arch, axes, 1)
    ref = _jax_kv_specs(arch, axes, 1)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    for pos, spec in port.items():
        assert _entry(spec[3]) == _entry(ref[pos][3]) == dp, (pos, spec, ref[pos])
        assert spec[1] is None                       # the batch of 1 stays whole
    # a batch that divides keeps its rows; the reference puts the length there
    port4, ref4 = _port_kv_specs(arch, axes, 4), _jax_kv_specs(arch, axes, 4)
    for pos, spec in port4.items():
        assert _entry(spec[1]) == dp and spec[3] is None
        assert _entry(ref4[pos][3]) == dp


def test_length_entry_over_model_where_the_heads_do_not_divide():
    """Reduced qwen2-7b (4 Q heads, 1 KV head of 16) on (data=2, model=3)
    at batch 4 and max_len 24: the rows go over "data", no head count
    divides 3, so the length of 24 goes over "model".  The JAX package's
    ``cache_shardings`` on the same mesh puts the length over "data" and
    nothing over "model" (none of 16, 4 and 1 divides 3).  At
    ``decode_32k``'s full size (batch 128, 32 768 keys, 4 KV heads) on
    (data=16, model=16) the port keeps the rows over "data" and puts the
    length over "model", the reference the length over "data" and the
    batch over "model": the same share of the cache a rank, a kept
    difference."""
    axes = dict(data=2, model=3)
    for pos, spec in _port_kv_specs("qwen2-7b", axes, 4, 24).items():
        assert (_entry(spec[1]), spec[2], _entry(spec[3])) == (("data",), None, ("model",))
    for pos, spec in _jax_kv_specs("qwen2-7b", axes, 4, 24).items():
        assert [_entry(e) for e in spec[1:]] == [(), (), ("data",), ()], (pos, spec)
    prod = dict(data=16, model=16)
    port = _port_kv_specs("qwen2-7b", prod, 128, 32768, full=True)
    ref = _jax_kv_specs("qwen2-7b", prod, 128, 32768, full=True)
    for pos, spec in port.items():
        assert [_entry(e) for e in spec[1:]] == [("data",), (), ("model",), ()], (pos, spec)
        assert [_entry(e) for e in ref[pos][1:]] == [("model",), (), ("data",), ()], ref[pos]


def test_one_data_rank_never_splits_the_length():
    for arch in ARCHS2:
        for spec in _port_kv_specs(arch, dict(data=1, model=2), 1).values():
            assert spec[3] is None


# ---------------------------------------------------------------------------
# (b) partial decodes of length shards, merged, against the whole cache
# ---------------------------------------------------------------------------


def _decode_inputs(seed=0, B=3, Hq=8, Hkv=2, L=64, D=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, L, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, L, D)).astype(np.float32)
    return q, k, v, np.array([1, 23, L], np.int32)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("impl", ["kernel", "blocked"])
def test_partial_shards_merged_match_the_whole_cache(shards, softcap, impl):
    """rep 4 (8 query heads over 2 KV heads); valid_len 1, 23 and 64 of 64
    keys, so at 4 and 8 shards the shards past a row's valid_len are
    empty.  ``impl="kernel"`` on CPU tensors runs the wrapper's plain
    version, "blocked" the reference."""
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import merge_partials
    q, k, v, vl = _decode_inputs()
    L = k.shape[2]
    Lr = L // shards
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    parts = []
    for r in range(shards):
        live = np.clip(vl - r * Lr, 0, Lr).astype(np.int32)
        o, M, l = ops.decode_attention(tq, tk[:, :, r * Lr:(r + 1) * Lr],
                                       tv[:, :, r * Lr:(r + 1) * Lr], torch.from_numpy(live),
                                       softcap=softcap, impl=impl, partial=True)
        assert o.dtype == M.dtype == l.dtype == torch.float32
        empty = torch.from_numpy(live == 0)
        assert torch.equal(o[empty], torch.zeros_like(o[empty]))
        assert bool((M[empty] == -1e30).all() and (l[empty] == 0).all())
        assert bool(torch.isfinite(o).all() and torch.isfinite(M).all())
        parts.append((o, M, l))
    if shards >= 4:
        assert any(bool((p[2] == 0).any()) for p in parts)     # empty shards were merged
    out = merge_partials(*(torch.stack(t) for t in zip(*parts)))
    ref = np.asarray(jax_ops.decode_attention(*map(jnp.asarray, (q, k, v, vl)),
                                              softcap=softcap))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_merge_of_empty_partials_is_zero():
    from repro_torch.kernels.flash_decode import merge_partials
    o = torch.zeros((3, 1, 4, 16))
    M = torch.full((3, 1, 4), -1e30)
    out = merge_partials(o, M, torch.zeros((3, 1, 4)))
    assert torch.equal(out, torch.zeros((1, 4, 16)))


def test_partial_mode_against_jax_interpret_kernel():
    """The port's plain partial over 4 shards, merged, against the JAX
    package's Pallas kernel in interpret mode over the whole cache."""
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode as jax_flash_decode
    from repro_torch.kernels.flash_decode import flash_decode_plain, merge_partials
    q, k, v, vl = _decode_inputs(seed=1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    parts = [flash_decode_plain(tq, tk[:, :, 16 * r:16 * (r + 1)], tv[:, :, 16 * r:16 * (r + 1)],
                                torch.from_numpy(np.clip(vl - 16 * r, 0, 16).astype(np.int32)),
                                softcap=30.0, splits=2, partial=True) for r in range(4)]
    out = merge_partials(*(torch.stack(t) for t in zip(*parts)))
    ref = np.asarray(jax_flash_decode(*map(jnp.asarray, (q, k, v, vl)), softcap=30.0,
                                      block_k=128, interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# ---------------------------------------------------------------------------
# (c) batch-1 decode on gloo ranks
# ---------------------------------------------------------------------------


def _frames(cfg):
    """An encoder-decoder's random frames (1, LS, d_model), else None."""
    if not cfg.enc_dec:
        return None
    return np.random.default_rng(5).standard_normal((1, LS, cfg.d_model)).astype(np.float32)


def _long(arch, npw):
    """Prefill a batch-1 prompt of LS tokens (max_len LML) and LNEW greedy
    decode steps through the kernel wrappers (their plain versions on CPU
    tensors); then BatchedServer at batch 1 (the blocked references).
    Returns the logits, tokens, each attention cache whole and each
    rank's length of it (the cross cache's too), and the server's
    outputs."""
    from repro_torch.distributed import context as ctx
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import decode_step, prefill
    cfg = _cfg(arch)
    params = _place(_weights(cfg, npw), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, LS)))
    kw = dict(compute_dtype=torch.float32, impl="kernel")
    frames = _frames(cfg)
    with torch.no_grad():
        logits, cache = prefill(params, cfg, toks, LML, cache_dtype=torch.float32,
                                enc_frames=None if frames is None else torch.from_numpy(frames),
                                **kw)
        steps = [_whole(logits)]
        for _ in range(LNEW):
            logits, cache = decode_step(params, cfg, cache, torch.argmax(steps[-1], -1), **kw)
            steps.append(_whole(logits))
    attn = {f"pos{i}": cache["layers"][f"pos{i}"] for i, b in enumerate(cfg.pattern)
            if b.kind == "attn"}
    rng = np.random.default_rng(4)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n), LNEW)
            for i, n in enumerate(SERVE_PROMPTS)]
    BatchedServer(cfg, params, batch_size=1, max_len=LML).run(reqs)
    return {"logits": torch.stack(steps, 1),
            "tokens": torch.argmax(torch.stack(steps, 1), -1),
            "cache": {p: {n: _whole(c[n]).clone() for n in ("k", "v")} for p, c in attn.items()},
            "local_len": {p: ctx.local(c["k"]).shape[3] for p, c in attn.items()},
            "cross_len": {p: ctx.local(c["cross"]["k"]).shape[3] for p, c in attn.items()
                          if "cross" in c},
            "served": [r.output for r in reqs]}


def _world(rank, model, pod, weights):
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=model, device="cpu", pod=pod)
    ctx.set_mesh(mesh)
    out = {"dp": spmd.dp_size()}
    for arch in MESH_ARCHS:
        out[arch] = _long(arch, weights[arch])
    ctx.set_mesh(None)
    return out


WORLDS = {"data2": (2, dict(model=1, pod=None)),
          "pod2_data2": (4, dict(model=1, pod=2)),
          "data2_model2": (4, dict(model=2, pod=None))}


def _rank_main(rank, world, store, out_dir, job, kw):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group
    torch.set_num_threads(1)
    init_process_group(store, rank, world, device="cpu")
    try:
        result = _world(rank, **kw)
        if rank == 0:
            torch.save(result, os.path.join(out_dir, f"{job}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(tmp, job, **kw):
    """Start the ranks of ``job``; ``finish()`` waits for them (raising a
    rank's error) and returns rank 0's result."""
    world, mesh_kw = WORLDS[job]
    procs = mp.start_processes(_rank_main, args=(world, os.path.join(tmp, f"store-{job}"),
                                                 tmp, job, dict(mesh_kw, **kw)),
                               nprocs=world, start_method="spawn", join=False)

    def finish():
        while not procs.join():
            pass
        return torch.load(os.path.join(tmp, f"{job}.pt"), weights_only=False)
    return finish


def _jax_long(arch):
    """The JAX package's prefill and LNEW greedy decode steps on the same
    weights and prompt: fp32 through its blocked references."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.models import decode_step, prefill
    jcfg = JAX_ARCHS[arch].reduced()
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_weights(arch))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, LS))
    f32 = dict(compute_dtype=jnp.float32, impl="blocked")
    frames = _frames(jcfg)
    logits, cache = prefill(jp, jcfg, jnp.asarray(toks), LML, cache_dtype=jnp.float32,
                            enc_frames=None if frames is None else jnp.asarray(frames), **f32)
    steps = [np.asarray(logits)]
    for _ in range(LNEW):
        logits, cache = decode_step(jp, jcfg, cache,
                                    jnp.asarray(np.argmax(steps[-1], -1), jnp.int32), **f32)
        steps.append(np.asarray(logits))
    return np.stack(steps, 1)


@pytest.fixture(scope="module")
def long_runs(tmp_path_factory):
    """Every world's ranks (spawned first, run meanwhile), the unsharded
    port's results and the JAX package's."""
    tmp = str(tmp_path_factory.mktemp("long_decode"))
    weights = {arch: _jax_weights(arch) for arch in MESH_ARCHS}
    running = {job: _spawn(tmp, job, weights=weights) for job in WORLDS}
    one = {arch: _long(arch, weights[arch]) for arch in MESH_ARCHS}
    jax_ref = {arch: _jax_long(arch) for arch in MESH_ARCHS}
    return {job: finish() for job, finish in running.items()}, one, jax_ref


@pytest.mark.parametrize("arch", MESH_ARCHS)
@pytest.mark.parametrize("job", list(WORLDS))
def test_batch1_decode_matches_jax_and_one_device(long_runs, job, arch):
    ranks, one, jax_ref = long_runs
    got = ranks[job][arch]
    assert torch.equal(got["tokens"], one[arch]["tokens"])
    assert np.array_equal(got["tokens"].numpy(), np.argmax(jax_ref[arch], -1))
    assert _rel(got["logits"], one[arch]["logits"]) < REL
    assert _rel(got["logits"], jax_ref[arch]) < REL


@pytest.mark.parametrize("arch", MESH_ARCHS)
@pytest.mark.parametrize("job", list(WORLDS))
def test_each_rank_holds_its_length_shard(long_runs, job, arch):
    """Every attention cache's length over the data ranks: Lc / dp keys a
    rank (gemma2: its window of 16 and its global 32), the shards together
    the unsharded cache."""
    from repro_torch.models.attention import cache_len
    ranks, one, _ = long_runs
    got, dp, cfg = ranks[job][arch], ranks[job]["dp"], _cfg(arch)
    assert dp > 1
    for i, blk in enumerate(cfg.pattern):
        pos = f"pos{i}"
        if blk.kind != "attn":
            continue
        assert got["local_len"][pos] == cache_len(blk, LML) // dp
        assert one[arch]["local_len"][pos] == cache_len(blk, LML)
        assert got["cross_len"].get(pos) == one[arch]["cross_len"].get(pos)
        for n in ("k", "v"):
            assert _rel(got["cache"][pos][n], one[arch]["cache"][pos][n]) < REL


@pytest.mark.parametrize("arch", MESH_ARCHS)
@pytest.mark.parametrize("job", list(WORLDS))
def test_server_serves_a_batch_of_one_on_the_mesh(long_runs, job, arch):
    ranks, one, _ = long_runs
    assert ranks[job][arch]["served"] == one[arch]["served"]
    assert [len(o) for o in one[arch]["served"]] == [LNEW] * len(SERVE_PROMPTS)


# ---------------------------------------------------------------------------
# (d) the dry run's long_500k record
# ---------------------------------------------------------------------------

_DRYRUN = """
import dataclasses, json
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import context as ctx
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"), n_layers=8)
cell = SHAPES_BY_NAME["long_500k"]
mesh = dryrun.production_mesh(False)
out = {}
for tag in ("split", "whole"):
    if tag == "whole":                      # the length kept whole, as before
        ctx.length_spec = lambda batch, length: None
    rec = dryrun.analyze(cfg, cell, dryrun.trace_cell(cfg, cell, mesh), mesh)
    out[tag] = {"dot": rec["hlo_dot_flops"], "args": rec["memory"]["argument_bytes"],
                "coll": rec["collectives"]["by_axis"],
                "sites": rec["top_collective_sites"]}
print(json.dumps(out))
"""


def test_long_500k_record_splits_the_attention_over_data():
    """jamba at full width, one period (1 attention layer): 32 Q heads and
    8 KV heads on model = 16 give each model rank 2 Q heads reading 1 KV
    head, whose 8 KV heads of the cache stay whole (8 does not divide 16);
    the length of 524 288 keys over data = 16."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", _DRYRUN], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    split, whole = got["split"], got["whole"]
    B, L, D, dp, hq, hkv_cache = 1, 524288, 128, 16, 2, 8
    # q K^T and p V over 2 heads (each rank's Q heads, its KV head repeated)
    attn_dot = 2 * (2 * B * hq * L * D)
    assert whole["dot"] - split["dot"] == attn_dot - attn_dot // dp
    kv_bytes = 2 * (B * hkv_cache * L * D * 2)          # bf16 K and V, one period
    assert whole["args"] - split["args"] == kv_bytes - kv_bytes // dp
    gathered = dp * B * hq * (D + 2) * 4                 # (o, M, l) of every data rank
    assert split["coll"]["data"] - whole["coll"]["data"] == gathered
    assert split["coll"]["model"] == whole["coll"]["model"]
