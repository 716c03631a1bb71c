"""The decode position on the device.

``cache["pos"]`` is a 0-d int32 tensor on the cache's device, as the JAX
package's cache keeps an int32 array, and ``decode_step`` advances it
there: every layer computes its rotary angle, slot and valid length from
it on the device, so the step can be captured in a CUDA graph.  Checked
here: the tensor itself; greedy decode against the JAX package's through a
ring that wraps (a window of 16) and past the cache's end (the clamp of
``dynamic_update_slice``), fp32, tolerance 1e-4 on logits of scale ~1, as
tests/test_torch_models.py holds them; and a decode step on meta
parameters, cache and position, where any read of the position on the host
would raise.  ``BatchedServer`` refuses a CUDA graph on the CPU and under a
process group (the card's graphed server: tests/test_torch_serve_gpu.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import context as ctx
from repro_torch.launch.mesh import init_process_group, make_host_mesh
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import (decode_step, init_decode_cache, init_params,
                                params_from_jax, prefill)

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(compute_dtype=torch.float32, impl="blocked")
JF32 = dict(compute_dtype=jnp.float32, impl="blocked")

# (arch, depth, prompt, max_len, steps): jamba's one period (Mamba, MoE and
# full attention) decodes 5 positions past its cache of 10 slots; danube's
# window of 16 wraps 7 positions into its ring
CASES = {"jamba-v0.1-52b": (8, 6, 10, 10), "h2o-danube-3-4b": (2, 12, 32, 12)}


def _pair(name, layers):
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), n_layers=layers)
    cfg = dataclasses.replace(ARCHS[name].reduced(), n_layers=layers)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp))


def test_pos_is_a_device_tensor_that_advances():
    cfg = ARCHS["qwen2-7b"].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    zero = init_decode_cache(cfg, 2, 8, cache_dtype=torch.float32)
    assert zero["pos"].shape == () and zero["pos"].dtype == torch.int32
    assert zero["pos"].device == zero["layers"]["pos0"]["k"].device and zero["pos"] == 7
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5)))
    _, cache = prefill(params, cfg, toks, 8, cache_dtype=torch.float32, **F32)
    assert cache["pos"].shape == () and cache["pos"].dtype == torch.int32
    assert cache["pos"].device == cache["layers"]["pos0"]["k"].device
    for t in range(3):
        before = cache["pos"]
        _, cache = decode_step(params, cfg, cache, toks[:, t], **F32)
        assert cache["pos"].dtype == torch.int32 and cache["pos"] == 6 + t
        assert before == 5 + t                   # the step's input is left as it was


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_decode_past_the_window_and_the_cache_matches_jax(name):
    layers, S, max_len, steps = CASES[name]
    jcfg, cfg, jp, tp = _pair(name, layers)
    blk = next(b for b in cfg.pattern if b.kind == "attn")
    Lc = min(blk.window or max_len, max_len)
    assert S + steps > Lc                        # the ring wraps, or the clamp writes
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, S))
    lt, ct = prefill(tp, cfg, torch.from_numpy(toks), max_len, cache_dtype=torch.float32,
                     **F32)
    lj, cj = jax_prefill(jp, jcfg, jnp.asarray(toks), max_len, cache_dtype=jnp.float32,
                         **JF32)
    jstep = jax.jit(lambda c, t: jax_decode_step(jp, jcfg, c, t, **JF32))
    ours, theirs = [], []
    for t in range(steps):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=f"{name}: step {t}")
        ours.append(lt.argmax(-1).tolist())
        theirs.append(np.asarray(lj).argmax(-1).tolist())
        lt, ct = decode_step(tp, cfg, ct, lt.argmax(-1), **F32)
        lj, cj = jstep(cj, jnp.argmax(lj, -1).astype(jnp.int32))
    assert ours == theirs
    assert ct["pos"] == int(cj["pos"]) == S + steps
    for name_ in ("k", "v"):                     # the cache as the clamp or the ring left it
        np.testing.assert_allclose(ct["layers"][f"pos{cfg.pattern.index(blk)}"][name_].numpy(),
                                   np.asarray(cj["layers"][f"pos{cfg.pattern.index(blk)}"][
                                       name_]), **TOL)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "h2o-danube-3-4b"])
def test_decode_step_runs_on_meta(name):
    """Parameters, cache, position and token on meta: a step that read the
    position (or anything else) on the host would raise."""
    meta = torch.device("meta")
    cfg = ARCHS[name].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device=meta)
    cache = init_decode_cache(cfg, 2, 40, cache_dtype=torch.float32, device=meta)
    assert cache["pos"].device == meta
    logits, out = decode_step(params, cfg, cache, torch.empty((2,), dtype=torch.int64,
                                                               device=meta), **F32)
    assert logits.device == meta and logits.shape == (2, cfg.vocab_size)
    assert out["pos"].device == meta and out["pos"].shape == ()


def test_server_graph_only_on_the_card_and_off_a_process_group(tmp_path):
    """The CPU serves eagerly and refuses a graph; under a process group the
    step runs eagerly too, and asking for a graph raises."""
    cfg = ARCHS["qwen2-7b"].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert BatchedServer(cfg, params).graph is False
    with pytest.raises(ValueError, match="CUDA device"):
        BatchedServer(cfg, params, graph=True)
    init_process_group(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        ctx.set_mesh(make_host_mesh(model=1, device="cpu"))
        assert BatchedServer(cfg, params).graph is False
        with pytest.raises(NotImplementedError, match="process group"):
            BatchedServer(cfg, params, graph=True)
    finally:
        ctx.set_mesh(None)
        dist.destroy_process_group()
