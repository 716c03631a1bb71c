"""The port's LM stack against the JAX package's on the same weights.

JAX's ``init_params`` draws the weights; ``params_from_jax`` carries them
across.  Logits of the full forward, of prefill and of decode steps are held
against JAX's, both packages on their ``blocked`` references in fp32.
Tolerance: 1e-4 absolute and relative on logits whose scale is ~1 (both
sides compute in fp32; summation order differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import lm_logits as jax_lm_logits
from repro.models import prefill as jax_prefill
from repro.models.moe import moe_apply as jax_moe_apply
from repro_torch.configs.registry import ARCHS
from repro_torch.models import (decode_step, init_params, lm_logits,
                                params_from_jax, prefill)
from repro_torch.models.moe import capacity, moe_apply

TOL = dict(atol=1e-4, rtol=1e-4)
PARITY_ARCHS = ["jamba-v0.1-52b", "qwen2-7b", "mamba2-780m", "gemma2-27b"]


def _pair(name, seed=0):
    jcfg = JAX_ARCHS[name].reduced()
    cfg = ARCHS[name].reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, params_from_jax(cfg, tree)


def _close(ours, theirs, msg):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **TOL,
                               err_msg=msg)


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_logits_prefill_and_decode_match_jax(name):
    jcfg, cfg, jp, tp = _pair(name)
    B, S, T = 2, 20, 5
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + T))
    f32 = dict(compute_dtype=torch.float32, impl="blocked")
    jf32 = dict(compute_dtype=jnp.float32, impl="blocked")

    _close(lm_logits(tp, cfg, torch.from_numpy(toks[:, :S]), **f32),
           jax_lm_logits(jp, jcfg, jnp.asarray(toks[:, :S]), **jf32),
           f"{name}: lm_logits")

    lt, ct = prefill(tp, cfg, torch.from_numpy(toks[:, :S]), S + T,
                     cache_dtype=torch.float32, **f32)
    lj, cj = jax_prefill(jp, jcfg, jnp.asarray(toks[:, :S]), S + T,
                         cache_dtype=jnp.float32, **jf32)
    _close(lt, lj, f"{name}: prefill logits")
    for t in range(T):
        tok = toks[:, S + t]
        lt, ct = decode_step(tp, cfg, ct, torch.from_numpy(tok), **f32)
        lj, cj = jax_decode_step(jp, jcfg, cj, jnp.asarray(tok, jnp.int32), **jf32)
        _close(lt, lj, f"{name}: decode step {t}")
    assert ct["pos"] == S + T


# the archs of tests/test_decode_consistency.py
CONSISTENCY_ARCHS = ["qwen2-7b", "gemma2-27b", "mamba2-780m", "jamba-v0.1-52b",
                     "mixtral-8x22b", "h2o-danube-3-4b", "seamless-m4t-medium",
                     "phi-3-vision-4.2b", "nemotron-4-15b", "moonshot-v1-16b-a3b"]


@pytest.mark.parametrize("name", CONSISTENCY_ARCHS)
def test_prefill_then_decode_matches_full_forward(name):
    """Teacher forcing on the port alone: prefill then decode steps give the
    full forward's logits (tests/test_decode_consistency.py's check, same
    shapes and tolerance)."""
    cfg = ARCHS[name].reduced()
    B, S, T = 2, 12, 6
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + T)))
    extras = {}
    if cfg.modality == "vision" and cfg.n_prefix_embeds:
        extras["prefix_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        extras["enc_frames"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    f32 = dict(compute_dtype=torch.float32)
    full = lm_logits(params, cfg, toks, **f32, **extras)
    logits_p, cache = prefill(params, cfg, toks[:, :S], S + T,
                              cache_dtype=torch.float32, **f32, **extras)
    torch.testing.assert_close(logits_p, full[:, S - 1], atol=2e-3, rtol=2e-3)
    for t in range(T - 1):
        logits_d, cache = decode_step(params, cfg, cache, toks[:, S + t], **f32)
        torch.testing.assert_close(logits_d, full[:, S + t], atol=2e-3, rtol=2e-3,
                                   msg=f"{name}: decode step {t}")


def test_moe_capacity_drops_match_jax():
    """capacity_factor 1.25 at 64 tokens x top-2 over 4 experts: the tokens
    share a common component (as hidden states do), so routing is skewed,
    some tokens overflow their expert and are dropped; which ones, and the
    combined output, must match the JAX package's flat dispatch."""
    name = "mixtral-8x22b"
    jcfg = JAX_ARCHS[name].reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=1.25))
    cfg = dataclasses.replace(ARCHS[name].reduced(), moe=dataclasses.replace(
        ARCHS[name].reduced().moe, capacity_factor=1.25))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3))["dec"]["pos0"]["moe"]
    jp = jax.tree_util.tree_map(lambda a: np.array(a)[0], jp)      # period 0
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 16, cfg.d_model))
         + 2.0 * rng.standard_normal(cfg.d_model)).astype(np.float32)

    ours = moe_apply(torch.from_numpy(x), tp, cfg, torch.float32)
    theirs = jax_moe_apply(jnp.asarray(x), jp, jcfg, jnp.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-5)

    # the case must really drop: some expert is asked for more than cap slots
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.moe import top_k
    h = norm_apply(torch.from_numpy(x), tp["norm"], cfg).reshape(-1, cfg.d_model)
    _, idx = top_k(torch.softmax(h @ tp["router"], dim=-1), cfg.moe.top_k)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.n_experts)
    assert int(counts.max()) > capacity(64, cfg), (counts, capacity(64, cfg))
    # and dropping changes the answer: a dropless run differs
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    assert not torch.allclose(moe_apply(torch.from_numpy(x), tp, roomy, torch.float32),
                              ours, atol=1e-5)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    from repro_torch.models.moe import top_k
    tv, ti = top_k(probs, 2)
    assert ti.tolist() == np.asarray(idx).tolist()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vals))


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "seamless-m4t-medium"])
def test_init_params_matches_the_jax_layout(name):
    """The port's own init draws the same tree as the JAX package's: the same
    keys, shapes, and fp32 leaves where the JAX package keeps fp32 (Jamba's
    Mamba leaves; seamless's encoder stack and cross-attention)."""
    jp = jax_init_params(JAX_ARCHS[name].reduced(), jax.random.PRNGKey(0))
    tp = init_params(ARCHS[name].reduced(), torch.Generator().manual_seed(0),
                     dtype=torch.bfloat16)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    jshapes = {jax.tree_util.keystr(k): v.shape for k, v in jflat}
    tshapes, dtypes = {}, {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + f"[{k!r}]")
            else:
                tshapes[path + f"[{k!r}]"] = tuple(v.shape)
                dtypes[k] = v.dtype
    walk(tp, "")
    assert tshapes == jshapes
    if name == "jamba-v0.1-52b":
        assert dtypes["A_log"] == dtypes["norm"] == dtypes["D_skip"] == torch.float32
        assert dtypes["in_proj"] == dtypes["w_gate"] == torch.bfloat16
    else:
        assert dtypes["c_norm"] == dtypes["enc_final_norm"] == torch.float32
        assert dtypes["c_wq"] == dtypes["w_up"] == torch.bfloat16
        # and params_from_jax keeps the same leaves in fp32
        conv = params_from_jax(ARCHS[name].reduced(),
                               jax.tree_util.tree_map(np.asarray, jp), dtype=torch.bfloat16)
        assert conv["enc_final_norm"].dtype == torch.float32
        assert conv["dec"]["pos0"]["attn"]["c_norm"].dtype == torch.float32
        assert conv["enc"]["pos0"]["attn"]["wq"].dtype == torch.bfloat16
