"""The port's encoder-decoder path against the JAX package's on the same
weights: reduced seamless-m4t-medium (2 encoder and 2 decoder layers, 4 heads
of 16), weights drawn by JAX and carried across with ``params_from_jax``,
token ids and encoder frames from numpy seeds.

Covered: ``encode``, ``lm_logits`` with encoder frames as long as the prompt
and longer, ``prefill`` with its cross cache and ``enc_len`` followed by
decode steps, the cross-attention block alone, the port's ``plain`` path
(its kernels' plain versions) against JAX's ``pallas_interpret`` (the Pallas
kernels in interpret mode), and ``init_decode_cache``.  Both sides compute
in fp32; tolerance 1e-4 absolute and relative (summation order differs), as
in test_torch_models.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import attention as jax_attn
from repro.models import decode_step as jax_decode_step
from repro.models import encode as jax_encode
from repro.models import init_decode_cache as jax_init_decode_cache
from repro.models import init_params as jax_init_params
from repro.models import lm_logits as jax_lm_logits
from repro.models import prefill as jax_prefill
from repro_torch.configs.registry import ARCHS
from repro_torch.models import (decode_step, encode, init_decode_cache, lm_logits,
                                params_from_jax, prefill)
from repro_torch.models import attention as attn

NAME = "seamless-m4t-medium"
TOL = dict(atol=1e-4, rtol=1e-4)
# the port's impl beside the JAX package's: the references on both sides,
# and the kernels' plain versions beside the Pallas kernels in interpret mode
IMPLS = [("blocked", "blocked"), ("plain", "pallas_interpret")]


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = JAX_ARCHS[NAME].reduced(), ARCHS[NAME].reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp))


def _inputs(cfg, B, S, Se, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    frames = rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32)
    return toks, frames


def _close(ours, theirs, msg):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **TOL,
                               err_msg=msg)


def test_encode_matches_jax(pair):
    jcfg, cfg, jp, tp = pair
    _, frames = _inputs(cfg, 2, 1, 20)
    ours = encode(tp, cfg, torch.from_numpy(frames), compute_dtype=torch.float32,
                  impl="blocked")
    theirs = jax_encode(jp, jcfg, jnp.asarray(frames), compute_dtype=jnp.float32,
                        impl="blocked")
    assert ours.shape == (2, 20, cfg.d_model) and ours.dtype == torch.float32
    _close(ours, theirs, "encode")
    # the encoder attends both ways: the first frame's output moves with the
    # last frame (a causal stack would leave it bit-equal)
    changed = frames.copy()
    changed[:, -1] = np.random.default_rng(2).standard_normal(changed[:, -1].shape)
    other = encode(tp, cfg, torch.from_numpy(changed), compute_dtype=torch.float32,
                   impl="blocked")
    moved = float((other[:, 0] - ours[:, 0]).abs().max())
    assert moved > 1e-6, moved


@pytest.mark.parametrize("Se", [12, 20])
def test_lm_logits_with_frames_match_jax(pair, Se):
    """S = 12 decoder tokens against Se = 12 frames (as the server feeds)
    and Se = 20 (cross-attention with Sq != Sk)."""
    jcfg, cfg, jp, tp = pair
    toks, frames = _inputs(cfg, 2, 12, Se)
    ours = lm_logits(tp, cfg, torch.from_numpy(toks), enc_frames=torch.from_numpy(frames),
                     compute_dtype=torch.float32, impl="blocked")
    theirs = jax_lm_logits(jp, jcfg, jnp.asarray(toks), enc_frames=jnp.asarray(frames),
                           compute_dtype=jnp.float32, impl="blocked")
    assert ours.shape == (2, 12, cfg.vocab_size)
    _close(ours, theirs, f"lm_logits, Se={Se}")


def test_lm_logits_refuses_an_encoder_decoder_without_frames(pair):
    _, cfg, _, tp = pair
    with pytest.raises(ValueError, match="enc_frames"):
        lm_logits(tp, cfg, torch.zeros((1, 4), dtype=torch.long),
                  compute_dtype=torch.float32, impl="blocked")


@pytest.mark.parametrize("impl,jax_impl", IMPLS)
def test_prefill_and_decode_match_jax(pair, impl, jax_impl):
    """Prefill of 12 tokens over 20 frames, then 5 decode steps: the logits
    at every step, ``enc_len``, the cross cache (compute dtype, stacked over
    periods) and the self-attention cache against JAX's."""
    jcfg, cfg, jp, tp = pair
    B, S, T, Se = 2, 12, 5, 20
    toks, frames = _inputs(cfg, B, S + T, Se, seed=3)
    lt, ct = prefill(tp, cfg, torch.from_numpy(toks[:, :S]), S + T,
                     enc_frames=torch.from_numpy(frames), cache_dtype=torch.float32,
                     compute_dtype=torch.float32, impl=impl)
    lj, cj = jax_prefill(jp, jcfg, jnp.asarray(toks[:, :S]), S + T,
                         enc_frames=jnp.asarray(frames), cache_dtype=jnp.float32,
                         compute_dtype=jnp.float32, impl=jax_impl)
    _close(lt, lj, "prefill logits")
    assert ct["enc_len"] == cj["enc_len"] == Se and ct["pos"] == S
    for name in ("k", "v"):
        cross = ct["layers"]["pos0"]["cross"][name]
        assert cross.shape == (cfg.n_periods, B, cfg.n_kv_heads, Se, cfg.head_dim)
        assert cross.dtype == torch.float32
        _close(cross, cj["layers"]["pos0"]["cross"][name], f"cross cache {name}")
        _close(ct["layers"]["pos0"][name], cj["layers"]["pos0"][name], f"cache {name}")
    cross_before = ct["layers"]["pos0"]["cross"]["k"].clone()
    for t in range(T):
        tok = toks[:, S + t]
        lt, ct = decode_step(tp, cfg, ct, torch.from_numpy(tok),
                             compute_dtype=torch.float32, impl=impl)
        lj, cj = jax_decode_step(jp, jcfg, cj, jnp.asarray(tok, jnp.int32),
                                 compute_dtype=jnp.float32, impl=jax_impl)
        _close(lt, lj, f"decode step {t}")
    assert ct["pos"] == S + T
    # the cross cache is read, never written
    assert torch.equal(ct["layers"]["pos0"]["cross"]["k"], cross_before)


def test_prefill_cross_cache_is_in_the_compute_dtype(pair):
    """cache_dtype bf16 rounds the self-attention cache, not the cross cache,
    which the JAX package keeps in the compute dtype."""
    jcfg, cfg, jp, tp = pair
    toks, frames = _inputs(cfg, 1, 6, 9)
    _, ct = prefill(tp, cfg, torch.from_numpy(toks), 8, enc_frames=torch.from_numpy(frames),
                    cache_dtype=torch.bfloat16, compute_dtype=torch.float32, impl="blocked")
    _, cj = jax_prefill(jp, jcfg, jnp.asarray(toks), 8, enc_frames=jnp.asarray(frames),
                        cache_dtype=jnp.bfloat16, compute_dtype=jnp.float32, impl="blocked")
    entry, jentry = ct["layers"]["pos0"], cj["layers"]["pos0"]
    assert entry["k"].dtype == torch.bfloat16 and str(jentry["k"].dtype) == "bfloat16"
    assert entry["cross"]["k"].dtype == torch.float32
    assert str(jentry["cross"]["k"].dtype) == "float32"


@pytest.mark.parametrize("impl,jax_impl", IMPLS)
def test_cross_attention_block_matches_jax(pair, impl, jax_impl):
    """One decoder block's cross-attention alone (period 0): ``attn_apply``
    over a 20-frame memory from 7 decoder rows, and ``attn_decode``'s cross
    half over a cross cache with ``enc_len`` 13 of its 20 rows."""
    jcfg, cfg, jp, tp = pair
    blk, jblk = cfg.pattern[0], jcfg.pattern[0]
    p = {k: v[0] for k, v in tp["dec"]["pos0"]["attn"].items()}
    jpp = {k: v[0] for k, v in jp["dec"]["pos0"]["attn"].items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    ours, (kt, vt) = attn.attn_apply(
        torch.from_numpy(x), p, cfg, blk, causal=True, compute_dtype=torch.float32,
        kv_source=torch.from_numpy(mem), impl=impl, return_kv=True)
    theirs, (jkt, jvt) = jax_attn.attn_apply(
        jnp.asarray(x), jpp, jcfg, jblk, causal=True, compute_dtype=jnp.float32,
        kv_source=jnp.asarray(mem), impl=jax_impl, return_kv=True)
    _close(ours, theirs, "cross attn_apply")
    _close(kt, jkt, "cross K")
    _close(vt, jvt, "cross V")

    x1 = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    cache = {n: rng.standard_normal((2, cfg.n_kv_heads, 16, cfg.head_dim)).astype(np.float32)
             for n in ("k", "v")}
    cross = {n: rng.standard_normal((2, cfg.n_kv_heads, 20, cfg.head_dim)).astype(np.float32)
             for n in ("k", "v")}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    ours = attn.attn_decode(torch.from_numpy(x1), p, tcache, cfg, blk, pos=9,
                            compute_dtype=torch.float32,
                            cross_cache={n: torch.from_numpy(a) for n, a in cross.items()},
                            enc_len=13, impl=impl)
    theirs, jcache = jax_attn.attn_decode(
        jnp.asarray(x1), jpp, {n: jnp.asarray(a) for n, a in cache.items()}, jcfg, jblk,
        pos=9, compute_dtype=jnp.float32,
        cross_cache={n: jnp.asarray(a) for n, a in cross.items()}, enc_len=13,
        impl=jax_impl)
    _close(ours, theirs, "cross attn_decode")
    _close(tcache["k"], jcache["k"], "self cache after the write")
    # the rows past enc_len are not read
    cross_far = {n: a.copy() for n, a in cross.items()}
    for a in cross_far.values():
        a[:, :, 13:] = 1e3
    again = attn.attn_decode(torch.from_numpy(x1), p,
                             {n: torch.from_numpy(a.copy()) for n, a in cache.items()},
                             cfg, blk, pos=9, compute_dtype=torch.float32,
                             cross_cache={n: torch.from_numpy(a) for n, a in cross_far.items()},
                             enc_len=13, impl=impl)
    torch.testing.assert_close(again, ours, atol=0, rtol=0)


@pytest.mark.parametrize("cache_dtype,jax_dtype", [(torch.bfloat16, jnp.bfloat16),
                                                   (torch.float32, jnp.float32)])
def test_init_decode_cache_matches_jax(pair, cache_dtype, jax_dtype):
    """The same keys, shapes and dtypes as JAX's zero cache, ``pos`` =
    max_len - 1 and ``enc_len``; a decode step from it gives JAX's logits."""
    jcfg, cfg, jp, tp = pair
    B, L, Se = 2, 16, 7
    ours = init_decode_cache(cfg, B, L, cache_dtype=cache_dtype, enc_len=Se)
    theirs = jax_init_decode_cache(jcfg, B, L, cache_dtype=jax_dtype, enc_len=Se)
    jflat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    jleaves = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
               for k, v in jflat if hasattr(v, "shape") and v.ndim}
    tleaves = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + f"[{k!r}]")
            elif isinstance(v, torch.Tensor) and v.ndim:     # as jleaves: pos apart
                tleaves[path + f"[{k!r}]"] = (tuple(v.shape), str(v.dtype).split(".")[1])
    walk(ours, "")
    assert tleaves == jleaves
    assert set(ours) == set(theirs) == {"pos", "layers", "enc_len"}
    assert ours["pos"] == int(theirs["pos"]) == L - 1
    assert ours["pos"].dtype == torch.int32 and str(theirs["pos"].dtype) == "int32"
    assert ours["enc_len"] == theirs["enc_len"] == Se
    tok = np.array([3, 11])
    lt, _ = decode_step(tp, cfg, ours, torch.from_numpy(tok), compute_dtype=torch.float32,
                        impl="blocked")
    lj, _ = jax_decode_step(jp, jcfg, theirs, jnp.asarray(tok, jnp.int32),
                            compute_dtype=jnp.float32, impl="blocked")
    _close(lt, lj, "decode step from the zero cache")
