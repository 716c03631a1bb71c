"""The own-KV-heads route on gloo ranks of the CPU, as (data=1, model=4),
against the JAX package and the one-device port from the same weights.

Where the Q heads divide "model" and the KV heads do not, each model rank
reads a range of KV heads (``models/attention.py::_head_layout``).  Where
no K/V is kept for a cache (training, a forward that collects none), it
projects only those heads' columns of ``wk`` and ``wv`` and, with
``qkv_bias``, of ``bk`` and ``bv`` (``_own_kv``); prefill projects every
head, which the cache holds on each model rank.

Reduced gemma2-27b has 4 Q heads and 2 KV heads: model ranks 0-1 read KV
head 0 and ranks 2-3 head 1.  Reduced qwen2-7b with ``n_kv_heads`` = 2
(``test_torch_mesh.VARIANTS``, set alike in both packages) has the same
layout and biases on K and V.  Two or three model ranks cannot show the
route: the only reduced KV-head count that takes it there is 1, whose
range is every column.

One spawn of ``test_torch_mesh``'s "models" worker serves every test (a
module fixture); the parent computes the JAX package's and the one-device
references while the ranks run.  Tolerances are that file's: ``REL`` for
logits, prefill caches, losses, gradient norms and updated parameters
against the one-device port, ``GRAD_REL`` per gradient leaf and for the
updated parameters against the JAX package; greedy tokens equal.
"""
import pytest
import torch

from test_torch_mesh import (REL, _cfg, _check_grads, _check_leaves, _check_train, _jax_case,
                             _jax_cfg, _jax_grads, _jax_train, _jax_weights, _references,
                             _rel, _self_attentions, _spawn)

ARCHS = ("gemma2-27b", "qwen2-7b kv2")
MICROBATCHES, STEPS = 2, 2            # test_torch_mesh._train's


@pytest.fixture(scope="module")
def model4_world(tmp_path_factory):
    """One spawn of 4 ranks as (data=1, model=4): logits, prefill caches,
    greedy tokens, gradients and two train steps of ``ARCHS``, each call's
    own-KV-heads attentions counted; the references beside them."""
    finish = _spawn(tmp_path_factory.mktemp("model4"), 4, "models", model=4,
                    weights={a: _jax_weights(a) for a in ARCHS}, moe_cases={},
                    archs=ARCHS, train_archs=ARCHS)
    ref = _references(archs=ARCHS, train_archs=ARCHS)
    for arch in ARCHS:                  # the JAX package's, while the ranks run
        _jax_case(arch)
        _jax_grads(arch)
        _jax_train(arch)
    res = finish()
    assert res["mesh"] == {"data": 1, "model": 4}
    return res, ref


@pytest.mark.parametrize("arch", ARCHS)
def test_both_packages_build_the_same_heads(arch):
    """4 Q heads on 2 KV heads in both packages' configs (qwen2-7b's
    reduced config has 1 KV head, the variant 2), K/V biases on qwen2."""
    cfg, jcfg = _cfg(arch), _jax_cfg(arch)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (4, 2, cfg.d_model // 4)
    assert (jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim, jcfg.qkv_bias) == \
        (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qkv_bias)
    assert cfg.qkv_bias == arch.startswith("qwen2")


@pytest.mark.parametrize("arch", ARCHS)
def test_own_kv_heads_gradients_and_train_steps(model4_world, arch):
    """Every gradient leaf of one ``lm_loss`` backward, and two train steps
    in 2 microbatches, against the JAX package and the one-device port;
    every attention of each forward projected only its KV heads."""
    res, ref = model4_world
    n = _self_attentions(_cfg(arch))
    _check_grads(res[("grads", arch)], ref[("grads", arch)], _jax_grads(arch), arch)
    _check_train(res[("train", arch)], ref[("train", arch)], _jax_train(arch), arch)
    assert res[("kv_columns", "grads", arch)] == n, arch
    assert res[("kv_columns", "train", arch)] == STEPS * MICROBATCHES * n, arch
    assert res[("loss_shards", arch, "grads")] == 1, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_prefill_caches_and_tokens_unchanged(model4_world, arch):
    """``lm_logits`` (no cache kept: the route, once an attention layer),
    and prefill's cache and greedy tokens (every KV head projected: no
    attention on the route), against the JAX package and the one-device
    port."""
    res, ref = model4_world
    jax_ref = _jax_case(arch)
    got, want = res[("logits", arch)], ref[("logits", arch)]
    assert got.shape == want.shape == jax_ref["logits"].shape
    assert _rel(got, jax_ref["logits"]) <= REL, (arch, "jax", _rel(got, jax_ref["logits"]))
    assert _rel(got, want) <= REL, (arch, _rel(got, want))
    _check_leaves(res[("cache", arch)], ref[("cache", arch)], jax_ref["cache"], (arch, "cache"))
    assert torch.equal(res[("greedy", arch)], jax_ref["greedy"]), arch
    assert torch.equal(res[("greedy", arch)], ref[("greedy", arch)]), arch
    assert res[("kv_columns", "logits", arch)] == _self_attentions(_cfg(arch)), arch
    assert res[("kv_columns", "greedy", arch)] == 0, arch
