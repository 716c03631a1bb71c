"""The port's AdamW (``repro_torch.optim``) and gradient compression
(``repro_torch.distributed.collectives``) against the JAX package's on the
same gradients, and the counterparts of tests/test_data_optim.py's optimizer
tests.  Tolerances: parameters and moments to 1e-6 of the leaf's largest
magnitude (the port updates in place and rounds the last bits of the update
differently, which a parameter near zero shows as a large relative error);
the bf16 and int8 round trips exactly (the same casts, and both packages
round half to even).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jax_collectives
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import schedule as jax_schedule
from repro_torch.distributed import collectives
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, global_norm, schedule)
from repro_torch.tree import tree_leaves

REL = 1e-6


def _tree(rng, scale=1.0):
    return {"a": {"w": (scale * rng.standard_normal((5, 7))).astype(np.float32),
                  "b": (scale * rng.standard_normal((7,))).astype(np.float32)},
            "emb": (scale * rng.standard_normal((11, 3))).astype(np.float32)}


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("max_grad_norm", [1.0, 100.0])       # clipped, and not
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_jax_over_steps(max_grad_norm, wd):
    """Six updates on the same gradient sequence through warmup into the
    cosine: parameters, both moments, step, grad norm and lr."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, weight_decay=wd, max_grad_norm=max_grad_norm,
              warmup_steps=2, total_steps=8)
    params, jparams = _t(_tree(rng)), _j(_tree(np.random.default_rng(0)))
    state, jstate = adamw_init(params), jax_adamw_init(jparams)
    for i in range(6):
        g = _tree(rng, scale=0.5 + i)
        params, state, m = adamw_update(_t(g), state, params, AdamWConfig(**kw))
        jparams, jstate, jm = jax_adamw_update(_j(g), jstate, jparams, JaxAdamWConfig(**kw))
        for ours, theirs in ((params, jparams), (state.mu, jstate.mu), (state.nu, jstate.nu)):
            for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=REL * np.abs(b).max())
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=REL)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=REL)
        assert int(state.step) == int(jstate.step) == i + 1
    assert state.step.dtype == torch.int32 and state.step.dim() == 0


def test_adamw_updates_in_place():
    params = {"w": torch.ones(3, requires_grad=True)}
    state = adamw_init(params)
    w, mu = params["w"], state.mu["w"]
    new, new_state, _ = adamw_update({"w": torch.full((3,), 0.5)}, state, params,
                                     AdamWConfig(warmup_steps=0))
    assert new["w"] is w and new_state.mu["w"] is mu and new_state is state
    assert w.requires_grad and not torch.equal(w.detach(), torch.ones(3))


def test_adamw_matches_reference_formula():
    params = {"w": torch.tensor([[1.0, -2.0], [3.0, 0.5]])}
    grads = {"w": torch.tensor([[0.1, -0.2], [0.3, 0.05]])}
    cfg = AdamWConfig(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      max_grad_norm=10.0, warmup_steps=0, total_steps=10**7)
    w0 = params["w"].numpy().copy()
    g = grads["w"].numpy().copy()
    new_params, _, _ = adamw_update(grads, adamw_init(params), params, cfg)
    m, v = 0.1 * g, 0.001 * g * g
    mhat, vhat = m / (1 - 0.9), v / (1 - 0.999)
    expect = w0 - 1e-2 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new_params["w"].numpy(), expect, rtol=1e-4)


def test_weight_decay_decoupled():
    params = {"w": torch.ones((2, 2))}
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=0,
                      total_steps=10**7, max_grad_norm=10.0)
    new_params, _, _ = adamw_update({"w": torch.zeros((2, 2))}, adamw_init(params),
                                    params, cfg)
    np.testing.assert_allclose(new_params["w"].numpy(), 1.0 - 1e-2 * 0.1 * 1.0, rtol=1e-4)


def test_schedule_warmup_then_cosine_matches_jax():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert schedule(cfg, 0) == pytest.approx(0.1, rel=1e-3)
    assert schedule(cfg, 4) == pytest.approx(0.5, rel=1e-3)
    assert schedule(cfg, 9) == pytest.approx(1.0, rel=1e-3)
    assert schedule(cfg, 100) == pytest.approx(0.1, rel=1e-2)
    jcfg = JaxAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in (0, 3, 9, 10, 11, 37, 99, 100, 150):
        assert schedule(cfg, step) == pytest.approx(float(jax_schedule(jcfg, step)), rel=REL)


def test_global_norm_clip():
    g = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(g)) == pytest.approx(5.0)
    clipped, gn = clip_by_global_norm({k: v.clone() for k, v in g.items()}, 1.0)
    assert float(gn) == pytest.approx(5.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    unclipped, _ = clip_by_global_norm({k: v.clone() for k, v in g.items()}, 10.0)
    assert float(global_norm(unclipped)) == pytest.approx(5.0, rel=1e-5)


def test_adamw_all_finite_many_steps():
    params = {"w": torch.ones((4, 4)) * 0.1}
    state = adamw_init(params)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        params, state, _ = adamw_update({"w": torch.randn((4, 4), generator=gen)},
                                        state, params, AdamWConfig(lr=1e-3))
    assert torch.isfinite(params["w"]).all()
    assert int(state.step) == 20


# -- gradient compression -------------------------------------------------------


def test_bf16_round_trip_equals_jax():
    g = _tree(np.random.default_rng(1))
    ours = collectives.decompress_bf16(collectives.compress_bf16(_t(g)))
    theirs = jax_collectives.decompress_bf16(jax_collectives.compress_bf16(_j(g)))
    for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    applied, res = collectives.apply_grad_compression(_t(g), "bf16")
    for a, b in zip(tree_leaves(applied), tree_leaves(ours)):
        assert torch.equal(a, b)
    assert res is None


def test_int8_error_feedback_equals_jax_over_steps():
    """Three rounds with the residual carried: int8 codes, scales, the
    decompressed gradients and the residuals equal the JAX package's."""
    rng = np.random.default_rng(2)
    g0 = _tree(rng)
    res, jres = collectives.compress_init(_t(g0)), jax_collectives.compress_init(_j(g0))
    for i in range(3):
        g = _tree(rng, scale=1.0 + i)
        q, s, new_r = collectives.compress_int8_ef(_t(g), res)
        jq, js, jnew_r = jax_collectives.compress_int8_ef(_j(g), jres)
        for a, b in zip(tree_leaves(q), jax.tree_util.tree_leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(s), jax.tree_util.tree_leaves(js)):
            assert float(a) == float(b)
        for a, b in zip(tree_leaves(new_r), jax.tree_util.tree_leaves(jnew_r)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        out, res2 = collectives.apply_grad_compression(_t(g), "int8_ef", res)
        jout, jres = jax_collectives.apply_grad_compression(_j(g), "int8_ef", jres)
        for a, b in zip(tree_leaves(out), jax.tree_util.tree_leaves(jout)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(res2), tree_leaves(new_r)):
            assert torch.equal(a, b)
        res = res2


def test_compression_errors():
    g = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="error-feedback"):
        collectives.apply_grad_compression(g, "int8_ef")
    with pytest.raises(ValueError, match="unknown compression"):
        collectives.apply_grad_compression(g, "fp4")
    out, res = collectives.apply_grad_compression(g, "none")
    assert out is g and res is None
