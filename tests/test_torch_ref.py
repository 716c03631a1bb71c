"""The port's attention oracle vs the JAX package's, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import mha_reference as jax_mha_reference
from repro_torch.kernels.ref import mha_reference

ATOL = 1e-5   # fp32: the two frameworks sum in different orders


def _qkv(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _both(arrs, **kw):
    t = mha_reference(*(torch.from_numpy(a) for a in arrs), **kw).numpy()
    j = np.asarray(jax_mha_reference(*(jnp.asarray(a) for a in arrs), **kw))
    return t, j


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", [None, 16, 100])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 1), (6, 3)])
def test_mha_reference_matches_jax(causal, window, Hq, Hkv):
    t, j = _both(_qkv(0, 2, Hq, Hkv, 96, 96, 32), causal=causal, window=window)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("softcap", [0.0, 5.0, 50.0])
def test_mha_reference_softcap_matches_jax(softcap):
    t, j = _both(_qkv(1, 1, 2, 2, 64, 64, 64), causal=True, softcap=softcap)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_mha_reference_cross_attention_and_offset():
    arrs = _qkv(2, 1, 2, 2, 32, 80, 32)
    t, j = _both(arrs, causal=True, q_offset=48)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
    t, j = _both(arrs, causal=False, scale=0.3)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_mha_reference_keeps_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(3, 1, 2, 2, 16, 16, 16))
    assert mha_reference(q, k, v).dtype == torch.bfloat16
    assert jax.devices()[0].platform == "cpu"
