"""The port's flash attention vs the JAX package's Pallas kernel: shapes,
padding, GQA (with and without packing), sliding windows and softcap.

Same method as ``test_torch_flash_attention.py``: the same numpy inputs go
through the port's plain version (the wrapper's CPU path) and the JAX kernel
in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.core.evals import CORRECTNESS_TOL
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import mha_reference

ATOL = 1e-5      # f32 accumulator: plain version vs JAX interpret mode


def _qkv(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _run(arrs, **kw):
    """(port, jax, oracle) outputs as numpy."""
    t_in = [torch.from_numpy(a) for a in arrs]
    j_in = [jnp.asarray(a) for a in arrs]
    port = flash_attention(*t_in, **kw).numpy()
    ref_kw = {k: kw[k] for k in ("causal", "window", "softcap") if k in kw}
    jax_out = np.asarray(jax_flash_attention(*j_in, interpret=True, **kw))
    oracle = mha_reference(*t_in, **ref_kw).numpy()
    return port, jax_out, oracle


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [128, 192, 320])     # incl. non-multiples of block
def test_shapes_padding(causal, S):
    port, jx, _ = _run(_qkv(1, 1, 2, 2, S, S, 32), causal=causal,
                       block_q=128, block_k=128)
    np.testing.assert_allclose(port, jx, atol=ATOL, rtol=0)


@pytest.mark.parametrize("Hq,Hkv", [(4, 1), (4, 2), (6, 3)])
@pytest.mark.parametrize("gqa_pack", [False, True])
def test_gqa_ratios(Hq, Hkv, gqa_pack):
    port, jx, _ = _run(_qkv(2, 1, Hq, Hkv, 64, 64, 32), causal=True,
                       block_q=32, block_k=32, gqa_pack=gqa_pack)
    np.testing.assert_allclose(port, jx, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kv_in_grid", [True, False])
def test_gqa_pack_wrap_boundary(kv_in_grid):
    """Packed q rows wrap the true sequence; block_q > seq so one tile covers
    several heads and the block classification takes the conservative wrap."""
    port, jx, oracle = _run(_qkv(3, 1, 4, 1, 48, 48, 32), causal=True,
                            block_q=128, block_k=16, gqa_pack=True,
                            mask_mode="block_skip", kv_in_grid=kv_in_grid)
    np.testing.assert_allclose(port, jx, atol=ATOL, rtol=0)
    np.testing.assert_allclose(port, oracle, atol=CORRECTNESS_TOL, rtol=0)


@pytest.mark.parametrize("window", [16, 64, 100])
@pytest.mark.parametrize("mask_mode", ["dense", "block_skip"])
def test_sliding_window(window, mask_mode):
    port, jx, _ = _run(_qkv(4, 1, 1, 1, 160, 160, 32), causal=True,
                       window=window, block_q=32, block_k=64, mask_mode=mask_mode,
                       kv_in_grid=(window != 64))
    np.testing.assert_allclose(port, jx, atol=ATOL, rtol=0)


def test_softcap():
    port, jx, _ = _run(_qkv(5, 1, 2, 2, 128, 128, 32), causal=True,
                       softcap=50.0, block_q=64, block_k=64)
    np.testing.assert_allclose(port, jx, atol=ATOL, rtol=0)


def test_cross_attention_shapes():
    port, jx, _ = _run(_qkv(7, 1, 2, 2, 96, 160, 32), causal=False,
                       block_q=32, block_k=64)
    np.testing.assert_allclose(port, jx, atol=ATOL, rtol=0)
