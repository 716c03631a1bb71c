"""The port's flash attention vs the JAX package's Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
JAX kernel runs in interpret mode, as the JAX package's own tests run it.
Both get the same numpy inputs.  The axes mirror
``tests/test_kernels_attention.py``.  Tests marked ``gpu`` hold the CUDA
kernel against the plain version and skip without a card.
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


@pytest.mark.parametrize("kv_in_grid", [True, False])
@pytest.mark.parametrize("rescale_mode", ["branchless", "branched"])
@pytest.mark.parametrize("mask_mode", ["dense", "block_skip"])
@pytest.mark.parametrize("div_mode", ["deferred", "eager"])
def test_genome_axes_causal(kv_in_grid, rescale_mode, mask_mode, div_mode):
    port, jx, oracle = _run(_qkv(0, 1, 1, 1, 192, 192, 64), causal=True,
                            block_q=64, block_k=64, kv_in_grid=kv_in_grid,
                            rescale_mode=rescale_mode, mask_mode=mask_mode,
                            div_mode=div_mode)
    np.testing.assert_allclose(port, jx, atol=ATOL, rtol=0)
    np.testing.assert_allclose(port, oracle, atol=CORRECTNESS_TOL, rtol=0)


def test_numerically_extreme_scores():
    q, k, v = _qkv(8, 1, 2, 2, 128, 128, 32)
    port, jx, _ = _run((q * 30.0, k, v), causal=True, block_q=64, block_k=64)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, jx, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_in_grid", [True, False])
def test_bf16_accumulator_fails_the_gate_in_both(kv_in_grid):
    """acc_dtype=bf16 runs, but both packages land far above the gate."""
    port, jx, oracle = _run(_qkv(13, 1, 1, 1, 160, 160, 64), causal=True,
                            block_q=16, block_k=32, kv_in_grid=kv_in_grid,
                            acc_dtype="bf16")
    assert np.isfinite(port).all()
    assert np.abs(port - oracle).max() > CORRECTNESS_TOL
    assert np.abs(jx - oracle).max() > CORRECTNESS_TOL


def test_bf16_inputs_match_oracle():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(6, 1, 2, 2, 128, 128, 64))
    out = flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    assert out.dtype == torch.bfloat16
    ref = mha_reference(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_wrapper_checks_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 1, 2, 2, 32, 32, 16))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :16], v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, mask_mode="sparse")
    with pytest.raises(ValueError):
        flash_attention(q, k, v, impl="kernel")
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before     # CPU: the plain version
