"""The port's flash_decode against the JAX package's.

The plain PyTorch version (what the wrapper runs on CPU tensors, and what
the sm_90a kernel is held against on the card) against JAX
``flash_decode(interpret=True)`` and ``decode_reference``, on the same numpy
inputs: the axes of tests/test_kernels_decode.py.  fp32; tolerance 1e-5
absolute on outputs of scale ~1 (the walks are the same; summation order
differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.ref import decode_reference as jax_decode_reference
from repro.kernels.ref import mha_reference as jax_mha_reference
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.ref import decode_reference

TOL = dict(atol=1e-5, rtol=0)


def _inputs(seed, B, Hq, Hkv, L, D, vl=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kc = rng.normal(size=(B, Hkv, L, D)).astype(np.float32)
    vc = rng.normal(size=(B, Hkv, L, D)).astype(np.float32)
    if vl is None:
        vl = rng.integers(1, L + 1, size=B)
    return q, kc, vc, np.asarray(vl, np.int32)


def _both(q, kc, vc, vl, block_k, softcap=0.0):
    """``block_k`` is the JAX kernel's K block; the port walks the sm_90a
    kernel's 64-key tiles whatever it is."""
    ours = flash_decode_plain(*map(torch.from_numpy, (q, kc, vc, vl)),
                              softcap=softcap).numpy()
    theirs = np.asarray(jax_flash_decode(*map(jnp.asarray, (q, kc, vc, vl)),
                                         softcap=softcap, block_k=block_k,
                                         interpret=True))
    ref = np.asarray(jax_decode_reference(*map(jnp.asarray, (q, kc, vc, vl)),
                                          softcap=softcap))
    return ours, theirs, ref


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (7, 1)])
@pytest.mark.parametrize("L", [200, 384])
def test_plain_matches_jax_kernel_and_reference(Hq, Hkv, L):
    """rep 1 / 4 / 7, a ragged L (200 is not a multiple of block_k 128),
    a valid_len drawn per row."""
    ours, theirs, ref = _both(*_inputs(0, 2, Hq, Hkv, L, 16), block_k=128)
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_full_and_single_token_cache():
    q, kc, vc, _ = _inputs(1, 2, 4, 2, 256, 16)
    for vl in (np.full(2, 256, np.int32), np.ones(2, np.int32)):
        ours, theirs, ref = _both(q, kc, vc, vl, block_k=128)
        np.testing.assert_allclose(ours, theirs, **TOL)
        np.testing.assert_allclose(ours, ref, **TOL)


def test_softcap():
    ours, theirs, ref = _both(*_inputs(2, 2, 8, 2, 256, 16), block_k=128, softcap=30.0)
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_head_dim_128_at_the_served_block():
    """head_dim 128 and block_k 256, as the served Jamba decode runs."""
    ours, theirs, ref = _both(*_inputs(3, 1, 8, 2, 300, 128, vl=[257]), block_k=256)
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_decode_equals_last_row_of_prefill_attention():
    """Decoding token t equals row t of full causal attention."""
    rng = np.random.default_rng(3)
    B, H, S, D = 1, 4, 96, 16
    q, k, v = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(3))
    full = np.asarray(jax_mha_reference(*map(jnp.asarray, (q, k, v)), causal=True))
    out = flash_decode_plain(torch.from_numpy(q[:, :, -1]), torch.from_numpy(k),
                             torch.from_numpy(v), torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), full[:, :, -1], **TOL)


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch():
    q, kc, vc, vl = map(torch.from_numpy, _inputs(4, 2, 8, 2, 100, 16))
    before = flash_decode.launches
    out = flash_decode(q, kc, vc, vl)
    assert flash_decode.launches == before
    torch.testing.assert_close(out, flash_decode_plain(q, kc, vc, vl))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode(q, kc, vc, vl, impl="kernel")


@pytest.mark.parametrize("impl", ["kernel", "plain", "blocked", "naive", "auto"])
def test_ops_decode_attention_impls_agree(impl):
    q, kc, vc, vl = map(torch.from_numpy, _inputs(5, 2, 8, 2, 300, 16))
    out = ops.decode_attention(q, kc, vc, vl, impl=impl)
    torch.testing.assert_close(out, decode_reference(q, kc, vc, vl), **TOL)


def test_valid_len_past_the_cache_counts_as_the_cache():
    q, kc, vc, _ = map(torch.from_numpy, _inputs(6, 1, 4, 4, 64, 16))
    vl = torch.tensor([100], dtype=torch.int32)
    torch.testing.assert_close(flash_decode_plain(q, kc, vc, vl),
                               decode_reference(q, kc, vc, vl), **TOL)


def test_inputs_are_checked():
    q, kc, vc, vl = map(torch.from_numpy, _inputs(7, 2, 8, 2, 32, 16))
    with pytest.raises(ValueError, match="does not fit"):
        flash_decode(q[:, :7], kc, vc, vl)
    with pytest.raises(TypeError, match="dtype"):
        flash_decode(q.double(), kc, vc, vl)
    with pytest.raises(ValueError, match="valid_len"):
        flash_decode(q, kc, vc, vl[:1])
