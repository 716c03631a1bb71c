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
from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (TILE_K, decode_splits, flash_decode,
                                              flash_decode_plain)
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


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_walk_matches_jax_kernel_and_reference(splits, softcap):
    """The plain version walking the kernel's splits of the live tiles, then
    combining them, against JAX interpret mode and the reference.  valid_len
    runs from 1 to L: at 1 every split but the first has no live tile, and
    at 129 some splits of 8 are empty too.  fp32; 1e-5 absolute on outputs
    of scale ~1, as above (the combine reorders the sums)."""
    q, kc, vc, _ = _inputs(8, 4, 8, 2, 300, 16)
    vl = np.array([1, 64, 129, 300], np.int32)
    ours = flash_decode_plain(*map(torch.from_numpy, (q, kc, vc, vl)),
                              softcap=softcap, splits=splits).numpy()
    theirs = np.asarray(jax_flash_decode(*map(jnp.asarray, (q, kc, vc, vl)),
                                         softcap=softcap, block_k=128, interpret=True))
    ref = np.asarray(jax_decode_reference(*map(jnp.asarray, (q, kc, vc, vl)),
                                          softcap=softcap))
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_one_split_is_the_unsplit_walk_exactly():
    """With one split the combine's weight is e^0 = 1: the output is the
    walk's acc / l, bit for bit, whatever the split count would be."""
    q, kc, vc, vl = map(torch.from_numpy, _inputs(9, 2, 8, 2, 200, 16))
    one = flash_decode_plain(q, kc, vc, vl, splits=1)
    torch.testing.assert_close(one, flash_decode_plain(q, kc, vc, vl), rtol=0, atol=0)
    many = flash_decode_plain(q, kc, vc, vl, splits=64)      # more splits than tiles
    torch.testing.assert_close(many, one, **TOL)


@pytest.mark.parametrize("B,Hkv,L,n_sm,want", [
    (4, 8, 4096, 132, 8),       # the served Jamba shape: 256 of the 264 CTA slots
    (4, 33, 4096, 132, 2),      # B x Hkv = 132: two CTAs on every SM
    (16, 16, 4096, 132, 1),     # B x Hkv = 256
    (1, 1, 100, 132, 1),        # 2 tiles: fewer than the ring's depth
    (1, 1, 30, 132, 1),
    (2, 4, 65536, 132, 33),
    (4, 8, 500, 132, 2),        # 8 tiles: the ring's depth binds before the slots
])
def test_decode_splits(B, Hkv, L, n_sm, want):
    """The split rule: B x Hkv x splits CTAs fill one wave of the card's
    CTA slots as far as each split keeps RING_DEPTH tiles."""
    got = decode_splits(B, Hkv, L, n_sm)
    assert got == want
    tiles, slots, pairs = -(-L // TILE_K), n_sm * fd_mod.CTAS_PER_SM, B * Hkv
    assert 1 <= got <= tiles                          # at most one split per tile
    assert pairs * got <= max(pairs, slots)           # one wave
    # every slot filled: one more split would overflow the wave or leave a
    # split short of the ring's depth
    assert pairs * (got + 1) > slots or (got + 1) * fd_mod.RING_DEPTH > tiles
    if tiles >= fd_mod.RING_DEPTH:                    # each split gets the ring's depth
        assert tiles // got >= fd_mod.RING_DEPTH


@pytest.mark.parametrize("splits", [decode_splits(4, 8, 4096, 132),
                                    decode_splits(2, 2, 1024, 132)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_walk_at_the_served_shape_matches_jax(splits, softcap):
    """The plain version at the split rule's counts (8 at the served Jamba
    shape, 5 at this cut of it) against JAX interpret mode and the
    reference: the served shape reduced to B = 2, 2 KV heads of rep 4 at
    head_dim 128, a 1024-key cache, one ragged valid_len and one full.
    fp32, TOL."""
    q, kc, vc, _ = _inputs(12, 2, 8, 2, 1024, 128)
    vl = np.array([777, 1024], np.int32)
    ours = flash_decode_plain(*map(torch.from_numpy, (q, kc, vc, vl)),
                              softcap=softcap, splits=splits).numpy()
    theirs = np.asarray(jax_flash_decode(*map(jnp.asarray, (q, kc, vc, vl)),
                                         softcap=softcap, block_k=256, interpret=True))
    ref = np.asarray(jax_decode_reference(*map(jnp.asarray, (q, kc, vc, vl)),
                                          softcap=softcap))
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_body_routing_is_a_function_of_dtype_and_head_dim():
    """bf16 at head_dim 17-128 (a multiple of 8) takes wgmma; fp32, and
    bf16 at 16 or below, take simt; a body= that cannot take the call raises
    before anything runs, on any device."""
    for D in range(1, 129):
        for dtype in (torch.float32, torch.bfloat16):
            want = ("wgmma" if dtype == torch.bfloat16 and D > 16 and D % 8 == 0
                    else "simt")
            assert fd_mod.decode_body(dtype, D) == want
    assert [fd_mod.decode_body(torch.bfloat16, d) for d in (16, 24, 64, 96, 120, 128)] \
        == ["simt", "wgmma", "wgmma", "wgmma", "wgmma", "wgmma"]
    with pytest.raises(TypeError, match="dtype"):
        fd_mod.decode_body(torch.float16, 64)
    q, kc, vc, vl = map(torch.from_numpy, _inputs(13, 2, 8, 2, 100, 64))
    plain = flash_decode_plain(q, kc, vc, vl)
    torch.testing.assert_close(flash_decode(q, kc, vc, vl, body="simt"), plain,
                               rtol=0, atol=0)
    before = dict(flash_decode.launches_by_body)
    with pytest.raises(ValueError, match="cannot take"):
        flash_decode(q, kc, vc, vl, body="wgmma")          # fp32
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, kc, vc))
    flash_decode(qb, kb, vb, vl, body="wgmma")              # bf16 at 64: the plain version
    with pytest.raises(ValueError, match="cannot take"):
        flash_decode(qb[..., :16].contiguous(), kb[..., :16].contiguous(),
                     vb[..., :16].contiguous(), vl, body="wgmma")
    with pytest.raises(ValueError, match="body="):
        flash_decode(q, kc, vc, vl, body="mma_sync")
    assert flash_decode.launches_by_body == before and set(before) == set(fd_mod.BODIES)


def test_wrapper_passes_splits_to_the_plain_version_on_cpu():
    q, kc, vc, vl = map(torch.from_numpy, _inputs(10, 2, 8, 2, 300, 16))
    torch.testing.assert_close(flash_decode(q, kc, vc, vl, splits=3),
                               flash_decode_plain(q, kc, vc, vl, splits=3), rtol=0, atol=0)
    with pytest.raises(ValueError, match="splits"):
        flash_decode_plain(q, kc, vc, vl, splits=0)


@pytest.mark.parametrize("D", [64, 96, 120])
@pytest.mark.parametrize("splits", [1, 3])
def test_padded_head_dim_matches_jax(D, splits):
    """What a call at head_dim 64, 96 or 120 computes: ``pad_head_dim``
    takes q and the caches to the next compiled width (64 stays, 96 and 120
    become 128) with the scale of the original D; the plain version on the
    padded inputs, sliced back to D, against JAX interpret mode and the
    reference at D.  fp32, TOL; rep 4, a ragged L."""
    arrs = _inputs(D, 3, 8, 2, 200, D, vl=[1, 77, 200])
    q, kc, vc, vl = map(torch.from_numpy, arrs)
    qp, kp, vp, scale = fd_mod.pad_head_dim(q, kc, vc, None)
    width = fd_mod.kernel_head_dim(D)
    assert width in fd_mod.HEAD_DIMS and width == (64 if D == 64 else 128)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == width
    assert scale == 1.0 / D ** 0.5 and not kp[..., D:].any()
    ours = flash_decode_plain(qp, kp, vp, vl, scale=scale, splits=splits)
    assert not ours[..., D:].any()
    j_in = [jnp.asarray(a) for a in arrs]
    theirs = np.asarray(jax_flash_decode(*j_in, block_k=128, interpret=True))
    np.testing.assert_allclose(ours[..., :D].numpy(), theirs, **TOL)
    np.testing.assert_allclose(ours[..., :D].numpy(),
                               np.asarray(jax_decode_reference(*j_in)), **TOL)


def test_head_dims_the_decode_kernel_runs_at():
    assert [fd_mod.kernel_head_dim(d) for d in (8, 16, 17, 64, 80, 96, 120, 128)] \
        == [16, 16, 64, 64, 128, 128, 128, 128]
    with pytest.raises(ValueError, match="head_dim 256"):
        fd_mod.kernel_head_dim(256)
