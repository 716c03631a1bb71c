"""The query-row offset of the port's flash attention (``q_offset``: the
absolute position of q's row 0), as the row split of the models under a
mesh launches it: model rank r of m attends rows [r S/m, (r + 1) S/m) of a
sequence against all S keys.

On the CPU the wrapper runs the kernel's plain version.  Its offset is held
against the JAX package's oracles, which take ``q_offset`` (its Pallas
kernel has none: the JAX package shards the rows under ``jit`` instead),
and against the port's own; m row shards, each launched with its offset and
concatenated, against the whole call.  fp32, the same numpy inputs on both
sides.  Tolerances: the plain version against an oracle within ``ATOL``
(test_torch_flash_attention's); shards concatenated against the whole
call exactly where the logical q blocks of a shard are the whole call's
(the offset a multiple of block_q), else within ``ATOL``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_reference_blocked as jax_blocked
from repro.kernels.ref import mha_reference as jax_mha
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.ref import flash_reference_blocked, mha_reference

ATOL = 1e-5
B, HQ, HKV, S, D = 1, 4, 2, 160, 32


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, HQ, S, D)).astype(np.float32),
            rng.normal(size=(B, HKV, S, D)).astype(np.float32),
            rng.normal(size=(B, HKV, S, D)).astype(np.float32))


# (first row, last row + 1): the last rows, a middle band, the first rows;
# 88 and 40 fall inside every block size below
ROWS = ((88, 160), (40, 100), (0, 40))
GENOMES = [dict(kv_in_grid=kig, mask_mode=mm, gqa_pack=gp, block_q=bq, block_k=bk)
           for kig, mm, gp, (bq, bk) in itertools.product(
               (True, False), ("dense", "block_skip"), (False, True),
               ((16, 32), (64, 128)))]


@pytest.mark.parametrize("window", [None, 48], ids=["causal", "causal_window48"])
@pytest.mark.parametrize("genome", GENOMES, ids=lambda g: "-".join(
    f"{v}" for v in g.values()))
def test_plain_offset_matches_the_oracles(genome, window):
    """A row band [lo, hi) of q with ``q_offset`` = lo against all keys,
    causal with and without a window: the plain version against the JAX
    package's ``flash_reference_blocked`` and ``mha_reference`` with the
    same offset, and the port's two oracles."""
    q, k, v = _qkv(0)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    for lo, hi in ROWS:
        band = q[:, :, lo:hi]
        kw = dict(causal=True, window=window, q_offset=lo)
        ours = flash_attention_plain(torch.from_numpy(band), tk, tv, **kw, **genome).numpy()
        jb = np.asarray(jax_blocked(jnp.asarray(band), jk, jv, block_k=64, **kw))
        jm = np.asarray(jax_mha(jnp.asarray(band), jk, jv, **kw))
        np.testing.assert_allclose(ours, jb, atol=ATOL, rtol=0)
        np.testing.assert_allclose(ours, jm, atol=ATOL, rtol=0)
        for port in (flash_reference_blocked(torch.from_numpy(band), tk, tv, block_k=64, **kw),
                     mha_reference(torch.from_numpy(band), tk, tv, **kw)):
            np.testing.assert_allclose(ours, port.numpy(), atol=ATOL, rtol=0)
        # the rows of the whole call: the offset is what places them
        whole = mha_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                              window=window)[:, :, lo:hi]
        np.testing.assert_allclose(ours, whole.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("m", [2, 5, 10])
@pytest.mark.parametrize("window", [None, 48], ids=["causal", "causal_window48"])
def test_row_shards_concatenated_equal_the_whole_call(m, window):
    """m equal row shards, shard r launched through the wrapper with
    ``q_offset`` = r S/m, concatenated along the rows: the whole call's
    output, bit for bit where every shard starts on a logical q block of
    the whole call (S/m a multiple of block_q), else within ATOL."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(m))
    n = S // m
    for genome in (dict(block_q=16, block_k=32), dict(block_q=32, block_k=64, kv_in_grid=False),
                   dict(block_q=16, block_k=64, gqa_pack=True)):
        kw = dict(causal=True, window=window, **genome)
        whole = flash_attention(q, k, v, **kw)
        shards = torch.cat([flash_attention(q[:, :, r * n:(r + 1) * n].contiguous(), k, v,
                                            q_offset=r * n, **kw) for r in range(m)], dim=2)
        if n % genome["block_q"] == 0 and not genome.get("gqa_pack"):
            assert torch.equal(shards, whole), (m, genome)
        else:
            torch.testing.assert_close(shards, whole, atol=ATOL, rtol=0)


def test_ops_attention_takes_the_offset_on_every_impl():
    """``ops.attention`` passes ``q_offset`` to the kernel wrapper and the
    plain version (it raised there before), and to the blocked and naive
    references: the four agree on a causal windowed band."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3))
    band = q[:, :, 100:].contiguous()
    kw = dict(causal=True, window=48, q_offset=100)
    outs = {impl: ops.attention(band, k, v, impl=impl, **kw)
            for impl in ("kernel", "plain", "blocked", "naive")}
    for impl, out in outs.items():
        assert out.shape == band.shape
        torch.testing.assert_close(out, outs["naive"], atol=ATOL, rtol=0, msg=impl)
    # the offset is not ignored: at 0 the band reads other keys
    assert not torch.allclose(ops.attention(band, k, v, impl="plain", causal=True, window=48),
                              outs["plain"], atol=1e-3)


def test_the_offset_is_checked():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4))
    for bad in (-1, 1.5, True):
        with pytest.raises(ValueError, match="q_offset"):
            flash_attention(q, k, v, causal=True, q_offset=bad)
        with pytest.raises(ValueError, match="q_offset"):
            flash_attention_plain(q, k, v, causal=True, q_offset=bad)
