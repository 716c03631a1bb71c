"""The chunked body's walk, ``ssd.ssd_chunked_split_plain`` (chunk states,
state pass, chunk scan, with the kernel's operand splits), against the JAX
package's SSD and the port's plain version.

fp32 with the split off: the JAX kernel in interpret mode, or the sequential
recurrence for a ragged L, at REL = 5e-5 relative to max |y| and max |state|,
as tests/test_torch_ssd.py holds the plain version.  bf16 with the kernel's
split of its fp32 operands into three bf16 terms: within ``ssd.bf16_agrees``
of the plain version (the bounds the kernel is held to on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_reference as jax_ssd_reference
from repro.kernels.ssd import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ssd as sm

REL = 5e-5


def _inputs(seed, B, L, H, P, N):
    """tests/test_kernels_ssd.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.5)).astype(np.float32)
    Bm = (rng.normal(size=(B, L, 1, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, L, 1, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(ours, theirs, what):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    err = np.abs(ours - theirs).max() / np.abs(theirs).max()
    assert err <= REL, f"{what}: {err} relative to max"


def _walk(arrs, **kw):
    y, h = sm.ssd_chunked_split_plain(*map(torch.from_numpy, arrs), **kw)
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("H,bh", [(4, 4), (8, 4), (8, 8)])
def test_fp32_walk_matches_jax_kernel_and_recurrence(H, bh):
    """The cases of test_torch_ssd.py::test_plain_matches_jax_kernel_and_recurrence."""
    arrs = _inputs(1, 1, 128, H, 16, 16)
    y, h = _walk(arrs, chunk=32, terms=None)
    jy, jh = jax_ssd_chunked(*map(jnp.asarray, arrs), chunk=32, block_heads=bh,
                             interpret=True)
    ry, rh = jax_ssd_reference(*map(jnp.asarray, arrs))
    _close(y, jy, "y vs JAX kernel")
    _close(h, jh, "state vs JAX kernel")
    _close(y, ry, "y vs recurrence")
    _close(h, rh, "state vs recurrence")


@pytest.mark.parametrize("L,P,chunk", [(1, 16, 32), (37, 16, 32), (300, 64, 256)])
def test_fp32_walk_matches_the_recurrence_at_a_ragged_length(L, P, chunk):
    """L not a multiple of the chunk: steps past L count as x = 0, dt = 0."""
    arrs = _inputs(3, 2, L, 8, P, 16)
    y, h = _walk(arrs, chunk=chunk, terms=None)
    ry, rh = jax_ssd_reference(*map(jnp.asarray, arrs))
    _close(y, ry, "y")
    _close(h, rh, "state")


def _bf16_inputs(seed, B, L, H, P, N):
    """bf16 x, B, C; Mamba-2's dt range and Jamba's A, as the card checks."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, L, H, P)).astype(np.float32))
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, L, H)))
                          .astype(np.float32))
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm = (torch.from_numpy(rng.normal(size=(B, L, 1, N)).astype(np.float32))
              for _ in range(2))
    return x.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16), Cm.to(torch.bfloat16)


@pytest.mark.parametrize("P,N", sm.SHAPES)
def test_bf16_walk_agrees_with_plain(P, N):
    x, dt, A, Bm, Cm = _bf16_inputs(P + N, 1, 600, 4, P, N)
    y, st = sm.ssd_chunked_split_plain(x, dt, A, Bm, Cm, chunk=256)
    py, pst = sm.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=256)
    mag, _ = sm.ssd_chunked_plain(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk=256)
    stats = sm.bf16_agreement(y, st, py, pst, mag)
    assert sm.bf16_agrees(stats), stats


def test_three_bf16_terms_hold_an_fp32_value_exactly():
    """fp32's 24 significant bits are three times bf16's 8; two terms are not
    enough."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.uniform(-20, 20, 4096))
                         .astype(np.float32))
    assert torch.equal(sm.split_terms(v, 3), v)
    assert not torch.equal(sm.split_terms(v, 2), v)
    assert torch.equal(sm.split_terms(v, 1), v.to(torch.bfloat16).float())
