"""The port's SSD chunked scan against the JAX package's.

The plain PyTorch version (what the wrapper runs on CPU tensors, and what
the sm_90a kernel is held against on the card) against JAX
``ssd_chunked(interpret=True)``, ``ssd_chunked_reference`` and
``ssd_reference`` on the same numpy inputs: the cases of
tests/test_kernels_ssd.py, plus a ragged sequence length through
``ops.ssd``.  fp32; tolerance 5e-5 relative to max |y| (and max |state|):
the chunked form subtracts cumulative sums, so its rounding grows with them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.ref import ssd_chunked_reference as jax_ssd_chunked_reference
from repro.kernels.ref import ssd_decode_reference as jax_ssd_decode_reference
from repro.kernels.ref import ssd_reference as jax_ssd_reference
from repro.kernels.ssd import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_plain

REL = 5e-5


def _inputs(seed, B, L, H, P, G, N):
    """tests/test_kernels_ssd.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.5)).astype(np.float32)
    Bm = (rng.normal(size=(B, L, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, L, G, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(ours, theirs, what):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    err = np.abs(ours - theirs).max() / np.abs(theirs).max()
    assert err <= REL, f"{what}: {err} relative to max"


def _plain(arrs, **kw):
    y, h = ssd_chunked_plain(*map(torch.from_numpy, arrs), **kw)
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("H,bh", [(4, 4), (8, 4), (8, 8)])
def test_plain_matches_jax_kernel_and_recurrence(H, bh):
    """``bh`` is the JAX kernel's head block, which tiles its grid; the
    port has one CTA per head whatever it is."""
    arrs = _inputs(1, 1, 128, H, 16, 1, 16)
    y, h = _plain(arrs, chunk=32)
    jy, jh = jax_ssd_chunked(*map(jnp.asarray, arrs), chunk=32, block_heads=bh,
                             interpret=True)
    ry, rh = jax_ssd_reference(*map(jnp.asarray, arrs))
    _close(y, jy, "y vs JAX kernel")
    _close(h, jh, "state vs JAX kernel")
    _close(y, ry, "y vs recurrence")
    _close(h, rh, "state vs recurrence")


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_plain_matches_jax_chunked_reference(chunk):
    arrs = _inputs(0, 2, 128, 4, 16, 1, 16)
    y, h = _plain(arrs, chunk=chunk)
    jy, jh = jax_ssd_chunked_reference(*map(jnp.asarray, arrs), chunk=chunk)
    _close(y, jy, "y")
    _close(h, jh, "state")


def test_chunk_invariance():
    arrs = _inputs(2, 1, 128, 4, 16, 1, 16)
    y32, _ = _plain(arrs, chunk=32)
    y64, _ = _plain(arrs, chunk=64)
    _close(y32, y64, "chunk 32 vs 64")


@pytest.mark.parametrize("L", [1, 37, 100])
def test_ragged_length_through_ops_matches_the_recurrence(L):
    """L not a multiple of the chunk: the port's kernel path pads the last
    chunk with x = 0, dt = 0 (the JAX package sends it to the reference)."""
    arrs = _inputs(3, 2, L, 8, 16, 1, 16)
    ry, rh = jax_ssd_reference(*map(jnp.asarray, arrs))
    for impl in ("kernel", "plain", "blocked", "naive"):
        y, h = ops.ssd(*map(torch.from_numpy, arrs), chunk=32, impl=impl)
        _close(y.numpy(), ry, f"y ({impl})")
        _close(h.numpy(), rh, f"state ({impl})")


def test_jamba_head_shape():
    """(P, N) = (64, 16) and chunk 256 as the served Jamba runs, L ragged."""
    arrs = _inputs(4, 1, 300, 4, 64, 1, 16)
    y, h = _plain(arrs, chunk=256)
    ry, rh = jax_ssd_reference(*map(jnp.asarray, arrs))
    _close(y, ry, "y")
    _close(h, rh, "state")


def test_port_references_match_jax():
    """The port's three SSD oracles, groups broadcast over heads (G = 2)."""
    arrs = _inputs(5, 1, 64, 8, 16, 2, 16)
    t = list(map(torch.from_numpy, arrs))
    j = list(map(jnp.asarray, arrs))
    y, h = ref.ssd_reference(*t)
    jy, jh = jax_ssd_reference(*j)
    _close(y.numpy(), jy, "recurrence y")
    _close(h.numpy(), jh, "recurrence state")
    y, h = ref.ssd_chunked_reference(*t, chunk=16)
    jy, jh = jax_ssd_chunked_reference(*j, chunk=16)
    _close(y.numpy(), jy, "chunked y")
    _close(h.numpy(), jh, "chunked state")
    state = np.array(jh)
    x, dt, A, Bm, Cm = arrs
    yd, sd = ref.ssd_decode_reference(*(torch.from_numpy(a) for a in (
        x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], state)))
    jyd, jsd = jax_ssd_decode_reference(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                        jnp.asarray(state))
    _close(yd.numpy(), jyd, "decode y")
    _close(sd.numpy(), jsd, "decode state")


def test_groups_raise_on_the_kernel_path():
    """G = 2 through the kernel path: like the JAX ``ops.ssd``, the port's
    sends it to the chunked reference (the kernel takes one group), and the
    two agree; the kernel wrapper itself still refuses it."""
    arrs = _inputs(6, 1, 32, 8, 16, 2, 16)
    y, h = ops.ssd(*map(torch.from_numpy, arrs), chunk=16, impl="kernel")
    jy, jh = jax_ops.ssd(*map(jnp.asarray, arrs), chunk=16, impl="pallas_interpret")
    _close(y.numpy(), jy, "y vs JAX ops.ssd")
    _close(h.numpy(), jh, "state vs JAX ops.ssd")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item 3"):
        ssd_chunked(*map(torch.from_numpy, arrs), chunk=16)


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch():
    arrs = list(map(torch.from_numpy, _inputs(7, 1, 40, 4, 16, 1, 16)))
    before = ssd_chunked.launches, dict(ssd_chunked.launches_by_body)
    y, h = ssd_chunked(*arrs, chunk=32)
    assert (ssd_chunked.launches, ssd_chunked.launches_by_body) == before
    py, ph = ssd_chunked_plain(*arrs, chunk=32)
    torch.testing.assert_close(y, py)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_chunked(*arrs, impl="kernel")
    with pytest.raises(ValueError, match="chunk must be positive"):
        ssd_chunked(*arrs, chunk=0)
    with pytest.raises(ValueError, match="body="):
        ssd_chunked(*arrs, body="wgmma")
