"""The sm_90a flash_decode and SSD kernels on the card, against their plain
PyTorch versions, and the serving path through them.  Every test needs a
CUDA device and skips without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_serve_gpu.py -m gpu -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as sm
from repro_torch.kernels.ref import decode_reference, ssd_reference
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import init_params

ATOL = 1e-5          # fp32 decode: kernel vs plain version, outputs of scale ~1
SSD_REL = 2e-5       # fp32 SSD: kernel vs plain version, relative to max |y|


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sm_90a kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("rep", [1, 4, 7])
@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_kernel_matches_plain_on_card(rep, D, softcap):
    _need_card()
    rng = np.random.default_rng(rep * D)
    B, Hkv, L = 3, 2, 300
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
               for s in ((B, rep * Hkv, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    vl = torch.tensor([1, 177, L], dtype=torch.int32, device="cuda")
    before = fd.flash_decode.launches
    out = fd.flash_decode(q, k, v, vl, softcap=softcap)
    assert fd.flash_decode.launches == before + 1
    plain = fd.flash_decode_plain(q, k, v, vl, softcap=softcap)
    torch.testing.assert_close(out, plain, atol=ATOL, rtol=0)
    torch.testing.assert_close(out, decode_reference(q, k, v, vl, softcap=softcap),
                               atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_matches_plain_on_card(splits, dtype):
    """Split-K decode at several split counts (None: the wrapper's choice),
    against the plain version walking the same splits: fp32 within ATOL,
    bf16 within flash_decode's bounds.  valid_len 1 leaves every split but
    the first without a live tile."""
    _need_card()
    rng = np.random.default_rng(11)
    B, Hkv, rep, L, D = 3, 2, 4, 1000, 128
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(dtype)
               for s in ((B, rep * Hkv, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    vl = torch.tensor([1, 577, L], dtype=torch.int32, device="cuda")
    before = fd.flash_decode.launches
    out = fd.flash_decode(q, k, v, vl, splits=splits, softcap=30.0)
    assert fd.flash_decode.launches == before + 1
    n = splits or fd.kernel_splits(q, k)
    plain = fd.flash_decode_plain(q, k, v, vl, splits=n, softcap=30.0)
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, atol=ATOL, rtol=0)
        torch.testing.assert_close(out, decode_reference(q, k, v, vl, softcap=30.0),
                                   atol=ATOL, rtol=0)
    else:
        mag = fd.flash_decode_plain(q, k, v.abs(), vl, splits=n, softcap=30.0)
        stats = fd.bf16_agreement(out, plain, mag)
        assert fd.bf16_agrees(stats), stats


@pytest.mark.gpu
def test_decode_kernel_rejects_an_unsupported_head_dim():
    _need_card()
    q = torch.zeros((1, 4, 256), device="cuda")
    kv = torch.zeros((1, 4, 8, 256), device="cuda")
    vl = torch.ones((1,), dtype=torch.int32, device="cuda")
    before = fd.flash_decode.launches
    with pytest.raises(ValueError, match="head_dim 256"):
        fd.flash_decode(q, kv, kv, vl)
    assert fd.flash_decode.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 96, 120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, None])
def test_decode_padded_and_64_on_card(D, dtype, splits):
    """The D = 64 instance, and 96 / 120 zero-padded to 128 (the scale kept
    at 1/sqrt(D)): one call, against the plain version at the original D
    walking the same splits: fp32 within ATOL (and the reference), bf16
    within flash_decode's bounds.  rep 4, softcap 30."""
    _need_card()
    rng = np.random.default_rng(D)
    B, Hkv, rep, L = 3, 2, 4, 1000
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(dtype)
               for s in ((B, rep * Hkv, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    vl = torch.tensor([1, 577, L], dtype=torch.int32, device="cuda")
    before = fd.flash_decode.launches
    out = fd.flash_decode(q, k, v, vl, splits=splits, softcap=30.0)
    assert fd.flash_decode.launches == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    n = splits or fd.kernel_splits(q, k)
    plain = fd.flash_decode_plain(q, k, v, vl, splits=n, softcap=30.0)
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, atol=ATOL, rtol=0)
        torch.testing.assert_close(out, decode_reference(q, k, v, vl, softcap=30.0),
                                   atol=ATOL, rtol=0)
    else:
        mag = fd.flash_decode_plain(q, k, v.abs(), vl, splits=n, softcap=30.0)
        stats = fd.bf16_agreement(out, plain, mag)
        assert fd.bf16_agrees(stats), stats


@pytest.mark.gpu
@pytest.mark.parametrize("body", sm.BODIES)
@pytest.mark.parametrize("P,N", sm.SHAPES)
@pytest.mark.parametrize("L", [37, 300])
def test_ssd_kernel_matches_plain_on_card(P, N, L, body):
    """The serial body in fp32 within SSD_REL of the plain version; the
    chunked body (the one bf16 takes) within ssd.py's bf16 bounds."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(P + N + L)
    H = 8
    dtype = torch.float32 if body == "serial" else torch.bfloat16
    x = torch.randn((2, L, H, P), generator=g, device="cuda").to(dtype)
    dt = torch.rand((2, L, H), generator=g, device="cuda") * 0.1
    A = -torch.exp(0.5 * torch.randn((H,), generator=g, device="cuda"))
    Bm, Cm = (torch.randn((2, L, 1, N), generator=g, device="cuda").to(dtype)
              for _ in range(2))
    assert sm.ssd_body(x) == body
    before = dict(sm.ssd_chunked.launches_by_body)
    y, st = sm.ssd_chunked(x, dt, A, Bm, Cm, chunk=32)
    assert sm.ssd_chunked.launches_by_body[body] == before[body] + 1
    py, pst = sm.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=32)
    if body == "chunked":
        mag, _ = sm.ssd_chunked_plain(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk=32)
        stats = sm.bf16_agreement(y, st, py, pst, mag)
        assert sm.bf16_agrees(stats), stats
        return
    assert float((y - py).abs().max()) <= SSD_REL * float(py.abs().max())
    assert float((st - pst).abs().max()) <= SSD_REL * float(pst.abs().max())
    ry, _ = ssd_reference(x, dt, A, Bm, Cm)
    assert float((y - ry).abs().max()) <= 10 * SSD_REL * float(ry.abs().max())


@pytest.mark.gpu
def test_ssd_chunked_body_takes_aligned_bf16_only():
    _need_card()
    x = torch.zeros((1, 8, 4, 16), device="cuda")
    dt = torch.zeros((1, 8, 4), device="cuda")
    A = torch.zeros(4, device="cuda")
    BC = torch.zeros((1, 8, 1, 16), device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        sm.ssd_chunked(x, dt, A, BC, BC, body="chunked")
    xb = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sm.ssd_chunked(xb, dt, A, BC.bfloat16(), BC.bfloat16())


@pytest.mark.gpu
def test_ssd_kernel_rejects_groups_on_card():
    """G = 2 through the kernel path on the card goes to the chunked
    reference, as the JAX ops.ssd does, and equals the sequential recurrence
    on the CPU (which tests/test_torch_ssd.py holds to the JAX package's)."""
    _need_card()
    rng = np.random.default_rng(6)
    B, L, H, P, G, N = 1, 32, 8, 16, 2, 16
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.5)).astype(np.float32)
    Bm, Cm = ((rng.normal(size=(B, L, G, N)) * 0.5).astype(np.float32) for _ in range(2))
    cpu = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    before = sm.ssd_chunked.launches
    y, st = ops.ssd(*(t.cuda() for t in cpu), chunk=16, impl="kernel")
    assert sm.ssd_chunked.launches == before
    ry, rst = ssd_reference(*cpu)
    assert float((y.cpu() - ry).abs().max()) <= 5e-5 * float(ry.abs().max())
    assert float((st.cpu() - rst).abs().max()) <= 5e-5 * float(rst.abs().max())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sm.ssd_chunked(*(t.cuda() for t in cpu), chunk=16)


@pytest.mark.gpu
def test_reduced_jamba_serves_the_cpu_tokens_through_the_kernels():
    """fp32 on the card through all three kernels (every launch held to its
    plain version by the checking hook) gives the CPU reference's tokens."""
    _need_card()
    cfg = get_arch("jamba-v0.1-52b").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0))

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in (5, 19, 33, 40)]
    outs, seen = {}, []
    counts = {f: f.launches for f in (fd.flash_decode, sm.ssd_chunked)}
    for name, params in (("card", to_cuda(cpu)), ("cpu", cpu)):
        srv = BatchedServer(cfg, params, batch_size=2, max_len=64)
        with ops.checking(lambda kernel, stats: seen.append(kernel)):
            outs[name] = [r.output for r in srv.run(
                [Request(i, p, 6) for i, p in enumerate(prompts)])]
    assert outs["card"] == outs["cpu"]
    assert {"flash_attention", "flash_decode", "ssd_chunked"} <= set(seen)
    assert all(f.launches > n for f, n in counts.items())


def published_head_dim(name):
    """The arch's reduced config at its published head_dim: danube's 120
    (3840 / 32), phi-3-vision's 96 (3072 / 32)."""
    full = get_arch(name)
    return dataclasses.replace(full.reduced(), d_head=full.head_dim)


@pytest.mark.gpu
@pytest.mark.parametrize("name,head_dim", [("h2o-danube-3-4b", 120),
                                           ("phi-3-vision-4.2b", 96)])
def test_published_head_dims_serve_through_the_kernels(name, head_dim):
    """Reduced h2o-danube-3-4b (sliding window) and phi-3-vision-4.2b at
    their published head dims, served with impl="auto" in fp32 on the card
    through flash_attention and flash_decode (every launch held to its
    plain version by the checking hook), give the CPU reference's tokens."""
    _need_card()
    cfg = published_head_dim(name)
    assert cfg.head_dim == head_dim
    cpu = init_params(cfg, torch.Generator().manual_seed(1))

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in (5, 19, 33, 40)]
    outs, seen = {}, []
    counts = {f: f.launches for f in (fa.flash_attention, fd.flash_decode)}
    for device, params in (("card", to_cuda(cpu)), ("cpu", cpu)):
        srv = BatchedServer(cfg, params, batch_size=2, max_len=64)
        with ops.checking(lambda kernel, stats: seen.append((kernel, stats))):
            outs[device] = [r.output for r in srv.run(
                [Request(i, p, 6) for i, p in enumerate(prompts)])]
    assert outs["card"] == outs["cpu"]
    assert {k for k, _ in seen} == {"flash_attention", "flash_decode"}
    assert all(f.launches > n for f, n in counts.items())
    for kernel, stats in seen:
        assert stats["finite"] and stats["rel_rms"] <= 1e-5, (kernel, stats)
