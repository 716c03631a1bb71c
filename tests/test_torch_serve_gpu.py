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
from repro_torch.models import decode_step, init_params, prefill

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
@pytest.mark.parametrize("rep", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("D", [64, 96, 120, 128])
@pytest.mark.parametrize("splits", [1, 3, None])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_wgmma_decode_matches_plain_on_card(rep, D, splits, softcap):
    """The wgmma body (bf16) against the plain version walking the same
    splits, within flash_decode's bf16 bounds: valid_len of one key, a
    ragged tile (577 = 9 x 64 + 1) and the whole cache; the cache's own D
    (96 and 120 in 128-wide tiles, no copy).  A second identical call is
    bit-equal: the splits merge in split order, whichever CTA ends last."""
    _need_card()
    rng = np.random.default_rng(1000 * rep + D)
    B, Hkv, L = 3, 2, 1000
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
               .to(torch.bfloat16) for s in ((B, rep * Hkv, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    vl = torch.tensor([1, 577, L], dtype=torch.int32, device="cuda")
    before = dict(fd.flash_decode.launches_by_body)
    out = fd.flash_decode(q, k, v, vl, splits=splits, softcap=softcap)
    again = fd.flash_decode(q, k, v, vl, splits=splits, softcap=softcap)
    assert fd.flash_decode.launches_by_body == dict(before, wgmma=before["wgmma"] + 2)
    assert out.shape == q.shape and torch.equal(out, again)
    n = splits or fd.kernel_splits(q, k)
    plain = fd.flash_decode_plain(q, k, v, vl, splits=n, softcap=softcap)
    mag = fd.flash_decode_plain(q, k, v.abs(), vl, splits=n, softcap=softcap)
    stats = fd.bf16_agreement(out, plain, mag)
    assert fd.bf16_agrees(stats), stats


@pytest.mark.gpu
@pytest.mark.parametrize("body,dtype", [("wgmma", torch.bfloat16), ("simt", torch.bfloat16),
                                        ("simt", torch.float32)])
@pytest.mark.parametrize("splits", [1, 3, None])
def test_partial_decode_and_empty_shard_on_card(body, dtype, splits):
    """The partial mode of both bodies: (o in fp32, M, l) against the plain
    version walking the same splits (fp32 within ATOL and STAT_REL, bf16
    within flash_decode's bounds and STAT_REL); a row with valid_len 0 (a
    shard past the token) gives o = 0, M = -1e30, l = 0, no NaN.  Then the
    cache cut into 4 length shards, each decoded in partial mode at its
    own valid_len (the last one of row 1 empty), merged: against the plain
    version over the whole cache."""
    _need_card()
    rng = np.random.default_rng(29)
    B, Hkv, rep, L, D = 3, 2, 4, 1024, 128
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(dtype)
               for s in ((B, rep * Hkv, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    vl = torch.tensor([0, 577, L], dtype=torch.int32, device="cuda")
    before = dict(fd.flash_decode.launches_by_body)
    o, M, l = fd.flash_decode(q, k, v, vl, splits=splits, softcap=30.0, body=body, partial=True)
    assert fd.flash_decode.launches_by_body == dict(before, **{body: before[body] + 1})
    assert o.dtype == M.dtype == l.dtype == torch.float32 and o.shape == q.shape
    assert M.shape == l.shape == (B, rep * Hkv)
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    assert bool((M[0] == -1e30).all() and (l[0] == 0).all())
    assert bool(torch.isfinite(o).all() and torch.isfinite(M).all() and torch.isfinite(l).all())
    n = splits or fd.kernel_splits(q, k)
    plain = fd.flash_decode_plain(q, k, v, vl, splits=n, softcap=30.0, partial=True)
    mag = fd.flash_decode_plain(q, k, v.abs(), vl, splits=n, softcap=30.0, partial=True)[0]
    stats = fd.partial_agreement((o, M, l), plain, mag)
    if dtype == torch.float32:
        torch.testing.assert_close(o, plain[0], atol=ATOL, rtol=0)
        assert stats["stat_m_err"] <= fd.STAT_REL and stats["stat_l_rel"] <= fd.STAT_REL
    else:
        assert fd.bf16_agrees(stats), stats
    Lr = L // 4
    parts = [fd.flash_decode(q, k[:, :, r * Lr:(r + 1) * Lr].contiguous(),
                             v[:, :, r * Lr:(r + 1) * Lr].contiguous(),
                             (vl - r * Lr).clamp(0, Lr).to(torch.int32), softcap=30.0,
                             body=body, partial=True) for r in range(4)]
    merged = fd.merge_partials(*(torch.stack(t) for t in zip(*parts)))
    whole = fd.flash_decode_plain(q, k, v, vl, softcap=30.0)
    if dtype == torch.float32:
        torch.testing.assert_close(merged, whole, atol=ATOL, rtol=0)
    else:
        stats = fd.bf16_agreement(merged.to(dtype), whole,
                                  fd.flash_decode_plain(q, k, v.abs(), vl, softcap=30.0))
        assert fd.bf16_agrees(stats), stats


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, None])
def test_a_bf16_decode_call_is_one_kernel_launch(splits):
    """At the served Jamba shape one bf16 call launches exactly one CUDA
    kernel (torch.profiler), the wgmma body's, the split merge included;
    the simt body's bf16 call launches its two."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((4, 32, 128), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((4, 8, 4096, 128), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    vl = torch.full((4,), 1908, dtype=torch.int32, device="cuda")
    for body, want in (("wgmma", ["decode_wgmma"]), ("simt", ["decode_split", "decode_combine"])):
        fd.flash_decode(q, k, v, vl, splits=splits, body=body)     # built, counters made
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fd.flash_decode(q, k, v, vl, splits=splits, body=body)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(names) == len(want), (body, names)
        assert all(w in n for w, n in zip(sorted(want), sorted(names))), (body, names)


def _served_decode_inputs(seed=5, L=1000):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((4, 32, 128), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((4, 8, L, 128), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    return q, k, v, torch.tensor([1, 577, 900, L], dtype=torch.int32, device="cuda")


@pytest.mark.gpu
def test_wgmma_split_counters_are_per_stream():
    """Calls on two streams at once each count their splits on their own
    counters and give the default stream's output bit for bit."""
    _need_card()
    q, k, v, vl = _served_decode_inputs()
    want = fd.flash_decode(q, k, v, vl, splits=3)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(fd.flash_decode(q, k, v, vl, splits=3))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    keys = {(q.device.index, s.cuda_stream) for s in streams}
    assert keys <= set(fd._COUNTERS) and len({fd._COUNTERS[k].data_ptr() for k in keys}) == 2
    assert all(int(fd._COUNTERS[k].abs().sum()) == 0 for k in keys)


@pytest.mark.gpu
def test_wgmma_decode_replays_in_a_cuda_graph():
    """One call captured in a CUDA graph (after a call on the capturing
    stream) replays to the eager output bit for bit, again and again: the
    last split CTA resets its counter, so each replay finds it at 0."""
    _need_card()
    q, k, v, vl = _served_decode_inputs()
    want = fd.flash_decode(q, k, v, vl, splits=3)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fd.flash_decode(q, k, v, vl, splits=3)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        out = fd.flash_decode(q, k, v, vl, splits=3)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "seamless-m4t-medium"])
def test_served_bf16_decode_takes_the_wgmma_body(name):
    """Reduced jamba-v0.1-52b and seamless-m4t-medium at their published
    head dims (128 and 64), served in bf16 on the card: every flash_decode
    call of every decode step takes the wgmma body."""
    _need_card()
    cfg = published_head_dim(name)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda",
                         dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in (5, 19, 33, 40)]
    before = (fd.flash_decode.launches, dict(fd.flash_decode.launches_by_body))
    srv = BatchedServer(cfg, params, batch_size=2, max_len=64, compute_dtype=torch.bfloat16)
    srv.run([Request(i, p, 6) for i, p in enumerate(prompts)])
    calls = fd.flash_decode.launches - before[0]
    took = {b: fd.flash_decode.launches_by_body[b] - before[1][b] for b in fd.BODIES}
    assert calls > 0 and took == {"wgmma": calls, "simt": 0}, (calls, took)


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
        srv = BatchedServer(cfg, params, batch_size=2, max_len=64, graph=False)
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
        srv = BatchedServer(cfg, params, batch_size=2, max_len=64, graph=False)
        with ops.checking(lambda kernel, stats: seen.append((kernel, stats))):
            outs[device] = [r.output for r in srv.run(
                [Request(i, p, 6) for i, p in enumerate(prompts)])]
    assert outs["card"] == outs["cpu"]
    assert {k for k, _ in seen} == {"flash_attention", "flash_decode"}
    assert all(f.launches > n for f, n in counts.items())
    for kernel, stats in seen:
        assert stats["finite"] and stats["rel_rms"] <= 1e-5, (kernel, stats)


@pytest.mark.gpu
def test_reduced_seamless_gives_the_cpu_logits_and_tokens_through_the_kernels():
    """Reduced seamless-m4t-medium in fp32 on the card through both
    attention kernels (every launch held to its plain version): with seeded
    random frames (Se = 37 frames against 9-token prompts), prefill and 6
    decode steps give the CPU reference's logits within 1e-4 relative and
    its greedy tokens; served through BatchedServer (zero frames), the
    CPU's tokens."""
    _need_card()
    cfg = get_arch("seamless-m4t-medium").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(2))

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}
    card = to_cuda(cpu)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    frames = torch.from_numpy(rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32))
    seen = []
    counts = {f: f.launches for f in (fa.flash_attention, fd.flash_decode)}
    logits, tokens = {}, {}
    for device, params in (("cuda", card), ("cpu", cpu)):
        kw = dict(compute_dtype=torch.float32, impl="auto")
        with ops.checking(lambda kernel, stats: seen.append((kernel, stats))):
            lg, cache = prefill(params, cfg, toks.to(device), 16, cache_dtype=torch.float32,
                                enc_frames=frames.to(device), **kw)
            rows, picks = [lg], [lg.argmax(-1)]
            for _ in range(6):
                lg, cache = decode_step(params, cfg, cache, picks[-1], **kw)
                rows.append(lg)
                picks.append(lg.argmax(-1))
        logits[device] = torch.stack(rows).cpu()
        tokens[device] = torch.stack(picks).cpu().tolist()
    assert tokens["cuda"] == tokens["cpu"]
    rel = float((logits["cuda"] - logits["cpu"]).norm() / logits["cpu"].norm())
    assert rel <= 1e-4, rel
    # the encoder (2 layers), self- and cross-attention (2 each) at prefill;
    # the self and the cross cache at each decode step
    assert fa.flash_attention.launches - counts[fa.flash_attention] == 6
    assert fd.flash_decode.launches - counts[fd.flash_decode] == 6 * 4
    assert {k for k, _ in seen} == {"flash_attention", "flash_decode"}
    for kernel, stats in seen:
        assert stats["finite"] and stats["rel_rms"] <= 1e-5, (kernel, stats)

    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in (5, 19, 33, 40)]
    served = {}
    for device, params in (("card", card), ("cpu", cpu)):
        srv = BatchedServer(cfg, params, batch_size=2, max_len=64)
        served[device] = [r.output for r in srv.run(
            [Request(i, p, 6) for i, p in enumerate(prompts)])]
    assert served["card"] == served["cpu"]


def _record_logits(srv, out: list) -> None:
    """Appends a copy of each decode step's logits that ``srv`` runs to
    ``out``: the eager step's, or the graph's output after its warm-up step
    and after every replay."""
    if not srv.graph:
        inner = srv._serve

        def serve(params, cache, token):
            logits, cache = inner(params, cache, token)
            out.append(logits.clone())
            return logits, cache
        srv._serve = serve
        return
    first = srv._first_step

    def first_step(cache, token, copies):
        capture = first(cache, token, copies)
        if capture:                  # a new graph: the eager warm-up step, then replays
            out.append(srv._graphed.logits.clone())
            replay = srv._graphed.replay

            def replay_():
                span = replay()
                out.append(srv._graphed.logits.clone())
                return span
            srv._graphed.replay = replay_
        return capture
    srv._first_step = first_step


@pytest.mark.gpu
@pytest.mark.parametrize("name,captures", [("jamba-v0.1-52b", 1), ("seamless-m4t-medium", 2)])
def test_graphed_server_replays_the_eager_steps_bit_for_bit(name, captures):
    """Reduced jamba-v0.1-52b (Mamba, MoE, attention) and seamless-m4t-medium
    (self- and cross-attention) at their published head dims in bf16: two
    groups of other prompt lengths through BatchedServer eagerly and as a
    CUDA graph give the same tokens, every decode step's logits bit for bit
    and the same launch counts.  Jamba's cache shapes do not depend on the
    prompt, so its second group copies into the one capture; seamless's
    cross cache is as long as the prompt, so it captures again."""
    _need_card()
    cfg = published_head_dim(name)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda",
                         dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in (7, 19, 30, 41)]
    runs = {}
    for graph in (False, True):
        srv = BatchedServer(cfg, params, batch_size=2, max_len=64,
                            compute_dtype=torch.bfloat16, graph=graph)
        logits, kernels = [], (fa.flash_attention, fd.flash_decode, sm.ssd_chunked)
        _record_logits(srv, logits)
        before = [f.launches for f in kernels]
        reqs = srv.run([Request(i, p, 6) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        runs[graph] = dict(tokens=[r.output for r in reqs], logits=logits, server=srv,
                           launches=[f.launches - n for f, n in zip(kernels, before)])
    eager, graphed = runs[False], runs[True]
    assert graphed["tokens"] == eager["tokens"]
    assert len(eager["logits"]) == len(graphed["logits"]) == 2 * 5
    assert all(torch.equal(a, b) for a, b in zip(eager["logits"], graphed["logits"]))
    assert graphed["launches"] == eager["launches"] and eager["launches"][1] > 0
    log = graphed["server"].graph_log
    assert len(log["capture_ms"]) == captures and len(log["copy_ms"]) == 2 - captures
    assert [len(t["replay_ms"]) for t in graphed["server"].timings] == [
        4, 4 if captures == 2 else 5]


@pytest.mark.gpu
def test_graphed_server_refuses_the_checking_hook():
    """A graph cannot hold its launches against the plain versions: the
    graphed server raises under ops.checking and captures nothing."""
    _need_card()
    cfg = published_head_dim("jamba-v0.1-52b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda",
                         dtype=torch.bfloat16)
    srv = BatchedServer(cfg, params, batch_size=2, max_len=64, compute_dtype=torch.bfloat16)
    assert srv.graph
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (9,))
    with ops.checking(lambda kernel, stats: None), pytest.raises(RuntimeError,
                                                                 match="checking"):
        srv.run([Request(0, prompt, 4)])
    assert srv.graph_log["capture_ms"] == []


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "seamless-m4t-medium"])
def test_eager_decode_step_never_waits_for_the_card(name):
    """The position stays on the device: three eager decode steps in bf16
    through the kernels complete under set_sync_debug_mode("error"), which
    raises on any operation that synchronizes with the card."""
    _need_card()
    cfg = published_head_dim(name)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda",
                         dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (2, 11), generator=g, device="cuda")
    extras = ({"enc_frames": torch.randn((2, 13, cfg.d_model), generator=g, device="cuda")
               .to(torch.bfloat16)} if cfg.enc_dec else {})
    kw = dict(compute_dtype=torch.bfloat16)
    logits, cache = prefill(params, cfg, toks, 32, cache_dtype=torch.bfloat16, **extras, **kw)
    token = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            logits, cache = decode_step(params, cfg, cache, token, **kw)
            token = torch.argmax(logits, -1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(cache["pos"]) == 11 + 3 and bool(torch.isfinite(logits).all())
