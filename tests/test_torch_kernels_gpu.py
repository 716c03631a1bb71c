"""The sm_90a flash-attention kernel on the card, against its plain PyTorch
version and the oracle.  Every test needs a CUDA device and skips without
one.  This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.core.evals import CORRECTNESS_TOL, Scorer
from repro_torch.core.search_space import seed_genome
from repro_torch.kernels.flash_attention import (_launch, attention_body,
                                                 bf16_agreement, bf16_agrees,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.ref import mha_reference

ATOL = 1e-5      # fp32: kernel vs plain version


def _qkv(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sm_90a kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("kv_in_grid", [True, False])
@pytest.mark.parametrize("mask_mode", ["dense", "block_skip"])
@pytest.mark.parametrize("gqa_pack", [False, True])
def test_kernel_matches_plain_on_card(kv_in_grid, mask_mode, gqa_pack):
    _need_card()
    q, k, v = (torch.from_numpy(a).cuda() for a in _qkv(10, 1, 4, 2, 160, 160, 64))
    for causal, window in ((True, None), (True, 48), (False, None)):
        kw = dict(causal=causal, window=window, block_q=32, block_k=128,
                  kv_in_grid=kv_in_grid, mask_mode=mask_mode, gqa_pack=gqa_pack,
                  rescale_mode="branched", div_mode="eager")
        before = flash_attention.launches
        out = flash_attention(q, k, v, impl="kernel", **kw)
        assert flash_attention.launches == before + 1
        plain = flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(out, plain, atol=ATOL, rtol=0)
        ref = mha_reference(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(out, ref, atol=CORRECTNESS_TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_in_grid", [True, False])
@pytest.mark.parametrize("mask_mode", ["dense", "block_skip"])
@pytest.mark.parametrize("gqa_pack", [False, True])
def test_kernel_offset_matches_plain_on_card(kv_in_grid, mask_mode, gqa_pack):
    """A row band [88, 160) launched with ``q_offset`` = 88 against all 160
    keys (fp32 body), causal with and without a window: the kernel against
    the plain version with the same offset and against the rows of the
    oracle's whole call."""
    _need_card()
    q, k, v = (torch.from_numpy(a).cuda() for a in _qkv(11, 1, 4, 2, 160, 160, 64))
    band = q[:, :, 88:].contiguous()
    for window in (None, 48):
        kw = dict(causal=True, window=window, q_offset=88, block_q=32, block_k=128,
                  kv_in_grid=kv_in_grid, mask_mode=mask_mode, gqa_pack=gqa_pack)
        out = flash_attention(band, k, v, impl="kernel", **kw)
        torch.testing.assert_close(out, flash_attention_plain(band, k, v, **kw),
                                   atol=ATOL, rtol=0)
        ref = mha_reference(q, k, v, causal=True, window=window)[:, :, 88:]
        torch.testing.assert_close(out, ref, atol=CORRECTNESS_TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,body", [(128, "wgmma"), (96, "mma_sync")])
def test_kernel_bf16_row_shards_equal_the_whole_launch(head_dim, body):
    """qwen2-7b's heads (28 over 4 KV heads) on each bf16 body: 8 row
    shards of 256 rows, each launched with its offset, concatenated, equal
    the whole causal launch bit for bit (each shard's 128-row blocks are
    the whole launch's), and hold the plain version's bf16 bounds."""
    _need_card()
    assert attention_body(torch.bfloat16, head_dim) == body
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((1, 28, 2048, head_dim), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, 4, 2048, head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, block_q=128, block_k=128, mask_mode="block_skip")
    whole = flash_attention(q, k, v, impl="kernel", **kw)
    shards = torch.cat([flash_attention(q[:, :, r * 256:(r + 1) * 256].contiguous(), k, v,
                                        impl="kernel", q_offset=r * 256, **kw)
                        for r in range(8)], dim=2)
    assert torch.equal(shards, whole)
    stats = bf16_agreement(shards, flash_attention_plain(q, k, v, **kw),
                           flash_attention_plain(q, k, v.abs(), **kw))
    assert bf16_agrees(stats), stats


@pytest.mark.gpu
def test_kernel_bf16_full_width_on_card():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 16, 1024, 128), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    kw = dict(causal=True, block_q=256, block_k=512, kv_in_grid=True,
              mask_mode="block_skip")
    out = flash_attention(q, k, v, **kw)
    plain = flash_attention_plain(q, k, v, **kw)
    mag = flash_attention_plain(q, k, v.abs(), **kw)
    stats = bf16_agreement(out, plain, mag)
    assert bf16_agrees(stats), stats


@pytest.mark.gpu
def test_wgmma_body_launches_from_a_fresh_thread():
    """A thread whose only CUDA work is the launch (its output served from
    the allocator's cache) has no current context until a runtime call
    makes one current; the wgmma body's tensor maps need one."""
    _need_card()
    q, k, v = (torch.randn(1, 2, 256, 128, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    want = flash_attention(q, k, v)
    spare = torch.empty_like(q)          # a cached block for the thread's output
    del spare
    torch.cuda.synchronize()
    with ThreadPoolExecutor(1) as ex:
        got = ex.submit(lambda: flash_attention(q, k, v)).result()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_measured_rung_times_on_card():
    _need_card()
    from repro_torch.core.evals import MEASURED
    from repro_torch.core.perfmodel import BenchConfig
    cfg = BenchConfig("c1k", 2, 4, 4, 1024, causal=True)
    s = Scorer(suite=[cfg], fidelity=MEASURED)
    before = flash_attention.launches
    sv = s(seed_genome())
    assert sv.correct and sv.values[0] > 0
    assert flash_attention.launches > before


@pytest.mark.gpu
def test_measured_baselines_on_card():
    """At the measured rung ``baselines()`` times SDPA's cuDNN ("expert") and
    flash ("fa_reference") backends per config, once per scorer; a windowed
    config gets None from both with the reason, never another backend's
    number; score_batch times each genome in turn."""
    _need_card()
    from repro_torch.core.evals import MEASURED
    from repro_torch.core.perfmodel import BenchConfig
    suite = [BenchConfig("mha_c1k", 2, 4, 4, 1024, causal=True),
             BenchConfig("gqa_n1k", 2, 8, 2, 1024, causal=False),
             BenchConfig("win_c1k", 2, 8, 2, 1024, causal=True, window=256)]
    s = Scorer(suite=suite, fidelity=MEASURED)
    base = s.baselines()
    assert set(base) == {"expert", "fa_reference"}
    assert s.baselines() == base                  # timed once per scorer
    for key, vals in base.items():
        assert len(vals) == len(suite) and vals[2] is None
        assert "window" in s.baseline_errors[key]["win_c1k"]
        for cfg, v in zip(suite[:2], vals):
            assert (v is None) == (cfg.name in s.baseline_errors[key])
            assert v is None or v > 0
    assert base["fa_reference"][0] is not None     # flash takes plain MHA
    before = flash_attention.launches
    svs = s.score_batch([seed_genome(), seed_genome().with_(kv_in_grid=True)])
    assert all(sv.correct and min(sv.values) > 0 for sv in svs)
    assert flash_attention.launches > before and s.n_evaluations == 2


# the wgmma body's cases: causal / window / softcap, each rescale and div
# mode, logical blocks smaller than the 128-key chunk and the 128-row tile
WGMMA_CASES = [
    dict(causal=True, window=None, softcap=0.0, rescale_mode="branched",
         div_mode="eager", block_q=32, block_k=128),
    dict(causal=True, window=48, softcap=0.0, rescale_mode="branchless",
         div_mode="deferred", block_q=128, block_k=64),
    dict(causal=False, window=None, softcap=30.0, rescale_mode="branched",
         div_mode="deferred", block_q=256, block_k=256),
    dict(causal=False, window=None, softcap=0.0, rescale_mode="branchless",
         div_mode="eager", block_q=2048, block_k=2048),
]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kv_in_grid", [True, False])
@pytest.mark.parametrize("mask_mode", ["dense", "block_skip"])
@pytest.mark.parametrize("gqa_pack", [False, True])
def test_wgmma_body_matches_plain_in_bf16(D, kv_in_grid, mask_mode, gqa_pack):
    """bf16 at head_dim 64 and 128 takes the wgmma body; S = 300 is not a
    multiple of the 128-row tile or the 128-key chunk."""
    _need_card()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _qkv(D, 2, 4, 2, 300, 300, D))
    for case in WGMMA_CASES:
        kw = dict(case, kv_in_grid=kv_in_grid, mask_mode=mask_mode, gqa_pack=gqa_pack)
        before = flash_attention.launches_by_body["wgmma"]
        out = flash_attention(q, k, v, impl="kernel", **kw)
        assert flash_attention.launches_by_body["wgmma"] == before + 1
        plain = flash_attention_plain(q, k, v, **kw)
        mag = flash_attention_plain(q, k, v.abs(), **kw)
        stats = bf16_agreement(out, plain, mag)
        assert bf16_agrees(stats), (kw, stats)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_body_with_fewer_queries_than_keys(D):
    """Sq = 77 rows (one partial 128-row tile) against Sk = 300 keys, GQA by
    h / rep, no mask but the key padding."""
    _need_card()
    rng = np.random.default_rng(D + 1)
    q = torch.from_numpy(rng.normal(size=(2, 6, 77, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 2, 300, D)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.cuda().to(torch.bfloat16) for t in (q, k, v))
    kw = dict(causal=False, block_q=128, block_k=128)
    out = flash_attention(q, k, v, impl="kernel", **kw)
    plain = flash_attention_plain(q, k, v, **kw)
    mag = flash_attention_plain(q, k, v.abs(), **kw)
    stats = bf16_agreement(out, plain, mag)
    assert bf16_agrees(stats), stats


@pytest.mark.gpu
@pytest.mark.parametrize("kv_in_grid", [True, False])
def test_wgmma_body_bf16_accumulator_errs_as_the_plain_one(kv_in_grid):
    """acc_dtype="bf16" on the wgmma body: rounded at the same logical block
    ends as the plain version, so its distance from the fp32-accumulator
    output is the plain bf16-accumulator's, within a factor of 2 (the kernel
    also rounds P to bf16 and the branched reference rounds twice)."""
    _need_card()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _qkv(9, 1, 4, 4, 1024, 1024, 128))
    kw = dict(causal=True, block_q=128, block_k=256, kv_in_grid=kv_in_grid)
    exact = flash_attention_plain(q, k, v, **kw).float()
    before = flash_attention.launches_by_body["wgmma"]
    out = flash_attention(q, k, v, impl="kernel", acc_dtype="bf16", **kw).float()
    assert flash_attention.launches_by_body["wgmma"] == before + 1
    plain = flash_attention_plain(q, k, v, acc_dtype="bf16", **kw).float()
    ratio = float((out - exact).norm() / (plain - exact).norm())
    assert 0.5 <= ratio <= 2.0, ratio


@pytest.mark.gpu
def test_wgmma_bounds_reject_a_bf16_accumulator():
    """The control: a bf16 accumulator rounded every 64 keys fails the
    bounds the wgmma body meets on the same inputs."""
    _need_card()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _qkv(7, 2, 4, 4, 1024, 1024, 128))
    kw = dict(causal=True, block_q=128, block_k=128)
    out = flash_attention(q, k, v, impl="kernel", **kw)
    plain = flash_attention_plain(q, k, v, **kw)
    mag = flash_attention_plain(q, k, v.abs(), **kw)
    assert bf16_agrees(bf16_agreement(out, plain, mag))
    wrong = flash_attention_plain(q, k, v, **dict(kw, block_k=64, acc_dtype="bf16"))
    assert not bf16_agrees(bf16_agreement(wrong, plain, mag))


@pytest.mark.gpu
def test_mma_sync_body_forced_for_timing():
    """The private body= keyword forces the mma.sync body on a bf16 launch;
    both bodies meet the bounds on the same inputs."""
    _need_card()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _qkv(8, 1, 4, 4, 512, 512, 128))
    kw = dict(causal=True, window=None, softcap=0.0, scale=None, block_q=128,
              block_k=128, rescale_mode="branchless", mask_mode="block_skip",
              div_mode="deferred", kv_in_grid=True, gqa_pack=False, acc_dtype="f32")
    plain = flash_attention_plain(q, k, v, **kw)
    mag = flash_attention_plain(q, k, v.abs(), **kw)
    for body in ("mma_sync", None):
        name = body or "wgmma"
        before = dict(flash_attention.launches_by_body)
        out = _launch(q, k, v, body=body, **kw)
        assert flash_attention.launches_by_body[name] == before[name] + 1
        assert bf16_agrees(bf16_agreement(out, plain, mag)), name
    with pytest.raises(ValueError, match="body"):
        _launch(q.float(), k.float(), v.float(), body="mma_sync", **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [96, 120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gqa_pack", [False, True])
def test_padded_head_dims_on_card(D, dtype, gqa_pack):
    """head_dim 96 (a multiple of 16: no padding) and 120 (zero-padded to
    128, the scale kept at 1/sqrt(120)): one launch, on the body
    ``attention_body`` names (bf16 120 takes wgmma), against the plain
    version at the original D: fp32 within ATOL and the oracle within
    CORRECTNESS_TOL, bf16 within the bounds.  Causal with a window, rep 2,
    S = 300."""
    _need_card()
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in _qkv(D + 3, 2, 4, 2, 300, 300, D))
    kw = dict(causal=True, window=200, block_q=128, block_k=128, gqa_pack=gqa_pack)
    body = attention_body(dtype, D)
    assert body == {torch.float32: "fp32", torch.bfloat16:
                    "wgmma" if D == 120 else "mma_sync"}[dtype]
    before, by_body = flash_attention.launches, dict(flash_attention.launches_by_body)
    out = flash_attention(q, k, v, impl="kernel", **kw)
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_body[body] == by_body[body] + 1
    assert out.shape == q.shape and out.is_contiguous()
    plain = flash_attention_plain(q, k, v, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, atol=ATOL, rtol=0)
        ref = mha_reference(q, k, v, causal=True, window=200)
        torch.testing.assert_close(out, ref, atol=CORRECTNESS_TOL, rtol=0)
    else:
        mag = flash_attention_plain(q, k, v.abs(), **kw)
        stats = bf16_agreement(out, plain, mag)
        assert bf16_agrees(stats), stats
