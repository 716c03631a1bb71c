"""The sm_90a flash-attention kernel on the card, against its plain PyTorch
version and the oracle.  Every test needs a CUDA device and skips without
one.  This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core.evals import CORRECTNESS_TOL, Scorer
from repro_torch.core.search_space import seed_genome
from repro_torch.kernels.flash_attention import (bf16_agreement, bf16_agrees,
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
