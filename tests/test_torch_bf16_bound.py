"""The bound that holds the bf16 kernel against its plain version.

A kernel-like version (fp32 scores and statistics, P rounded to bf16 for the
P V product, as the sm_90a kernel's mma.sync path does) must agree with the
plain version; wrong versions made from the plain one must not."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (bf16_agreement, bf16_agrees,
                                                 flash_attention_plain)

B, H, S, D = 1, 4, 2048, 128
BASE = dict(block_q=1024, block_k=1024, rescale_mode="branchless",
            mask_mode="block_skip", div_mode="deferred", kv_in_grid=True)


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(3))


def _kernel_like(q, k, v, causal, div_mode):
    s = (q.float() @ k.float().transpose(-1, -2)) / D ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if div_mode == "eager":          # P scaled by 1 / l before it is rounded
        o = (p / l).to(torch.bfloat16).float() @ v.float()
    else:
        o = (p.to(torch.bfloat16).float() @ v.float()) / l
    return o.to(torch.bfloat16)


@pytest.mark.parametrize("div_mode", ["deferred", "eager"])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_bound_accepts_p_rounded_like_the_kernel(causal, div_mode):
    q, k, v = _qkv(3)
    plain = flash_attention_plain(q, k, v, causal=causal, **BASE)
    mag = flash_attention_plain(q, k, v.abs(), causal=causal, **BASE)
    stats = bf16_agreement(_kernel_like(q, k, v, causal, div_mode), plain, mag)
    assert bf16_agrees(stats), stats


@pytest.mark.parametrize("control", ["bf16_acc_every_64_keys", "keys_dropped"])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_bound_rejects_wrong_versions(causal, control):
    q, k, v = _qkv(3)
    plain = flash_attention_plain(q, k, v, causal=causal, **BASE)
    if control == "bf16_acc_every_64_keys":
        kw = dict(BASE, block_k=64, acc_dtype="bf16")
    else:                      # rows past S - S/32 lose their oldest keys
        kw = dict(BASE, window=S - S // 32)
    wrong = flash_attention_plain(q, k, v, causal=causal, **kw)
    mag = flash_attention_plain(q, k, v.abs(), causal=causal, **BASE)
    stats = bf16_agreement(wrong, plain, mag)
    assert not bf16_agrees(stats), stats
