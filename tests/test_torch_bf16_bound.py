"""The bound that holds the bf16 kernel against its plain version.

A kernel-like version (fp32 scores and statistics, P rounded to bf16 for the
P V product, as the sm_90a kernel's mma.sync path does) must agree with the
plain version; wrong versions made from the plain one must not."""
import itertools

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


# ---------------------------------------------------------------------------
# flash_decode and the SSD scan: kernel-like versions (the same function in
# fp32 in another order, rounded to bf16 once, as both sm_90a kernels do)
# must agree with the plain version; wrong versions must not.
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_decode as fd          # noqa: E402
from repro_torch.kernels import ssd as ssd_mod               # noqa: E402
from repro_torch.kernels.ref import (decode_reference,       # noqa: E402
                                     ssd_chunked_reference, ssd_reference)

DEC_B, DEC_HQ, DEC_HKV, DEC_L, DEC_D = 4, 32, 8, 4096, 128   # the served shape


def _decode_inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
               for s in ((DEC_B, DEC_HQ, DEC_D), (DEC_B, DEC_HKV, DEC_L, DEC_D),
                         (DEC_B, DEC_HKV, DEC_L, DEC_D)))
    vl = torch.tensor([1, 1000, 2047, 2080], dtype=torch.int32)
    return q, k, v, vl


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_decode_bf16_bound_accepts_another_order(softcap):
    q, k, v, vl = _decode_inputs(4)
    kw = dict(softcap=softcap)
    plain = fd.flash_decode_plain(q, k, v, vl, **kw)
    mag = fd.flash_decode_plain(q, k, v.abs(), vl, **kw)
    other = decode_reference(q, k, v, vl, softcap=softcap)   # one softmax, fp32
    stats = fd.bf16_agreement(other, plain, mag)
    assert fd.bf16_agrees(stats), stats


def test_decode_bf16_bound_rejects_a_dropped_key():
    q, k, v, vl = _decode_inputs(4)
    plain = fd.flash_decode_plain(q, k, v, vl)
    mag = fd.flash_decode_plain(q, k, v.abs(), vl)
    wrong = fd.flash_decode_plain(q, k, v, (vl - 1).clamp_min(1))
    stats = fd.bf16_agreement(wrong, plain, mag)
    assert not fd.bf16_agrees(stats), stats


SSD_B, SSD_L, SSD_H, SSD_P, SSD_N, SSD_Q = 1, 1000, 8, 64, 16, 256


def ssd_inputs(seed, B=SSD_B, L=SSD_L, H=SSD_H, P=SSD_P, N=SSD_N):
    """bf16 x, B, C at Jamba's (P, N); Mamba-2's dt range (log-uniform in
    [1e-3, 1e-1]) and Jamba's A = -linspace(1, 16), so the state carries
    across chunks."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, L, H, P)).astype(np.float32))
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, L, H)))
                          .astype(np.float32))
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm = (torch.from_numpy(rng.normal(size=(B, L, 1, N)).astype(np.float32))
              for _ in range(2))
    return x.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16), Cm.to(torch.bfloat16)


def ssd_state_rounded(x, dt, A, Bm, Cm, chunk):
    """A wrong SSD: the carried state rounded to bf16 between chunks."""
    ys, st = [], None
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        y, st = ssd_chunked_reference(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl],
                                      chunk=min(chunk, x.shape[1] - c0), init_state=st)
        st = st.to(torch.bfloat16).float()
        ys.append(y)
    return torch.cat(ys, dim=1), st


def _ssd_plain(x, dt, A, Bm, Cm):
    y, st = ssd_mod.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=SSD_Q)
    mag, _ = ssd_mod.ssd_chunked_plain(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk=SSD_Q)
    return y, st, mag


def test_ssd_bf16_bound_accepts_another_order():
    x, dt, A, Bm, Cm = ssd_inputs(6)
    y, st, mag = _ssd_plain(x, dt, A, Bm, Cm)
    oy, ost = ssd_reference(x, dt, A, Bm, Cm)            # the sequential recurrence
    stats = ssd_mod.bf16_agreement(oy, ost, y, st, mag)
    assert ssd_mod.bf16_agrees(stats), stats


def test_ssd_bf16_bound_rejects_a_state_rounded_between_chunks():
    x, dt, A, Bm, Cm = ssd_inputs(6)
    y, st, mag = _ssd_plain(x, dt, A, Bm, Cm)
    wy, wst = ssd_state_rounded(x, dt, A, Bm, Cm, SSD_Q)
    stats = ssd_mod.bf16_agreement(wy, wst, y, st, mag)
    assert not ssd_mod.bf16_agrees(stats), stats


# The chunked body's walk (ssd.ssd_chunked_split_plain): its fp32 operands
# (the weights w and the entering state) split into three bf16 terms agree
# with the plain version (tests/test_torch_ssd_chunked.py); rounded to bf16
# once, or split into only two terms, they must not.

def test_ssd_bf16_bound_rejects_operands_rounded_to_bf16_once():
    x, dt, A, Bm, Cm = ssd_inputs(6)
    y, st, mag = _ssd_plain(x, dt, A, Bm, Cm)
    wy, wst = ssd_mod.ssd_chunked_split_plain(x, dt, A, Bm, Cm, chunk=SSD_Q, terms=1)
    stats = ssd_mod.bf16_agreement(wy, wst, y, st, mag)
    assert not ssd_mod.bf16_agrees(stats), stats


def _one_step(seed, H, P, N):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, 1, H, P)).astype(np.float32))
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (2, 1, H)))
                          .astype(np.float32))
    A = torch.from_numpy(-np.exp(0.5 * rng.normal(size=H)).astype(np.float32))
    Bm, Cm = (torch.from_numpy(rng.normal(size=(2, 1, 1, N)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    return x.to(torch.bfloat16), dt, A, Bm, Cm


def test_ssd_bf16_bound_at_one_step_needs_three_terms():
    """At L = 1 y has a few hundred elements, so one bf16 rounding that flips
    moves the whole-y relative RMS by ~2e-4, the bound.  Two terms leave
    ~2^-17 of w and flip often enough to fail some of 600 draws (the card's
    grid has 12 such cases); three terms hold w exactly and fail none."""
    fails = {2: 0, 3: 0}
    for seed in range(100):
        for (P, N), H in itertools.product(ssd_mod.SHAPES, (4, 8)):
            x, dt, A, Bm, Cm = _one_step(seed, H, P, N)
            y, st = ssd_mod.ssd_chunked_plain(x, dt, A, Bm, Cm)
            mag, _ = ssd_mod.ssd_chunked_plain(x.abs(), dt, A, Bm.abs(), Cm.abs())
            for terms in fails:
                wy, wst = ssd_mod.ssd_chunked_split_plain(x, dt, A, Bm, Cm, terms=terms)
                fails[terms] += not ssd_mod.bf16_agrees(
                    ssd_mod.bf16_agreement(wy, wst, y, st, mag))
    assert fails[3] == 0 and fails[2] > 0, fails
