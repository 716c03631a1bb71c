"""Training on the card: the kernels refuse inputs that require grad (they
have no backward), and a reduced train step on the card gives the CPU's
losses.  Every test needs a CUDA device and skips without one.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_train_gpu.py -m gpu -q
"""
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ssd as sm
from repro_torch.launch.train import batch_to_device, make_train_step
from repro_torch.models import init_params, lm_loss
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves, tree_map

STEP_REL = 1e-4      # fp32 losses, card vs CPU (the embedding backward uses atomics)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sm_90a kernels have no CPU mode")
    resolve_device("cuda")            # IEEE fp32 products, as on the CPU


def _inputs(kernel):
    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(s, generator=g, device="cuda", dtype=dt)  # noqa: E731
    if kernel == "flash_attention":
        return fa.flash_attention, (r(1, 4, 128, 64), r(1, 2, 128, 64), r(1, 2, 128, 64)), \
            dict(causal=True)
    if kernel == "flash_decode":
        return fd.flash_decode, (r(2, 4, 64), r(2, 2, 96, 64), r(2, 2, 96, 64),
                                 torch.tensor([5, 96], dtype=torch.int32, device="cuda")), {}
    A = -torch.linspace(1.0, 4.0, 2, device="cuda")
    return sm.ssd_chunked, (r(1, 64, 2, 64), torch.full((1, 64, 2), 0.01, device="cuda"), A,
                            r(1, 64, 1, 16), r(1, 64, 1, 16)), dict(chunk=32)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_attention", "flash_decode", "ssd_chunked"])
def test_kernel_refuses_inputs_that_require_grad(kernel):
    _need_card()
    fn, args, kw = _inputs(kernel)
    before = fn.launches
    grad_args = (args[0].clone().requires_grad_(),) + args[1:]
    with pytest.raises(RuntimeError, match=rf'{kernel} kernel has no backward.*impl="blocked"'):
        fn(*grad_args, **kw)
    assert fn.launches == before
    with torch.no_grad():                     # serving: nothing is recorded
        fn(*grad_args, **kw)
    fn(*args, **kw)                           # nothing requires grad
    assert fn.launches == before + 2


@pytest.mark.gpu
def test_loss_through_the_kernel_raises():
    _need_card()
    cfg = get_arch("qwen2-7b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    toks = torch.zeros((1, 16), dtype=torch.long, device="cuda")
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(RuntimeError, match="no backward"):
        lm_loss(params, cfg, batch, compute_dtype=torch.float32, impl="kernel")
    with pytest.raises(RuntimeError, match="no backward"):     # "auto" is the kernel here
        lm_loss(params, cfg, batch, compute_dtype=torch.float32)
    lm_loss(params, cfg, batch, compute_dtype=torch.float32, impl="blocked").backward()
    assert all(t.grad is not None for t in tree_leaves(params))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-7b", "moonshot-v1-16b-a3b", "mamba2-780m"])
def test_train_steps_on_card_match_cpu(name):
    _need_card()
    cfg = get_arch(name).reduced()
    weights = init_params(cfg, torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.clone().to(dev), weights)
        opt_state = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10),
                               n_microbatches=2, compute_dtype=torch.float32)
        pipe = TokenPipeline(cfg, 32, 4, seed=1)
        losses[dev] = []
        for _ in range(3):
            params, opt_state, _, m = step(params, opt_state, None,
                                           batch_to_device(pipe.next_batch(), dev))
            losses[dev].append(float(m["loss"]))
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert a == pytest.approx(b, rel=STEP_REL), losses
