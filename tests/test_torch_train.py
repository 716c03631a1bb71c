"""The port's training path against the JAX package's on the same weights
and batches: ``lm_loss`` and its gradients, the MoE auxiliary loss, remat,
and the microbatched train step with gradient compression.

JAX's ``init_params`` draws the weights, ``params_from_jax`` carries them
across, and ``TokenPipeline`` (numpy only, bit-equal in both packages)
makes the batches.  Both packages run their ``blocked`` references in fp32.
Tolerances: the loss to 1e-5 relative; per gradient leaf, max |dg| at most
1e-4 of max |g| of the JAX leaf (fp32 on both sides, summation order
differs); train-step losses to 1e-4 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.models.moe import moe_apply as jax_moe_apply
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.distributed import collectives as jax_collectives
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.guard import refuse_autograd
from repro_torch.launch.train import (batch_to_device, default_microbatches,
                                      init_train_state, make_train_step)
from repro_torch.models import lm_loss, params_from_jax
from repro_torch.models.moe import moe_apply
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.distributed import collectives
from repro_torch.tree import tree_leaves

LOSS_REL = 1e-5
GRAD_REL = 1e-4
STEP_REL = 1e-4
GRAD_ARCHS = ["qwen2-7b", "mamba2-780m", "jamba-v0.1-52b", "gemma2-27b",
              "moonshot-v1-16b-a3b", "phi-3-vision-4.2b", "seamless-m4t-medium"]


def _pair(name, seed=0, **changes):
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), **changes)
    cfg = dataclasses.replace(ARCHS[name].reduced(), **changes)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp))
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    return jcfg, cfg, jp, tp


def _batch(cfg, B=2, S=16, seed=1):
    return TokenPipeline(cfg, S, B, seed=seed).next_batch()


def _torch_grads(tp, cfg, batch, **kw):
    loss = lm_loss(tp, cfg, batch_to_device(batch, "cpu"), compute_dtype=torch.float32,
                   impl="blocked", **kw)
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _jax_grads(jp, jcfg, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.value_and_grad(lambda p: jax_lm_loss(
        p, jcfg, jb, compute_dtype=jnp.float32, impl="blocked"))(jp)
    # jax flattens dicts in sorted-key order, as tree_leaves does
    return float(loss), [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _assert_grads_close(ours, theirs, names, what):
    assert len(ours) == len(theirs) == len(names)
    for g, j, n in zip(ours, theirs, names):
        assert g.shape == j.shape, (what, n)
        scale = float(np.abs(j).max())
        err = float(np.abs(g - j).max())
        assert err <= GRAD_REL * max(scale, 1e-30), f"{what} {n}: {err} vs max |g| {scale}"


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_loss_and_every_gradient_match_jax(name):
    jcfg, cfg, jp, tp = _pair(name)
    batch = _batch(cfg)
    if cfg.n_prefix_embeds:
        assert "prefix_embeds" in batch and (batch["labels"][:, :cfg.n_prefix_embeds] < 0).all()
    if cfg.enc_dec:                     # the frames the encoder reads
        assert batch["enc_frames"].shape == (2, 16, cfg.d_model)
    lt, gt = _torch_grads(tp, cfg, batch)
    lj, gj = _jax_grads(jp, jcfg, batch)
    assert abs(lt - lj) <= LOSS_REL * abs(lj), (lt, lj)
    _assert_grads_close(gt, gj, _leaf_names(tp), name)


@pytest.mark.parametrize("name", ["qwen2-7b", "jamba-v0.1-52b", "moonshot-v1-16b-a3b",
                                  "seamless-m4t-medium"])
def test_remat_gives_the_same_gradients(name):
    """cfg.remat on (per period; per block inside jamba's 8-block period;
    seamless's decoder periods close over the encoder's output) against
    off: the same loss and gradients, and both against JAX's remat'd
    gradients."""
    jcfg, cfg, jp, tp = _pair(name, remat=True)
    batch = _batch(cfg)
    l_on, g_on = _torch_grads(tp, cfg, batch)
    l_off, g_off = _torch_grads(tp, dataclasses.replace(cfg, remat=False), batch)
    assert l_on == l_off
    names = _leaf_names(tp)
    for a, b, n in zip(g_on, g_off, names):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * float(np.abs(b).max()) + 1e-30,
                                   err_msg=n)
    lj, gj = _jax_grads(jp, jcfg, batch)
    assert abs(l_on - lj) <= LOSS_REL * abs(lj)
    _assert_grads_close(g_on, gj, names, f"{name} remat")


def test_moe_aux_loss_matches_jax():
    name = "moonshot-v1-16b-a3b"
    jcfg = JAX_ARCHS[name].reduced()
    cfg = ARCHS[name].reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(2))["dec"]["pos0"]["moe"]
    jp = jax.tree_util.tree_map(lambda a: np.array(a)[0], jp)
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((3, 10, cfg.d_model)).astype(np.float32)
    out, aux = moe_apply(torch.from_numpy(x), tp, cfg, torch.float32, return_aux=True)
    jout, jaux = jax_moe_apply(jnp.asarray(x), jp, jcfg, jnp.float32, return_aux=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    assert float(aux) >= 1.0 - 1e-6          # E * sum f p >= 1, equality when balanced
    torch.testing.assert_close(moe_apply(torch.from_numpy(x), tp, cfg, torch.float32), out)


def _jax_state(jp, compression):
    res = jax_collectives.compress_init(jp) if compression == "int8_ef" else None
    return jp, jax_adamw_init(jp), res


@pytest.mark.parametrize("compression", ["none", "bf16", "int8_ef"])
@pytest.mark.parametrize("nm", [1, 4])
def test_train_steps_match_jax(nm, compression):
    """Three steps of the microbatched train step from the same weights and
    batches: the loss at each step within 1e-4 relative (the second and
    third read the parameters after one and two updates), the gradient
    norm and the learning rate.  The update itself is held to JAX's on
    equal gradients in test_torch_optim.py."""
    jcfg, cfg, jp, tp = _pair("qwen2-7b")
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, AdamWConfig(**kw), n_microbatches=nm,
                           compression=compression, compute_dtype=torch.float32)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**kw), n_microbatches=nm,
                                        compression=compression,
                                        compute_dtype=jnp.float32))
    opt = adamw_init(tp)
    res = collectives.compress_init(tp) if compression == "int8_ef" else None
    jp, jopt, jres = _jax_state(jp, compression)
    pipe, jpipe = TokenPipeline(cfg, 16, 8, seed=3), JaxPipeline(jcfg, 16, 8, seed=3)
    for i in range(3):
        b, jb = pipe.next_batch(), jpipe.next_batch()
        tp, opt, res, m = step(tp, opt, res, batch_to_device(b, "cpu"))
        jp, jopt, jres, jm = jstep(jp, jopt, jres, {k: jnp.asarray(v) for k, v in jb.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=STEP_REL), i
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4), i
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6), i
    assert int(opt.step) == int(jopt.step) == 3
    if compression == "int8_ef":
        assert all(float(r.abs().max()) > 0 for r in tree_leaves(res))


def test_loss_descends_30_steps():
    """test_train_integration.py::test_loss_descends_30_steps on the port."""
    cfg = ARCHS["qwen2-7b"].reduced()
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    params, opt_state, residual = init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, opt, compute_dtype=torch.float32)
    pipe = TokenPipeline(cfg, 32, 8, seed=0)
    losses = []
    for _ in range(30):
        params, opt_state, residual, m = step(params, opt_state, residual,
                                              batch_to_device(pipe.next_batch(), "cpu"))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
    assert np.mean(losses[-5:]) < np.log(cfg.vocab_size)


def test_default_microbatches_match_jax():
    from repro.launch.train import default_microbatches as jax_default
    for name in ("gemma2-27b", "qwen2-7b", "mixtral-8x22b", "jamba-v0.1-52b"):
        for args in ((256,), (256, 4096), (64, 4096, 16, 16), (8, 1024, 1, 1, 8e10)):
            assert default_microbatches(ARCHS[name], *args) == \
                jax_default(JAX_ARCHS[name], *args), (name, args)


def test_init_train_state_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(ARCHS["qwen2-7b"].reduced())


# -- the kernels' guard --------------------------------------------------------


def test_guard_refuses_inputs_that_require_grad():
    a = torch.zeros(2, requires_grad=True)
    b = torch.zeros(2)
    with pytest.raises(RuntimeError, match=r'flash_attention.*impl="blocked"'):
        refuse_autograd("flash_attention", b, a)
    refuse_autograd("flash_attention", b, b)              # nothing requires grad
    with torch.no_grad():
        refuse_autograd("flash_attention", a, b)          # autograd records nothing
    with pytest.raises(RuntimeError, match="ssd_chunked"):
        refuse_autograd("ssd_chunked", b, b, a * 2)


@pytest.mark.parametrize("name", ["qwen2-7b", "jamba-v0.1-52b"])
def test_bf16_gradients_as_close_to_fp32_as_jax(name):
    """compute_dtype bf16 (the card's training dtype), remat on: the casts
    sit where the JAX package's do, so the port's bf16 loss and gradients
    are as near the fp32 ones as the JAX package's bf16 are.  bf16 rounding
    alone moves a gradient leaf by several per cent of its largest
    magnitude here (Mamba's chains most), so the check is relative to JAX:
    the loss within 1e-2 of JAX's bf16 loss, and the port's error to JAX's
    fp32 gradients, averaged over the leaves, at most 1.5x JAX's own."""
    jcfg, cfg, jp, tp = _pair(name, remat=True)
    batch = _batch(cfg)
    loss = lm_loss(tp, cfg, batch_to_device(batch, "cpu"), compute_dtype=torch.bfloat16,
                   impl="blocked")
    gt = [g.float().numpy() for g in torch.autograd.grad(loss, tree_leaves(tp))]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = {}
    for dt in (jnp.bfloat16, jnp.float32):
        jl, jg = jax.value_and_grad(lambda p: jax_lm_loss(
            p, jcfg, jb, compute_dtype=dt, impl="blocked"))(jp)
        grads[dt] = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(jg)]
        if dt == jnp.bfloat16:
            assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-2)
    ours, theirs = [], []
    for g, j16, j32 in zip(gt, grads[jnp.bfloat16], grads[jnp.float32]):
        scale = float(np.abs(j32).max()) + 1e-30
        ours.append(float(np.abs(g - j32).max()) / scale)
        theirs.append(float(np.abs(j16 - j32).max()) / scale)
    assert np.mean(ours) <= 1.5 * np.mean(theirs), (np.mean(ours), np.mean(theirs))
