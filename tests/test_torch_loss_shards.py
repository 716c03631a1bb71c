"""``lm_loss``'s log-softmax over the vocab shards (``transformer._ShardNLL``)
on one process, and the loss with no mesh and on a one-rank model axis.

* The chain's pieces: each shard of padded logits (V = 256 on 3 model ranks:
  86, 86 and 84 columns and 2 pad columns of -1e30) goes through the chain
  with the three reductions over "model" answered by hand from the whole
  logits; the pieces each shard hands them, maxed and summed over the
  shards by hand, equal those answers, and each shard's loss and its
  gradient columns equal the whole ``log_softmax`` loss's within fp32
  rounding (``ROUND``, of the largest magnitude), labels < 0 and labels
  on the last shard included; pad columns get no gradient.
* No mesh: ``lm_loss`` and every gradient leaf are ``torch.equal`` to
  ``torch.log_softmax`` and ``torch.gather`` over ``lm_logits``, and no
  call takes the sharded chain.
* One model rank (a one-rank gloo group, data=1 and model=1): the loss
  takes ``log_softmax`` over the whole vocab as before, no call takes the
  sharded chain, and the loss and its gradients are ``torch.equal`` to that
  path's over the same rank's logits.
The chain across gloo ranks is held to the JAX package and one device in
``tests/test_torch_mesh.py``.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCHS
from repro_torch.data import TokenPipeline
from repro_torch.distributed import context as ctx
from repro_torch.distributed import spmd
from repro_torch.launch.train import batch_to_device
from repro_torch.models import init_params, lm_logits, lm_loss, transformer
from repro_torch.tree import tree_leaves

ROUND = 2e-6                # fp32 rounding of a changed summation order
V, M = 256, 3               # the reduced vocab on 3 model ranks, padded to 258


def _masked_mean(ll, labels):
    mask = (labels >= 0).float()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_shard_pieces_summed_by_hand_equal_the_whole_log_softmax(monkeypatch):
    rng = np.random.default_rng(0)
    z = torch.from_numpy(4 * rng.standard_normal((2, 6, V)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, (2, 6)))
    labels[0, :2] = -1                            # no loss
    labels[1, :3] = torch.tensor([V - 1, 172, 85])  # the last shard's columns, a first edge
    pad = (-V) % M
    n = (V + pad) // M
    assert (n, pad) == (86, 2)
    zp = torch.cat([z, torch.full((2, 6, pad), -1e30)], -1)
    top = zp.amax(-1)
    total = (zp - top[..., None]).exp().sum(-1)
    picked = z.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    answers = {0: ("max", top), 1: ("sum", total), 2: ("sum", picked)}
    pieces = []

    def by_hand(axis, t, op="sum"):
        assert axis == "model"
        want_op, answer = answers[len(pieces) % 3]
        assert op == want_op
        pieces.append(t.clone())
        return answer.clone()
    monkeypatch.setattr(spmd, "reduce_over", by_hand)

    whole = z.clone().requires_grad_(True)
    loss = _masked_mean(torch.gather(torch.log_softmax(whole, -1), -1,
                                     labels.clamp_min(0)[..., None])[..., 0], labels)
    loss.backward()
    grads = []
    for r in range(M):
        shard = zp[..., r * n:(r + 1) * n].clone().requires_grad_(True)
        ll = transformer._ShardNLL.apply(shard, labels.clamp_min(0), r * n)
        got = _masked_mean(ll, labels)
        a, b = got.item(), loss.item()
        assert abs(a - b) <= ROUND * abs(b), (r, a, b)
        got.backward()
        grads.append(shard.grad)
    mx = torch.stack(pieces[0::3]).amax(0)
    sums = torch.stack(pieces[1::3]).sum(0)
    held = torch.stack(pieces[2::3])
    assert torch.equal(mx, top)
    assert _rel(sums, total) <= ROUND
    assert torch.equal(held.sum(0), picked)
    assert bool(((held != 0).sum(0) <= 1).all())     # one rank holds each label
    grad = torch.cat(grads, -1)
    assert torch.equal(grad[..., V:], torch.zeros(2, 6, pad))
    assert _rel(grad[..., :V], whole.grad) <= ROUND
    assert torch.equal(grad[0, :2], torch.zeros(2, V + pad))   # labels < 0


def _model(arch, seed=0):
    cfg = ARCHS[arch].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(seed), dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = batch_to_device(TokenPipeline(cfg, 8, 2, seed=1).next_batch(), "cpu")
    batch["labels"][0, :3] = -1
    return cfg, params, batch


def _grads(params):
    out = [p.grad.clone() for p in tree_leaves(params)]
    for p in tree_leaves(params):
        p.grad = None
    return out


def test_no_mesh_loss_is_log_softmax_over_lm_logits_bit_for_bit():
    """gemma2-27b reduced: a tied head under a softcap of 30."""
    cfg, params, batch = _model("gemma2-27b")
    assert cfg.tie_embeddings and cfg.logit_softcap == 30.0
    kw = dict(compute_dtype=torch.float32, impl="blocked")
    transformer.counts["loss_shards"] = 0
    loss = lm_loss(params, cfg, batch, **kw)
    loss.backward()
    got = _grads(params)
    labels = batch["labels"].long()
    logp = torch.log_softmax(lm_logits(params, cfg, batch["tokens"], **kw), dim=-1)
    want = _masked_mean(torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0], labels)
    want.backward()
    assert torch.equal(loss, want)
    assert all(torch.equal(a, b) for a, b in zip(got, _grads(params)))
    assert transformer.counts["loss_shards"] == 0


def test_one_model_rank_keeps_the_whole_log_softmax_bit_for_bit(tmp_path):
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    cfg, params, batch = _model("qwen2-7b")
    kw = dict(compute_dtype=torch.float32, impl="blocked")
    init_process_group(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        ctx.set_mesh(make_host_mesh(model=1, device="cpu"))
        placed = distribute_params(params, ctx.get_mesh(), cfg)
        for p in tree_leaves(placed):
            p.requires_grad_(True)
        transformer.counts["loss_shards"] = 0
        loss = lm_loss(placed, cfg, batch, **kw)
        loss.backward()
        got = [p.grad.to_local().clone() for p in tree_leaves(placed)]
        assert transformer.counts["loss_shards"] == 0
        for p in tree_leaves(placed):
            p.grad = None
        labels = batch["labels"].long()
        with spmd.rows(spmd.batch_sharded(labels.shape[0])):
            logits, v_ax = transformer._logits(placed, cfg, batch["tokens"], None, None,
                                               impl=kw["impl"], genome=None,
                                               compute_dtype=kw["compute_dtype"],
                                               pad_vocab=True)
        assert v_ax == "model" and logits.shape[-1] == V
        logp = torch.log_softmax(logits, dim=-1)
        want = _masked_mean(torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0],
                            labels)
        want.backward()
        assert torch.equal(loss, want)
        assert all(torch.equal(a, p.grad.to_local()) for a, p in zip(got, tree_leaves(placed)))
    finally:
        ctx.set_mesh(None)
        dist.destroy_process_group()
