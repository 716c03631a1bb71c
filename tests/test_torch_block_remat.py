"""The per-step recompute of the port's memory-safe references
(``flash_reference_blocked``, ``flash_reference_banded``,
``ssd_chunked_reference``): under autograd each K/V block, query chunk or
SSD chunk saves only its inputs, and its backward recomputes the step, as
the JAX package's ``jax.checkpoint`` around each step does.

For each reference, on the CPU at small sizes (4 or more steps):

* the backward's products, counted by ``FlopCounterMode``, are the
  un-checkpointed loop's plus exactly one recompute of the score products
  (Q.K^T, or the SSD chunk's C.B^T and C.state), which XLA keeps of the
  reference's checkpointed step; P.V and the chunk's output and state
  products are not recomputed.  For attention that is 5 units of
  2.B.Hq.Sq.Sk.D against the loop's 4;
* no tensor saved for the backward has a step's score shape, where the
  un-checkpointed loop saves some;
* values without autograd and gradients are bit-equal to the
  un-checkpointed loop's (:func:`_blocked_loop` and its siblings, the loops
  as they were before the recompute), in fp32 and in bf16;
* gradients match ``jax.grad`` of the JAX package's function on the same
  numpy inputs within ``JAX_REL`` of the largest gradient element: both
  sides compute in fp32 and sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels import ref as jref
from repro_torch.kernels import ref

NEG_INF = ref.NEG_INF
JAX_REL = 2e-5


# ---------------------------------------------------------------------------
# the un-checkpointed loops: the yardstick
# ---------------------------------------------------------------------------


def _blocked_loop(q, k, v, *, causal=False, window=None, softcap=0.0, scale=None,
                  block_k=1024, q_offset=0):
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    rep = Hq // Hkv
    scale_ = scale if scale is not None else 1.0 / (D ** 0.5)
    bk = min(block_k, Sk)
    pad = (-Sk) % bk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    nk = (Sk + pad) // bk
    qf = q.float()
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    for j in range(nk):
        kb, vb = k[:, :, j * bk:(j + 1) * bk], v[:, :, j * bk:(j + 1) * bk]
        if rep > 1:
            kb = kb.repeat_interleave(rep, dim=1)
            vb = vb.repeat_interleave(rep, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()) * scale_
        s = ref._softcap(s, softcap)
        kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
        mask = kpos < Sk
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
        l = l * alpha + p.sum(dim=-1)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def _banded_loop(q, k, v, *, window, softcap=0.0, scale=None, chunk_q=2048):
    B, Hq, S, D = q.shape
    rep = Hq // k.shape[1]
    scale_ = scale if scale is not None else 1.0 / (D ** 0.5)
    cq = min(chunk_q, S)
    band = min(S, window + cq)
    kr = k.repeat_interleave(rep, dim=1) if rep > 1 else k
    vr = v.repeat_interleave(rep, dim=1) if rep > 1 else v
    qf = q.float()
    chunks = []
    for i in range(S // cq):
        q_lo = i * cq
        start = max(0, q_lo + cq - band)
        kb, vb = kr[:, :, start:start + band], vr[:, :, start:start + band]
        s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, q_lo:q_lo + cq],
                         kb.float()) * scale_
        s = ref._softcap(s, softcap)
        qpos = q_lo + torch.arange(cq, device=q.device)[:, None]
        kpos = start + torch.arange(band, device=q.device)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        chunks.append(torch.einsum("bhqk,bhkd->bhqd", p, vb.float()).to(q.dtype))
    return torch.cat(chunks, dim=2)


def _ssd_loop(x, dt, A, Bm, Cm, *, chunk=64, init_state=None):
    B, L, H, P = x.shape
    N = Bm.shape[3]
    Q = chunk
    Bh, Ch = ref._groups_to_heads(Bm, H).float(), ref._groups_to_heads(Cm, H).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ii = torch.arange(Q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    ys = []
    for c in range(L // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xf[:, sl], dtf[:, sl], Bh[:, sl], Ch[:, sl]
        cum = torch.cumsum(dtq * Af[None, None, :], dim=1)
        total = cum[:, -1]
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, NEG_INF)))
        cb = torch.einsum("bihn,bjhn->bijh", Cq, Bq)
        w = cb * decay * dtq[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xq)
        y_inter = torch.einsum("bihn,bhpn,bih->bihp", Cq, h, torch.exp(cum))
        w_state = torch.exp(total[:, None, :] - cum) * dtq
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bjh,bjhp,bjhn->bhpn", w_state, xq, Bq)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

B = 2
D = 8                      # unlike every block width below: shapes tell apart


def _attn_case(Hq, Hkv, Sq, Sk, **kw):
    return dict(kind="attn", Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk, kw=kw)


CASES = {
    "blocked_causal": _attn_case(4, 4, 64, 64, causal=True, block_k=16),
    "blocked_window_softcap": _attn_case(4, 4, 64, 64, causal=True, window=24,
                                         softcap=5.0, block_k=16),
    "blocked_gqa": _attn_case(6, 2, 64, 64, causal=True, block_k=16),
    "blocked_q_offset": _attn_case(4, 2, 40, 96, causal=True, q_offset=56, block_k=24),
    "blocked_ragged_sk": _attn_case(4, 4, 48, 70, block_k=16),
    "banded": _attn_case(6, 2, 96, 96, window=20, softcap=3.0, chunk_q=24),
    "ssd_grouped": dict(kind="ssd", H=4, G=2, L=64, P=8, N=6, chunk=16, init=False),
    "ssd_init_state": dict(kind="ssd", H=4, G=1, L=48, P=8, N=6, chunk=12, init=True),
}


def _fns(name):
    """(the port's reference, the yardstick loop, the JAX package's function)."""
    if name.startswith("blocked"):
        return ref.flash_reference_blocked, _blocked_loop, jref.flash_reference_blocked
    if name == "banded":
        return ref.flash_reference_banded, _banded_loop, jref.flash_reference_banded
    return ref.ssd_chunked_reference, _ssd_loop, jref.ssd_chunked_reference


def _inputs(name, seed=0):
    """numpy arrays: the function's inputs, then one cotangent per output."""
    c = CASES[name]
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)     # noqa: E731
    if c["kind"] == "attn":
        args = [f32(B, c["Hq"], c["Sq"], D), f32(B, c["Hkv"], c["Sk"], D),
                f32(B, c["Hkv"], c["Sk"], D)]
        return args, [f32(B, c["Hq"], c["Sq"], D)]
    H, G, L, P, N = c["H"], c["G"], c["L"], c["P"], c["N"]
    args = [f32(B, L, H, P), np.log1p(np.exp(f32(B, L, H))),
            -np.exp(0.5 * f32(H)), 0.5 * f32(B, L, G, N), 0.5 * f32(B, L, G, N)]
    if c["init"]:
        args.append(f32(B, H, P, N))
    return args, [f32(B, L, H, P), f32(B, H, P, N)]


def _call(fn, name, args):
    c = CASES[name]
    if c["kind"] == "attn":
        return (fn(*args, **c["kw"]),)
    kw = dict(chunk=c["chunk"], init_state=args[5] if c["init"] else None)
    return tuple(fn(*args[:5], **kw))


def _torch_grads(fn, name, dtype=torch.float32, counter=None):
    """(outputs, input gradients, the backward's FLOPs by ``FlopCounterMode``,
    the shapes of the tensors saved for the backward)."""
    arrs, cts = _inputs(name)
    args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrs]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        outs = _call(fn, name, args)
    flops = FlopCounterMode(display=False)
    with flops:
        torch.autograd.backward(outs, [torch.from_numpy(c).to(o.dtype)
                                       for c, o in zip(cts, outs)])
    return outs, [a.grad for a in args], flops.get_total_flops(), saved


def _score_shape(name) -> tuple:
    """A step's score tensor: (B, Hq, Sq, bk) for a K/V block, (B, Hq, cq,
    band) for a query chunk, (B, Q, Q, H) for an SSD chunk."""
    c = CASES[name]
    if name.startswith("blocked"):
        return (B, c["Hq"], c["Sq"], min(c["kw"]["block_k"], c["Sk"]))
    if name == "banded":
        cq = c["kw"]["chunk_q"]
        return (B, c["Hq"], cq, min(c["Sq"], c["kw"]["window"] + cq))
    return (B, c["chunk"], c["chunk"], c["H"])


def _steps(name) -> int:
    c = CASES[name]
    if name.startswith("blocked"):
        bk = c["kw"]["block_k"]
        return -(-c["Sk"] // bk)
    if name == "banded":
        return c["Sq"] // c["kw"]["chunk_q"]
    return c["L"] // c["chunk"]


def _recompute_flops(name) -> int:
    """One recompute of the score products: Q.K^T of every step (the padded
    last block included), or per SSD chunk C.B^T and C.state."""
    c = CASES[name]
    shape = _score_shape(name)
    if c["kind"] == "attn":
        return _steps(name) * 2 * int(np.prod(shape)) * D
    Q, H, P, N = c["chunk"], c["H"], c["P"], c["N"]
    return _steps(name) * (2 * B * Q * Q * H * N + 2 * B * Q * H * P * N)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_backward_recomputes_the_score_products_once(name):
    ref.counts["step_remat"] = 0
    _, _, flops, _ = _torch_grads(_fns(name)[0], name)
    assert ref.counts["step_remat"] == _steps(name) >= 4
    _, _, loop_flops, _ = _torch_grads(_fns(name)[1], name)
    assert flops == loop_flops + _recompute_flops(name)
    if CASES[name]["kind"] == "attn":                  # 4 units and 5: no P.V
        assert 4 * flops == 5 * loop_flops


@pytest.mark.parametrize("name", CASES)
def test_no_step_saves_its_scores(name):
    score = _score_shape(name)
    _, _, _, saved = _torch_grads(_fns(name)[0], name)
    assert saved and score not in saved, (score, saved)
    _, _, _, loop_saved = _torch_grads(_fns(name)[1], name)
    assert score in loop_saved                          # the check can see one


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_values_and_gradients_equal_the_unchecked_loop(name, dtype):
    port, loop, _ = _fns(name)
    arrs, _ = _inputs(name)
    with torch.no_grad():
        plain = [torch.from_numpy(a).to(dtype) for a in arrs]
        for a, b in zip(_call(port, name, plain), _call(loop, name, plain)):
            assert torch.equal(a, b)
    outs, grads, _, _ = _torch_grads(port, name, dtype)
    louts, lgrads, _, _ = _torch_grads(loop, name, dtype)
    for a, b in zip(outs, louts):
        assert torch.equal(a, b)
    for i, (g, lg) in enumerate(zip(grads, lgrads)):
        assert g.dtype == dtype and torch.equal(g, lg), f"input {i}"


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_jax(name):
    port, _, jfn = _fns(name)
    arrs, cts = _inputs(name)
    _, grads, _, _ = _torch_grads(port, name)

    def loss(*args):
        outs = _call(jfn, name, list(args))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts))

    jgrads = jax.grad(loss, argnums=tuple(range(len(arrs))))(*map(jnp.asarray, arrs))
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        jg = np.asarray(jg)
        err = np.abs(g.numpy() - jg).max()
        assert err <= JAX_REL * np.abs(jg).max(), f"input {i}: {err}"
