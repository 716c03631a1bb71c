"""Collectives on each rank's local shards, with the backward each needs:
how the models run under a mesh.  With no mesh every function here is the
identity (``use`` returns the parameter, ``local_rows`` the batch), so a
model block has one body for one device and for a mesh.

Under a mesh (``context.set_mesh``) the activations are plain tensors, each
rank's batch shard (the rows of its data-parallel index, pod-major; the
whole batch where the data-parallel size does not divide it), whole over
the "model" axis.  Where a decode cache's length splits
(``context.length_axes``: over the data axes where the batch does not
split, over "model" where the attention keeps every head on every model
rank), each rank holds its shard of the cache's length and the attention's
partials are merged across the ranks (``merge_over``).  Parameters are
DTensors placed by ``sharding``; a block takes each as a local tensor in
the layout it computes with (``use``), gathering the dims the rules shard
and the block does not.  Where a block
splits its work over "model" (heads, experts, the expert or MLP hidden dim,
the vocab), its input enters through ``enter_model`` (identity; the
backward sums the ranks' partial gradients) and its output leaves through
``sum_model`` (the sum of the ranks' parts; the backward is the identity):
Megatron's f and g.  The collectives are ``torch.distributed``'s on the
mesh's process groups; nothing here runs DTensor's sharding propagation.

Decode multiplies each weight where it lies (``stationary``, ``dot``,
``lookup``): the rows of the product go to the weight's shard, never the
weight to the rows, as the JAX package's compiled decode step partitions
each product by the weight's ``param_shardings``.

Gradients: a gathered weight's gradient is summed over the ranks that use
different data (the data-parallel ranks, and model ranks whose parts are
partial) and sliced back to this rank's shard, so a parameter's ``.grad``
is placed as the parameter is, but for "pod" (``grad_placements``).  The
"pod" axis is pure data parallelism: the backward leaves each pod its own
gradient, labelled ``Partial`` over "pod", and
``collectives.reduce_gradients`` sums them over "pod" in the compressed
dtype; a ``full_tensor()`` before that sums them in fp32.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed import context as ctx
from repro_torch.kernels.flash_decode import merge_partials


class Local(NamedTuple):
    """A parameter's local shard and the DTensor placements it came with
    (one per mesh dim): a period's slice of a stacked parameter."""
    t: torch.Tensor
    placements: tuple


def _group(axis: str):
    return ctx.get_mesh().get_group(axis)


def rank(axis: str) -> int:
    """This rank's index along ``axis`` (0 without it)."""
    if axis not in ctx.axis_names():
        return 0
    return ctx.get_mesh().get_local_rank(axis)


class _SumFwd(torch.autograd.Function):
    """The sum over a group; the backward passes the gradient through."""

    @staticmethod
    def forward(fctx, t, group):
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(fctx, grad):
        return grad, None


class _SumBwd(torch.autograd.Function):
    """The identity; the backward sums the gradient over a group."""

    @staticmethod
    def forward(fctx, t, group):
        fctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(fctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=fctx.group)
        return grad, None


class _Gather(torch.autograd.Function):
    """Every rank's ``t`` of a group concatenated along ``dim`` in the
    group's order.  The backward gives each rank its slice of the gradient,
    summed over the group first when the ranks' gradients are partial."""

    @staticmethod
    def forward(fctx, t, dim, group, partial):
        n = dist.get_world_size(group)
        fctx.dim, fctx.group, fctx.partial = dim, group, partial
        fctx.n, fctx.rank = n, dist.get_rank(group)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(fctx, grad):
        if fctx.partial:
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=fctx.group)
        return grad.chunk(fctx.n, fctx.dim)[fctx.rank].contiguous(), None, None, None


def sum_model(t: torch.Tensor) -> torch.Tensor:
    """The sum of the model ranks' parts (g); the identity without a split."""
    if ctx.axis_size("model") == 1:
        return t
    return _SumFwd.apply(t, _group("model"))


def enter_model(t: torch.Tensor) -> torch.Tensor:
    """``t`` into work split over "model" (f): the backward sums the model
    ranks' partial gradients."""
    if ctx.axis_size("model") == 1:
        return t
    return _SumBwd.apply(t, _group("model"))


def gather(t: torch.Tensor, dim: int, axis: str, partial: bool) -> torch.Tensor:
    """All of ``axis``'s shards of ``t`` along ``dim`` (see ``_Gather``)."""
    if ctx.axis_size(axis) == 1:
        return t
    return _Gather.apply(t, dim, _group(axis), partial)


def _names(axes) -> tuple:
    """A spec entry (an axis name, a tuple of them or None) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_size(axes) -> int:
    """The number of ranks over ``axes`` (a spec entry) together."""
    n = 1
    for a in _names(axes):
        n *= ctx.axis_size(a)
    return n


def axes_rank(axes) -> int:
    """This rank's index over ``axes`` (a spec entry), the first axis
    major."""
    r = 0
    for a in _names(axes):
        r = r * ctx.axis_size(a) + rank(a)
    return r


def dp_size() -> int:
    return axes_size(ctx.batch_axes())


def dp_rank() -> int:
    """This rank's index among the data-parallel shards, pod-major."""
    return axes_rank(ctx.batch_axes())


def batch_sharded(n: int) -> bool:
    """Whether a batch of ``n`` rows is split over the data-parallel ranks."""
    return ctx.batch_spec(n) is not None


_ROWS_SHARDED = False


@contextlib.contextmanager
def rows(sharded: bool):
    """The scope in which the blocks run: whether this rank's rows are its
    data-parallel shard (else every rank holds the whole batch)."""
    global _ROWS_SHARDED
    prev, _ROWS_SHARDED = _ROWS_SHARDED, sharded
    try:
        yield
    finally:
        _ROWS_SHARDED = prev


def rows_sharded() -> bool:
    return _ROWS_SHARDED


def local_rows(t):
    """This rank's rows of a global batch tensor (the same on every rank):
    its data-parallel shard, or all rows where the shards do not divide
    them.  None stays None."""
    if t is None or not batch_sharded(t.shape[0]):
        return t
    return t.chunk(dp_size(), 0)[dp_rank()]


def gather_rows(t: torch.Tensor, partial: bool) -> torch.Tensor:
    """Every data-parallel rank's rows of ``t`` (pod-major), whose
    gradient is summed over those ranks first when ``partial``."""
    for a in reversed(ctx.batch_axes()):          # minor first: data, then pod
        t = gather(t, 0, a, partial)
    return t


def merge_over(axes, o: torch.Tensor, M: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """One decode output from the partials of every rank over ``axes`` (the
    data axes, or "model"), each over its shard of a length-sharded cache:
    ``o`` (B, Hq, D), ``M`` and ``l`` (B, Hq), fp32, as the partial decode
    returns them.  The ranks' partials are gathered in ``axes_rank`` order
    (one all-gather of B x Hq x (D + 2) floats over each axis, the minor
    first: "data", then "pod") and merged there (``merge_partials``);
    every rank holds the same result."""
    D = o.shape[-1]
    t = torch.cat([o, M[..., None], l[..., None]], dim=-1)[None]
    for a in reversed(_names(axes)):
        t = gather(t, 0, a, partial=False)
    return merge_partials(t[..., :D], t[..., D], t[..., D + 1])


def reduce_over(axis: str, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``axis`` by ``op`` ("sum" or "max") in place, with
    no gradient; ``t`` as it is on one rank."""
    if ctx.axis_size(axis) > 1:
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()), group=_group(axis))
    return t


def batch_axes_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the data-parallel ranks, with no gradient (counts)."""
    t = t.detach().clone()
    for a in ctx.batch_axes():
        if ctx.axis_size(a) > 1:
            dist.all_reduce(t, group=_group(a))
    return t


def pod_partial(placements, names) -> tuple:
    """``placements`` on a mesh with axes ``names``, but ``Partial`` over
    "pod": each pod holds its own part, and the whole is their sum."""
    return tuple(Partial() if n == "pod" else p for n, p in zip(names, placements))


def grad_placements(leaf: DTensor) -> tuple:
    """The placements of a parameter's gradient from the backward: the
    parameter's, but ``Partial`` over "pod" (each pod's own gradient)."""
    return pod_partial(leaf.placements, leaf.device_mesh.mesh_dim_names)


def _local(leaf: DTensor) -> torch.Tensor:
    return leaf.to_local(grad_placements=grad_placements(leaf))


def zero_grad(leaf, dtype=None):
    """The zero gradient of a parameter the loss did not reach, placed as
    the backward places a gradient (in ``dtype``, the parameter's when
    None)."""
    if not isinstance(leaf, DTensor):
        return torch.zeros_like(leaf, dtype=dtype)
    return DTensor.from_local(torch.zeros_like(leaf.to_local(), dtype=dtype),
                              leaf.device_mesh, grad_placements(leaf), run_check=False)


def unstack(leaf) -> list:
    """A stacked parameter (DTensor) as one ``Local`` per period: its local
    shard unbound along the leading dim (never sharded), each slice with
    the placements shifted down one dim."""
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in leaf.placements)
    return [Local(t, pl) for t in torch.unbind(_local(leaf), 0)]


def _sharded_dims(placements: tuple) -> dict:
    """{mesh axis: tensor dim} of the sharded placements."""
    names = ctx.axis_names()
    return {names[i]: p.dim for i, p in enumerate(placements) if isinstance(p, Shard)}


def sum_grad(t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t``, whose gradient is summed over ``axis`` in the backward."""
    if ctx.axis_size(axis) == 1:
        return t
    return _SumBwd.apply(t, _group(axis))


def use(leaf, *spec, model_partial: bool = False, rows_partial: bool = True):
    """A parameter (``Local`` or DTensor) as the local tensor a block
    computes with: each dim its placements shard over an axis the block's
    ``spec`` does not name is gathered.  The gradient is summed over "data"
    when ``rows_partial`` (each data-parallel rank holds other tokens) and
    over "model" when ``model_partial`` (the block's model ranks each use
    part of the weight), then sliced back to this rank's shard; a weight
    whole over such an axis gets the sum alone.  A dim the spec shards and
    the placements do not is sliced to this rank's part (its gradient
    summed over the axis).  With no mesh, the parameter as it is."""
    if ctx.get_mesh() is None:
        return leaf
    if isinstance(leaf, DTensor):
        leaf = Local(_local(leaf), tuple(leaf.placements))
    t = leaf.t
    spec = tuple(spec) + (None,) * (t.ndim - len(spec))
    sharded = _sharded_dims(leaf.placements)
    for axis, partial in (("data", rows_partial), ("model", model_partial)):
        if axis not in ctx.axis_names():
            continue
        if axis in sharded and spec[sharded[axis]] != axis:
            t = gather(t, sharded[axis], axis, partial)
        elif axis not in sharded and (partial or axis in spec):
            t = sum_grad(t, axis)
        if axis in spec and axis not in sharded:         # this rank's slice of the whole
            t = own_part(t, spec.index(axis), axis)
    return t


def part(n: int, m: int, r: int) -> tuple:
    """Rank ``r``'s (start, length) of a dim of ``n`` split over ``m`` ranks
    as DTensor's ``Shard`` splits it: ceil(n / m) a rank, the rest on the
    last rank that has any, and an empty part on a rank past the end
    (``torch.chunk`` returns fewer than m pieces there)."""
    per = -(-n // m)
    start = min(r * per, n)
    return start, min(start + per, n) - start


def own_part(t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This rank's part of ``t``'s dim ``dim`` split over ``axis``
    (``part``): a view, split off as ``torch.chunk`` splits."""
    m = ctx.axis_size(axis)
    sizes = [part(t.shape[dim], m, r)[1] for r in range(m)]
    return t.split(sizes, dim)[rank(axis)]


def wrap(t: torch.Tensor, *spec, shape=None):
    """A local result of every rank as one DTensor placed by ``spec`` (no
    communication); for what an entry point returns.  ``shape`` is the
    global shape, needed where a dim splits unevenly (``part``); without
    it each sharded dim is taken as the local one times its ranks.  With
    no mesh, ``t``."""
    if ctx.get_mesh() is None:
        return t
    from repro_torch.distributed.sharding import placements
    kw = {}
    if shape is not None:              # contiguous strides, no tensor made for them
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        kw = dict(shape=torch.Size(shape), stride=stride)
    return DTensor.from_local(t, ctx.get_mesh(), placements(spec, ctx.get_mesh()),
                              run_check=False, **kw)


# ---------------------------------------------------------------------------
# products on the weight's shard (decode)
# ---------------------------------------------------------------------------

_STATIONARY = False

# the stationary route's products and the collectives it issued, since the
# caller last set them to 0 (the one-rank card mesh must issue none)
counts = {"products": 0, "collectives": 0}


@contextlib.contextmanager
def stationary():
    """The scope of ``decode_step``: ``dot`` and ``lookup`` take each
    weight's local shard and move the activations instead of the weight.
    Outside it (prefill, ``lm_logits``, training) they gather the weight
    through ``use``, as before."""
    global _STATIONARY
    prev, _STATIONARY = _STATIONARY, True
    try:
        yield
    finally:
        _STATIONARY = prev


def _product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.bmm(h, w) if w.ndim == 3 else h @ w


def dot(h: torch.Tensor, leaf, *spec, model_partial: bool = False, rows_partial: bool = True,
        transposed: bool = False) -> torch.Tensor:
    """``h @ W`` for a parameter W (``Local``, DTensor or, with no mesh, a
    tensor) of shape (K, N), or (N, K) with ``transposed``; a 3-D expert
    weight (E, K, N) takes ``h`` (E, C, K) through ``torch.bmm``.  ``spec``
    names the dims the block splits, as for ``use``; W is cast to
    ``h.dtype``, the compute dtype.

    Outside ``stationary`` (or with no mesh) it is ``h @ use(W, *spec,
    ...)``.  Inside it W stays this rank's shard.  An axis that shards a dim
    of W the spec does not name acts by that dim's role:

    * the contracting dim: this rank's slice of ``h``'s last dim goes in,
      and the partial products, in fp32, are summed over the axis, then
      rounded to the compute dtype once;
    * the output dim: this rank's columns are computed, then gathered over
      the axis.

    Where the rows are this rank's data-parallel shard (``rows_sharded``)
    and "data" has a role, every data rank's rows go in (the weights are
    whole over "pod") and this rank keeps its own rows of the result: a
    contracting dim over "data" takes every rank's rows of this rank's
    slice (one all-to-all of this rank's rows), an output dim over "data"
    takes every rank's rows whole (an all-gather) and sends each rank its
    rows of this rank's columns (an all-to-all).  An axis of size 1 has no
    role: on one rank the route is ``h @ W``.  Any other placement (a
    sharded expert dim the spec does not name, "pod", ``Partial``) raises;
    nothing falls back to gathering W.  The route has no backward and
    refuses inputs that require grad.
    Leaves that no product contracts (norms, biases, ``conv_w``, ``A_log``,
    ``D_skip``, ``dt_bias``, ``gate_norm``) keep ``use``: each is at most a
    few MB gathered."""
    if not _STATIONARY or ctx.get_mesh() is None:
        w = use(leaf, *spec, model_partial=model_partial, rows_partial=rows_partial)
        w = w.to(h.dtype)
        return _product(h, w.mT if transposed else w)
    t, placements = _shard(leaf, h)
    nd = t.ndim
    kd, od = (nd - 1, nd - 2) if transposed else (nd - 2, nd - 1)
    roles = _roles(placements, _full_spec(spec, nd), {kd: "contract", od: "columns"})
    t = _slice_named(t, placements, spec)
    row = 1 if nd == 3 else 0                  # h's row dim: tokens, or an expert's slots
    x, own = _rows_in(h, row, roles, t.shape[kd])
    contract = [a for a, r in roles.items() if r == "contract"]
    w = t.to(h.dtype)
    w = w.mT if transposed else w
    if contract:
        y = _product(x.float(), w.float())
        for axis in contract:
            _all_reduce(y, axis)
        y = y.to(h.dtype)
    else:
        y = _product(x, w)
    counts["products"] += 1
    return _columns_out(y, row, own, roles)


def lookup(leaf, ids: torch.Tensor, dtype) -> torch.Tensor:
    """The rows ``ids`` of an embedding table (V, D), in ``dtype``.
    Outside ``stationary``, ``use(table)[ids]``.  Inside it the table stays
    this rank's shard: a vocab dim sharded over an axis gives the rows of
    this rank's vocab slice (the others read 0), summed over the axis (one
    rank holds each row: the sum is exact); a D dim sharded over an axis
    gives this rank's columns, gathered over it.  The rows of ``ids`` are
    handled as ``dot`` handles its rows."""
    if not _STATIONARY or ctx.get_mesh() is None:
        return use(leaf)[ids].to(dtype)
    t, placements = _shard(leaf, None)
    roles = _roles(placements, (None, None), {0: "vocab", 1: "columns"})
    x, own = _rows_in(ids, 0, roles, None)
    vocab = [a for a, r in roles.items() if r == "vocab"]
    if vocab:
        (axis,) = vocab
        n = t.shape[0]
        local = x - rank(axis) * n
        held = (local >= 0) & (local < n)
        y = torch.where(held[..., None], t[local.clamp(0, n - 1)].to(dtype), 0)
        _all_reduce(y, axis)
    else:
        y = t[x].to(dtype)
    counts["products"] += 1
    return _columns_out(y, 0, own, roles)


def _shard(leaf, h):
    """(the local shard, its placements) of a parameter; raises where
    autograd would record the route."""
    if isinstance(leaf, DTensor):
        leaf = Local(leaf.to_local(), tuple(leaf.placements))
    if torch.is_grad_enabled() and (leaf.t.requires_grad
                                    or (h is not None and h.requires_grad)):
        raise RuntimeError("the stationary product has no backward: an input requires "
                           "grad. Decode under torch.no_grad(), or on parameters that "
                           "need none")
    return leaf.t, leaf.placements


def _full_spec(spec, nd: int) -> tuple:
    return tuple(spec) + (None,) * (nd - len(spec))


def _roles(placements, spec: tuple, by_dim: dict) -> dict:
    """{axis: role} of every axis of size > 1 that shards a dim of the
    weight its ``spec`` does not name: ``by_dim[dim]``.  Raises on a
    placement the stationary route does not handle."""
    names = ctx.axis_names()
    roles = {}
    for axis, p in zip(names, placements):
        if isinstance(p, Replicate) or ctx.axis_size(axis) == 1:
            continue
        if not isinstance(p, Shard) or axis == "pod":
            raise ValueError(f"the stationary product has no route for {p} over {axis!r}")
        if spec[p.dim] == axis:
            continue                                 # the block computes on this shard
        if spec[p.dim] is not None or p.dim not in by_dim:
            raise ValueError(f"the stationary product has no route for a weight's dim "
                             f"{p.dim} sharded over {axis!r} under the block's spec {spec}")
        roles[axis] = by_dim[p.dim]
    return roles


def _slice_named(t: torch.Tensor, placements, spec) -> torch.Tensor:
    """``t`` sliced to this rank's part (``part``) of each dim the spec
    names over an axis that holds the weight whole there (no
    communication)."""
    sharded = _sharded_dims(placements)
    for dim, axis in enumerate(spec):
        if axis is not None and axis not in sharded and ctx.axis_size(axis) > 1:
            t = own_part(t, dim, axis)
    return t


def _all_reduce(t: torch.Tensor, axis: str) -> None:
    dist.all_reduce(t, group=_group(axis))
    counts["collectives"] += 1


def _gather_counted(t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    counts["collectives"] += 1
    return gather(t, dim, axis, partial=False)


def _all_to_all(t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t`` (n, ...): chunk j goes to rank j of ``axis``; chunk j of the
    result came from rank j."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=_group(axis))
    counts["collectives"] += 1
    return out


def _rows_in(h: torch.Tensor, row: int, roles: dict, k):
    """``h`` as the product takes it, and this rank's row count where the
    result must be cut back to its own rows (else None): cut to this
    rank's slice (``k`` wide) of the last dim over each axis that contracts
    it, and where its rows are this rank's data-parallel shard and "data"
    has a role, every data rank's rows (along ``row``, in rank order),
    through one all-to-all where "data" contracts."""
    exchange = rows_sharded() and "data" in roles
    for axis, role in roles.items():
        if role == "contract" and not (exchange and axis == "data"):
            h = h.narrow(-1, rank(axis) * k, k)
    if not exchange:
        return h, None
    n, own = ctx.axis_size("data"), h.shape[row]
    if roles["data"] != "contract":
        return _gather_counted(h, row, "data"), own
    parts = h.movedim(row, 0).unflatten(-1, (n, -1)).movedim(-2, 0)
    return _all_to_all(parts, "data").flatten(0, 1).movedim(0, row), own


def _columns_out(y: torch.Tensor, row: int, own, roles: dict) -> torch.Tensor:
    """The result with every column of this rank's rows: the columns of an
    axis that gave this rank only its own gathered over it, over "data"
    by an all-to-all where every data rank holds every row and keeps its
    own."""
    if roles.get("data") == "columns" and own is not None:
        n = ctx.axis_size("data")
        parts = y.movedim(row, 0).unflatten(0, (n, -1))
        y = _all_to_all(parts, "data").movedim(0, -2).flatten(-2).movedim(0, row)
    elif roles.get("data") == "columns":
        y = _gather_counted(y, -1, "data")
    elif own is not None:
        y = y.narrow(row, rank("data") * own, own)
    if roles.get("model") == "columns":
        y = _gather_counted(y, -1, "model")
    return y
