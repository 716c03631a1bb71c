"""Parameter / batch / cache sharding rules: pod-DP x FSDP(data) x TP(model),
the counterpart of ``repro.distributed.sharding`` as DTensor placements.

The rules are the JAX package's, name-based over the parameter tree:
  * model-parallel (TP) dims: attention head projections, MLP hidden, vocab,
    MoE experts (EP when the expert count divides the model axis);
  * FSDP: the remaining largest dim of every weight is sharded over "data"
    when divisible; parameters, gradients and AdamW moments are stored
    sharded and gathered on use;
  * the "pod" axis is pure data parallelism: parameters replicated across
    pods, gradients reduced over "pod", optionally in a compressed dtype
    (``collectives.reduce_gradients``).

A rule is a *spec*: one entry per tensor dim, a mesh-axis name, a tuple of
names, or ``None`` (the JAX package's ``PartitionSpec`` entries, as a
tuple).  ``placements(spec, mesh)`` turns it into DTensor placements.  Every
rule degrades gracefully: a dim that does not divide its axis stays
replicated.

The program places parameters through these rules (``distribute_params``).
``batch_shardings``, ``cache_shardings`` and ``replicated`` are the JAX
package's rules as specs only, kept for the dry run (ROADMAP item 12b): the
executed batch takes ``spmd.local_rows`` (the batch rule's layout), and the
executed cache the kernels' layout (``models.transformer._cache_specs``).
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map_with_path


class MeshView:
    """``axis_names`` and ``shape`` (a dict) of a DeviceMesh: the two
    attributes the rules read, as a JAX mesh has them."""

    def __init__(self, mesh):
        if hasattr(mesh, "axis_names"):          # already a view (or duck-typed)
            self.axis_names, self.shape = tuple(mesh.axis_names), dict(mesh.shape)
            return
        names = tuple(mesh.mesh_dim_names or ())
        self.axis_names = names
        self.shape = {a: mesh.size(i) for i, a in enumerate(names)}


def _axis_ok(mesh, axis: str, dim: int) -> bool:
    return axis in mesh.axis_names and dim % mesh.shape[axis] == 0


def _spec_for(path: str, shape: tuple, mesh, cfg: ArchConfig) -> tuple:
    """Assign (TP dim, FSDP dim) by parameter name; stacked layer dims lead."""
    ndim = len(shape)
    spec: list = [None] * ndim

    def put(idx: int, axis: str):
        # each mesh axis may shard at most one positional dim; out-of-range
        # dims (unusually-shaped params) stay replicated
        if not (0 <= idx < ndim):
            return
        if spec[idx] is None and axis not in spec and _axis_ok(mesh, axis, shape[idx]):
            spec[idx] = axis

    name = path.split("/")[-1]
    stacked = path.split("/")[0] in ("dec", "enc")      # leading n_periods dim

    if name in ("embed", "lm_head"):
        vocab_dim = 0 if name == "embed" else 1
        put(vocab_dim, "model")
        put(1 - vocab_dim, "data")
    elif name in ("wq", "wk", "wv", "c_wq", "c_wk", "c_wv"):
        put(ndim - 1, "model")                           # head-projection out dim
        put(ndim - 2, "data")
    elif name in ("wo", "c_wo"):
        put(ndim - 2, "model")                           # head dim contracts
        put(ndim - 1, "data")
    elif name in ("w_gate", "w_up"):
        if ndim >= 2 and cfg.moe is not None and len(shape) == 4:
            put(1, "model")                              # EP over experts
            put(3, "model")                              # else TP over d_ff
            put(2, "data")
        else:
            put(ndim - 1, "model")
            put(ndim - 2, "data")
    elif name == "w_down":
        if cfg.moe is not None and len(shape) == 4:
            put(1, "model")
            put(2, "model")
            put(3, "data")
        else:
            put(ndim - 2, "model")
            put(ndim - 1, "data")
    elif name == "router":
        put(ndim - 2, "data")
    elif name in ("in_proj", "out_proj"):
        put(ndim - 1, "model" if name == "in_proj" else "data")
        put(ndim - 2, "data" if name == "in_proj" else "model")
    elif ndim >= 2 and max(shape) >= 1024:
        put(int(max(range(ndim), key=lambda i: shape[i])), "data")
    # small tensors (norms, biases, conv, A_log, ...) stay replicated
    if stacked:
        spec[0] = None                                   # scan dim never sharded
    return tuple(spec)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: the mesh dimension named
    in tensor dim i gets ``Shard(i)``; a tuple of names in dim i shards that
    dim over each of them, major to minor, as the mesh orders them (so the
    tuple must list them in the mesh's order); every other mesh dimension
    gets ``Replicate()``."""
    names = MeshView(mesh).axis_names
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists mesh axes out of the mesh's "
                             f"order {names}")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh axis {names[j]!r} shards two dims in {spec}")
            out[j] = Shard(i)
    return tuple(out)


def _path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def param_shardings(params, mesh, cfg: ArchConfig):
    """Spec tree matching ``params``."""
    view = MeshView(mesh)
    return tree_map_with_path(
        lambda path, leaf: _spec_for(_path_str(path), tuple(leaf.shape), view, cfg), params)


def _prod(mesh: MeshView, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return max(n, 1)


def _dp(view: MeshView):
    """The data-parallel axes as a spec entry: a tuple, or a lone name as
    ``PartitionSpec`` writes a tuple of one."""
    dp = tuple(a for a in ("pod", "data") if a in view.axis_names)
    return dp[0] if len(dp) == 1 else dp


def _dp_size(view: MeshView, dp) -> int:
    return _prod(view, (dp,) if isinstance(dp, str) else dp)


def batch_shardings(batch, mesh):
    """Batch dim over (pod, data); everything else replicated."""
    view = MeshView(mesh)
    dp = _dp(view)

    def assign(leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim and leaf.shape[0] % _dp_size(view, dp) == 0:
            spec[0] = dp
        return tuple(spec)

    return tree_map_with_path(lambda _, leaf: assign(leaf), batch)


def cache_shardings(cache, mesh, cfg: ArchConfig):
    """The JAX package's KV-cache rule: shard the largest dim over (pod,data)
    (the batch dim for batched decode, the cache-length dim for long_500k
    at batch 1) and the largest remaining divisible dim over "model".

    Layout: (n_periods, B, Hkv, L, Dh) for k/v; mamba state (n_per, B, H, P, N).
    Dim 0 (the stack of periods) is never sharded.  The cache the models
    execute with is placed otherwise (``models.transformer``: batch over the
    data axes, KV heads over model): the decode kernel takes whole cache
    lengths and head dims (ROADMAP Queue 3)."""
    view = MeshView(mesh)
    dp = _dp(view)
    dpn = _dp_size(view, dp)
    mdl = view.shape.get("model", 1) if "model" in view.axis_names else 1

    def assign(leaf):
        if leaf.ndim <= 1:
            return ()
        spec = [None] * leaf.ndim
        cand = sorted(range(1, leaf.ndim), key=lambda i: -leaf.shape[i])
        for i in cand:
            if dp and leaf.shape[i] % dpn == 0:
                spec[i] = dp
                break
        for i in cand:
            if spec[i] is None and mdl > 1 and leaf.shape[i] % mdl == 0:
                spec[i] = "model"
                break
        return tuple(spec)

    return tree_map_with_path(
        lambda _, leaf: assign(leaf) if hasattr(leaf, "ndim") else (), cache)


def replicated(tree, mesh):
    return tree_map_with_path(lambda _, leaf: (), tree)


def distribute_params(params, mesh, cfg: ArchConfig, requires_grad=None):
    """``params`` (and equally AdamW moments, which share its paths) placed as
    DTensors by ``param_shardings``.  Every rank passes the same full
    tensors; each keeps its shard.  On a one-rank mesh each leaf is wrapped
    without a copy.  ``requires_grad`` None keeps each leaf's flag."""
    specs = param_shardings(params, mesh, cfg)
    one_rank = mesh.size() == 1

    def place(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        pl = placements(spec, mesh)
        rg = leaf.requires_grad if requires_grad is None else requires_grad
        t = leaf.detach()
        if one_rank:
            d = DTensor.from_local(t, mesh, pl, run_check=False)
        else:
            d = distribute_tensor(t, mesh, pl, src_data_rank=None)
        return d.requires_grad_(rg)

    return tree_map_with_path(place, params)
