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
The JAX package's batch and cache rules are not restated here: the executed
batch takes ``spmd.local_rows`` (the batch rule's layout), and the executed
cache ``models.transformer._cache_specs``, the kernels' layout: rows over
the data axes where they divide the batch, else (a batch of 1 at long
context) the attention cache's length over them where they divide it, as
``cache_shardings`` puts the largest dim there; on the head fallback the
length over "model" (``context.length_axes``).  The dry run traces the
same layout (``launch.specs``).
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.spmd import pod_partial
from repro_torch.tree import tree_map, tree_map_with_path


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


def train_state_shardings(params, mesh, cfg: ArchConfig, residual: bool = False) -> dict:
    """The placements of a train state saved as ``{"params", "opt_state":
    {"step", "mu", "nu"}, "residual"}`` (``residual`` only with it), for
    ``Checkpointer.restore(shardings=)``: the parameters and AdamW moments
    placed by ``param_shardings``, an ``int8_ef`` residual alike but
    ``Partial`` over "pod" (each pod's own, ``collectives.compress_init``),
    the AdamW step None (a plain tensor)."""
    names = MeshView(mesh).axis_names
    pl = tree_map(lambda spec: placements(spec, mesh), param_shardings(params, mesh, cfg))
    state = {"params": pl, "opt_state": {"step": None, "mu": pl, "nu": pl}}
    if residual:
        state["residual"] = tree_map(lambda p: pod_partial(p, names), pl)
    return state


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
