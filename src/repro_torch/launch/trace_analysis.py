"""Operation and byte counts of a PyTorch function traced on the meta device:
the port's counterpart of ``repro.launch.hlo_analysis`` (``HloAnalysis.summary``
and ``roofline_terms``), on the H100's constants.

:func:`trace_summary` runs ``fn`` on ``meta`` tensors under a
``TorchDispatchMode``: every aten op the function reaches is seen once, with
its operands and result, and nothing is allocated or executed.  PyTorch runs
eagerly, so a Python loop is traced once per trip: the counts are those of
the executed walk, as the HLO analyser's trip-count multipliers give them.

What counts as what (aten op names without overload; an in-place op counts
as its out-of-place name):

- **dot FLOPs**: ``mm`` and ``bmm``: 2·m·n·k, with k the contracted
  length, as ``dot`` is counted from its shape and contracting dims; in a
  :func:`trace_step`, also summed by site (:func:`_site`: the innermost
  frame of the models or the launch code, and the ``spmd`` chain that
  reached the product).
- **elementwise FLOPs**: one per output element of each op in
  :data:`ELEMENTWISE` (arithmetic, comparisons, logical ops, ``where``,
  ``exp``, ``tanh``, clamps: HLO's elementwise opcodes).
- **reduction FLOPs**: one per input element of each op in
  :data:`REDUCTIONS` (``amax``, ``sum``, ``any``, ...: HLO's ``reduce``).
- **bytes_accessed**: for every op, the bytes of its tensor operands plus
  those of its result.  Exceptions:
  views (``op.is_view``, and ``_unsafe_view``, which reshapes a fresh
  result) take none; ``slice`` and ``select`` cost their region read and
  written, twice the result's bytes, as ``dynamic-slice`` does; an in-place
  op (``copy_``, ``fill_``, ...) writes into its first operand, which is
  counted once, so ``copy_`` costs its source and its destination region,
  as ``dynamic-update-slice`` does; ``index_select`` and ``index_copy_``
  at one index (decode's cache slot, which stays on the device) cost their
  region read and written, as ``dynamic-slice`` and
  ``dynamic-update-slice`` do; the ``*_like`` factories read nothing of
  their template, and ``empty`` / ``empty_like`` write nothing.
  Conversions (``_to_copy``), copies (``clone``), padding and the other
  factories move bytes and count no FLOPs, as ``convert``, ``copy``, ``pad``,
  ``broadcast`` and ``iota`` do.

- **collectives**: the ``c10d`` ops of ``torch.distributed`` (a real or a
  fake process group), named as HLO names them (:data:`COLLECTIVES`).  A
  collective's bytes are those it logically moves, by ``HloAnalysis``'s
  rule: the gathered result of an all-gather, the unscattered input of a
  reduce-scatter, the operand of every other kind.  They are summed by
  kind, by mesh axis (the
  name of the group's mesh dimension) and by site, the innermost frame of
  ``repro_torch.models`` or ``repro_torch.launch`` at the call and the
  ``distributed.spmd`` functions that issued it (:func:`_site`).  As HLO's
  collective instructions do in ``HloAnalysis``, a collective adds no FLOPs
  and adds its operand and result bytes to ``bytes_accessed``.

With no mesh nothing calls a collective: ``collective_*`` are 0 and ``{}``.

:func:`trace_step` is the dry run's trace: it keeps autograd on (a train
step's backward is traced too), returns the function's result and its
counter, and follows the peak of the live bytes of every storage the
function creates (the counterpart of XLA's
``temp_size_in_bytes``; a weak reference per storage sees it freed).
"""
from __future__ import annotations

import os
import sys
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

DOTS = frozenset({"mm", "bmm"})
ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "exp", "expm1", "log", "log1p", "tanh", "sqrt", "rsqrt", "reciprocal",
    "pow", "sigmoid", "sign", "floor", "ceil", "round", "remainder", "fmod",
    "clamp", "clamp_min", "clamp_max", "where", "lt", "le", "gt", "ge", "eq",
    "ne", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "erf"})
REDUCTIONS = frozenset({"amax", "amin", "sum", "mean", "prod", "any", "all",
                        "max", "min", "logsumexp"})
REGION_VIEWS = frozenset({"slice", "select"})   # charged as dynamic-slice
# at one index: charged as dynamic-slice / dynamic-update-slice
DYNAMIC_SLICES = frozenset({"index_select", "index_copy"})
FREE = frozenset({"_unsafe_view"})              # a reshape of a fresh result
UNREAD_TEMPLATE = frozenset({"empty_like", "zeros_like", "ones_like",
                             "full_like", "rand_like", "randn_like"})
UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided"})

# c10d op (overload packet name) -> the collective's HLO name
COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-broadcast",
    "send": "collective-permute", "recv_": "collective-permute"}
# schema arguments that hold a collective's operands, and its results (an
# op with no result argument writes its operands in place)
_OPERAND_ARGS = ("tensors", "input_tensors", "input_tensor", "inputs", "input",
                 "input_list")
_RESULT_ARGS = ("output_tensors", "output_tensor", "outputs", "output",
                "output_lists")
_SITE_DIRS = tuple(os.path.join("repro_torch", d) + os.sep for d in ("models", "launch"))
_SPMD = os.path.join("repro_torch", "distributed", "spmd.py")

# H100 SXM5 NVLink 4: 900 GB/s per card (data sheet); one card moves nothing
# over it, so the term is 0 for every summary of one card
NVLINK_BW = 900e9


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of ``tree``; of a DTensor, this rank's local shard."""
    return [x._local_tensor if isinstance(x, DTensor) else x
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _Counter(TorchDispatchMode):
    """Accumulates the counts of every aten and c10d op dispatched under it.
    ``axes`` maps a process group's name to its mesh axis; ``memory``
    follows the live bytes of the storages the traced ops create;
    ``dot_sites`` sums the dot FLOPs by site."""

    def __init__(self, axes=None, memory: bool = False, dot_sites: bool = False):
        super().__init__()
        self.dot_flops = 0.0
        self.ew_flops = 0.0
        self.bytes_accessed = 0.0
        self.coll_bytes: dict = {}
        self.coll_count: dict = {}
        self.coll_axis_bytes: dict = {}
        self.coll_sites: dict = {}
        self.dot_sites: dict = {}
        self._dot_sites = dot_sites
        self._axes = axes or {}
        self._memory = memory
        self._live: dict = {}           # storage key -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace in ("c10d", "_c10d_functional"):
            if name not in COLLECTIVES:         # a functional collective, a barrier
                raise NotImplementedError(f"the trace has no count for {func}")
            self._collective(func, COLLECTIVES[name], args, kwargs)
            return out
        inplace = name.endswith("_") and not name.startswith("_")
        base = name[:-1] if inplace else name
        operands = _tensors((args, kwargs))
        results = _tensors(out)
        if base in DOTS:
            flops = 2.0 * results[0].numel() * operands[0].shape[-1]
            self.dot_flops += flops
            if self._dot_sites:
                site = _site()
                self.dot_sites[site] = self.dot_sites.get(site, 0.0) + flops
        elif base in ELEMENTWISE:
            self.ew_flops += sum(r.numel() for r in results)
        elif base in REDUCTIONS:
            self.ew_flops += operands[0].numel()
        self.bytes_accessed += self._bytes(func, base, inplace, operands, results)
        if self._memory and not (func.is_view or inplace):
            held = {t.untyped_storage()._cdata for t in operands}
            for r in results:
                self._track(r, held)
        return out

    @staticmethod
    def _bytes(func, base, inplace, operands, results) -> int:
        if base in REGION_VIEWS:
            return 2 * sum(_nbytes(r) for r in results)
        if func.is_view or base in FREE:
            return 0
        if base in DYNAMIC_SLICES and operands[1].numel() == 1:   # the index
            return 2 * _nbytes(results[0] if base == "index_select" else operands[2])
        read = [] if base in UNREAD_TEMPLATE else operands
        written = [] if (inplace or base in UNWRITTEN) else results
        return sum(_nbytes(t) for t in read) + sum(_nbytes(t) for t in written)

    def _collective(self, func, kind: str, args, kwargs) -> None:
        bound = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
        operand = sum(_nbytes(t) for n in _OPERAND_ARGS for t in _tensors(bound.get(n)))
        result = sum(_nbytes(t) for n in _RESULT_ARGS for t in _tensors(bound.get(n)))
        group = dist.ProcessGroup.unbox(bound["process_group"]).group_name
        self.bytes_accessed += operand + (result or operand)
        moved = result if kind == "all-gather" else operand
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + moved
        self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
        axis = self._axes.get(group, f"group {group}")
        self.coll_axis_bytes[axis] = self.coll_axis_bytes.get(axis, 0) + moved
        site = _site()
        self.coll_sites[site] = self.coll_sites.get(site, 0) + moved

    def _track(self, t: torch.Tensor, held) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live or key in held:
            return
        self._live[key] = n = storage.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key)

    def summary(self) -> dict:
        """The keys of ``HloAnalysis.summary()``."""
        return {"flops": self.dot_flops + self.ew_flops,
                "dot_flops": self.dot_flops, "ew_flops": self.ew_flops,
                "bytes_accessed": self.bytes_accessed,
                "collective_bytes": dict(self.coll_bytes),
                "collective_count": dict(self.coll_count),
                "collective_total_bytes": sum(self.coll_bytes.values())}

    def top_collective_sites(self, n: int = 8) -> list:
        return sorted(self.coll_sites.items(), key=lambda kv: -kv[1])[:n]

    def top_dot_sites(self, n: int = 8) -> list:
        return sorted(self.dot_sites.items(), key=lambda kv: -kv[1])[:n]


def _site() -> str:
    """``file:line function [chain]`` of the innermost frame of the models or
    the launch code on the stack (this module's own frames excluded); the
    chain names the public ``distributed.spmd`` functions between it and
    the collective or product, outermost first: ``dot>use>gather`` is a weight gathered
    for a product, ``dot>gather`` the activations of a product taken on the
    weight's shard."""
    f = sys._getframe(2)
    chain = []
    while f is not None:
        path, name = f.f_code.co_filename, f.f_code.co_name
        if path.endswith(_SPMD) and not name.startswith("_") \
                and name not in ("forward", "backward"):
            chain.append(name)
        for d in _SITE_DIRS:
            i = path.rfind(d)
            if i >= 0 and not path.endswith("trace_analysis.py"):
                via = f" [{'>'.join(reversed(chain))}]" if chain else ""
                return f"{path[i:]}:{f.f_lineno} {name}{via}"
        f = f.f_back
    return "?"


def _mesh_axes() -> dict:
    """{process group name: mesh axis} of the active mesh, and "world" for
    the default group (int8 compression's shared scale)."""
    from repro_torch.distributed import context as ctx
    mesh = ctx.get_mesh()
    if mesh is None:
        return {}
    axes = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    axes.setdefault(dist.group.WORLD.group_name, "world")
    return axes


def _check_meta(args, kwargs, host_scalars: bool = False) -> None:
    """Every tensor argument on ``meta`` (with ``host_scalars``, 0-d CPU
    tensors too, as AdamW's step counter)."""
    for t in _tensors((args, kwargs)):
        if t.device.type != "meta" and not (host_scalars and t.device.type == "cpu"
                                            and t.dim() == 0):
            raise ValueError(f"the trace runs on meta tensors; got one on {t.device}")


def trace_summary(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` traced on the meta device without autograd:
    the keys of ``HloAnalysis.summary()``.  Tensor arguments must be on
    ``meta``."""
    _check_meta(args, kwargs)
    counter = _Counter(_mesh_axes())
    with torch.no_grad(), counter:
        fn(*args, **kwargs)
    return counter.summary()


def trace_step(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` traced on the meta device with autograd as
    the caller left it, under the active mesh; returns ``(result,
    counter)``.  The counter's ``peak_bytes`` is the peak of the live bytes
    of the storages ``fn`` created, ``dot_sites`` its dot FLOPs by site.
    Tensor arguments must be on ``meta``, but for 0-d CPU tensors."""
    _check_meta(args, kwargs, host_scalars=True)
    counter = _Counter(_mesh_axes(), memory=True, dot_sites=True)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


def roofline_terms(summary: dict) -> dict:
    """The roofline's three terms in seconds for a :func:`trace_summary`, on
    the H100's bf16 tensor-core peak and HBM3 rate (``perfmodel_h100``)."""
    from repro_torch.core.perfmodel_h100 import HBM_BW, PEAK_FLOPS
    return {
        "compute": summary.get("flops", 0) / PEAK_FLOPS,
        "memory": summary.get("bytes_accessed", 0) / HBM_BW,
        "collective": summary.get("collective_total_bytes", 0) / NVLINK_BW,
    }
