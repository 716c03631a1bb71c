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
  length, as ``dot`` is counted from its shape and contracting dims.
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
  as ``dynamic-update-slice`` does; the ``*_like`` factories read nothing of
  their template, and ``empty`` / ``empty_like`` write nothing.
  Conversions (``_to_copy``), copies (``clone``), padding and the other
  factories move bytes and count no FLOPs, as ``convert``, ``copy``, ``pad``,
  ``broadcast`` and ``iota`` do.

One card runs no collective: ``collective_*`` are 0 and ``{}``.
"""
from __future__ import annotations

import torch
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
FREE = frozenset({"_unsafe_view"})              # a reshape of a fresh result
UNREAD_TEMPLATE = frozenset({"empty_like", "zeros_like", "ones_like",
                             "full_like", "rand_like", "randn_like"})
UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided"})

# H100 SXM5 NVLink 4: 900 GB/s per card (data sheet); one card moves nothing
# over it, so the term is 0 for every summary this module makes
NVLINK_BW = 900e9


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _Counter(TorchDispatchMode):
    """Accumulates the counts of every aten op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.ew_flops = 0.0
        self.bytes_accessed = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        inplace = name.endswith("_") and not name.startswith("_")
        base = name[:-1] if inplace else name
        operands = _tensors((args, kwargs))
        results = _tensors(out)
        if base in DOTS:
            self.dot_flops += 2.0 * results[0].numel() * args[0].shape[-1]
        elif base in ELEMENTWISE:
            self.ew_flops += sum(r.numel() for r in results)
        elif base in REDUCTIONS:
            self.ew_flops += operands[0].numel()
        self.bytes_accessed += self._bytes(func, base, inplace, operands, results)
        return out

    @staticmethod
    def _bytes(func, base, inplace, operands, results) -> int:
        if base in REGION_VIEWS:
            return 2 * sum(_nbytes(r) for r in results)
        if func.is_view or base in FREE:
            return 0
        read = [] if base in UNREAD_TEMPLATE else operands
        written = [] if (inplace or base in UNWRITTEN) else results
        return sum(_nbytes(t) for t in read) + sum(_nbytes(t) for t in written)


def trace_summary(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` traced on the meta device: the keys of
    ``HloAnalysis.summary()``.  Tensor arguments must be on ``meta``."""
    for t in _tensors((args, kwargs)):
        if t.device.type != "meta":
            raise ValueError(f"trace_summary runs on meta tensors; got one on {t.device}")
    counter = _Counter()
    with torch.no_grad(), counter:
        fn(*args, **kwargs)
    return {"flops": counter.dot_flops + counter.ew_flops,
            "dot_flops": counter.dot_flops, "ew_flops": counter.ew_flops,
            "bytes_accessed": counter.bytes_accessed,
            "collective_bytes": {}, "collective_count": {},
            "collective_total_bytes": 0}


def roofline_terms(summary: dict) -> dict:
    """The roofline's three terms in seconds for a :func:`trace_summary`, on
    the H100's bf16 tensor-core peak and HBM3 rate (``perfmodel_h100``)."""
    from repro_torch.core.perfmodel_h100 import HBM_BW, PEAK_FLOPS
    return {
        "compute": summary.get("flops", 0) / PEAK_FLOPS,
        "memory": summary.get("bytes_accessed", 0) / HBM_BW,
        "collective": summary.get("collective_total_bytes", 0) / NVLINK_BW,
    }
