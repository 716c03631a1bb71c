"""KernelGenome — the candidate representation ``x`` of the AVO search.

In the paper each candidate is CUDA source with inline PTX; on TPU the
equivalent degrees of freedom are the structural choices of the Pallas kernel
(see kernels/flash_attention.py).  A genome deterministically materializes
into a concrete ``pl.pallas_call``, so the search space is exactly the space
of compilable kernels — not free-form text.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from dataclasses import dataclass
from typing import Iterator

BLOCK_Q_CHOICES = (64, 128, 256, 512, 1024, 2048)
BLOCK_K_CHOICES = (128, 256, 512, 1024, 2048)
RESCALE_MODES = ("branchless", "branched")
MASK_MODES = ("dense", "block_skip")
DIV_MODES = ("deferred", "eager")
ACC_DTYPES = ("f32", "bf16")   # bf16 halves accumulator VMEM — and fails
                               # the correctness gate (see tests): the axis
                               # exists to exercise f's zero-on-incorrect


@dataclass(frozen=True)
class KernelGenome:
    block_q: int = 128
    block_k: int = 128
    rescale_mode: str = "branched"
    mask_mode: str = "dense"
    div_mode: str = "eager"
    kv_in_grid: bool = False
    gqa_pack: bool = False
    acc_dtype: str = "f32"

    # -- materialization -----------------------------------------------------
    def kernel_kwargs(self) -> dict:
        return dataclasses.asdict(self)

    # -- identity / persistence ----------------------------------------------
    def key(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelGenome":
        return cls(**d)

    # -- wire encoding ---------------------------------------------------------
    def to_edits(self) -> tuple:
        """Seed-relative edit list: ``(field_index, value)`` pairs for every
        field that differs from the seed genome (the class defaults).  A
        genome IS a deterministic edit list over the seed, so this is the
        complete identity in a fraction of a full pickle — the evaluation
        backends ship these across process/host boundaries and workers
        rebuild with :meth:`from_edits` (bit-identical round trip)."""
        return tuple((i, getattr(self, name))
                     for i, (name, default) in enumerate(_GENOME_DEFAULTS)
                     if getattr(self, name) != default)

    @classmethod
    def from_edits(cls, edits) -> "KernelGenome":
        """Inverse of :meth:`to_edits`: apply the edit list to the seed."""
        return cls(**{_GENOME_DEFAULTS[i][0]: v for i, v in edits})

    def diff(self, other: "KernelGenome") -> dict:
        """Field-level diff (the agent's 'what changed between versions')."""
        a, b = dataclasses.asdict(self), dataclasses.asdict(other)
        return {k: (a[k], b[k]) for k in a if a[k] != b[k]}

    # -- edit operators --------------------------------------------------------
    def with_(self, **kw) -> "KernelGenome":
        return dataclasses.replace(self, **kw)

    def neighbors(self) -> Iterator["KernelGenome"]:
        """Single-field edits (the agent composes multi-field edits itself)."""
        for bq in BLOCK_Q_CHOICES:
            if bq != self.block_q:
                yield self.with_(block_q=bq)
        for bk in BLOCK_K_CHOICES:
            if bk != self.block_k:
                yield self.with_(block_k=bk)
        for rm in RESCALE_MODES:
            if rm != self.rescale_mode:
                yield self.with_(rescale_mode=rm)
        for mm in MASK_MODES:
            if mm != self.mask_mode:
                yield self.with_(mask_mode=mm)
        for dm in DIV_MODES:
            if dm != self.div_mode:
                yield self.with_(div_mode=dm)
        yield self.with_(kv_in_grid=not self.kv_in_grid)
        yield self.with_(gqa_pack=not self.gqa_pack)
        for ad in ACC_DTYPES:
            if ad != self.acc_dtype:
                yield self.with_(acc_dtype=ad)


# field order is part of the wire format: to_edits/from_edits index into it
_GENOME_DEFAULTS = tuple((f.name, f.default)
                         for f in dataclasses.fields(KernelGenome))


def genome_columns(genomes) -> dict:
    """Struct-of-arrays decomposition over the ``_GENOME_DEFAULTS`` field
    table: one column (list) per genome field, in wire-format field order.
    The columnar scoring path (``perfmodel.estimate_batch``) consumes this."""
    genomes = list(genomes)
    return {name: [getattr(g, name) for g in genomes]
            for name, _ in _GENOME_DEFAULTS}


def seed_genome() -> KernelGenome:
    """x0 — the 'naive but correct' starting kernel of the evolution
    (Fig. 5's version 1): small square blocks, serial un-pipelined K loop,
    branched rescaling, eager normalization, dense masking."""
    return KernelGenome()


def full_space() -> Iterator[KernelGenome]:
    for bq, bk, rm, mm, dm, kg, gp, ad in itertools.product(
            BLOCK_Q_CHOICES, BLOCK_K_CHOICES, RESCALE_MODES, MASK_MODES,
            DIV_MODES, (False, True), (False, True), ACC_DTYPES):
        yield KernelGenome(bq, bk, rm, mm, dm, kg, gp, ad)
