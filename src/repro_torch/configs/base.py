"""Architecture configuration system.

Every assigned architecture is expressed as an ``ArchConfig``: a frozen,
hashable description of a transformer-family model built from a repeating
*pattern* of blocks.  ``n_layers`` must be a multiple of ``len(pattern)``;
the model stack scans over ``n_layers // len(pattern)`` periods with the
pattern unrolled inside the scan body (bounded HLO size at any depth).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block / pattern description
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Block:
    """One position in the repeating layer pattern."""

    kind: str = "attn"              # "attn" | "mamba"
    window: Optional[int] = None    # sliding-window size; None = full attention
    mlp: str = "gated_silu"         # "gated_silu"|"gated_gelu"|"squared_relu"|"relu"|"moe"|"none"
    cross_attn: bool = False        # decoder cross-attention (enc-dec only)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    conv_kernel: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class ArchConfig:
    name: str = "unnamed"
    family: str = "dense"           # dense | moe | hybrid | ssm | vlm | audio
    # -- dims ---------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    # -- pattern ------------------------------------------------------------
    pattern: Tuple[Block, ...] = (Block(),)
    # -- attention details ----------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0       # 0 = disabled (gemma2: 50)
    logit_softcap: float = 0.0      # 0 = disabled (gemma2: 30)
    # -- auxiliary subsystems -------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # -- encoder-decoder ------------------------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0           # encoder depth (enc-dec only)
    # -- modality frontend stub -----------------------------------------------
    modality: str = "text"          # text | vision | audio
    n_prefix_embeds: int = 0        # precomputed patch/frame embeddings spliced at seq start
    # -- norm / misc ----------------------------------------------------------
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-6
    post_norms: bool = False        # gemma2-style post-attn / post-mlp norms
    scale_embeddings: bool = False  # gemma-style sqrt(d_model) embedding scale
    tie_embeddings: bool = True
    # -- training -------------------------------------------------------------
    remat: bool = True              # activation checkpointing per layer-period

    # -- derived --------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )
        return self.n_layers // len(self.pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline MODEL_FLOPS."""
        D, H = self.d_model, self.head_dim
        n = self.vocab_size * D                                   # embed
        if not self.tie_embeddings:
            n += self.vocab_size * D
        per_pattern = 0
        for blk in self.pattern:
            if blk.kind == "attn":
                per_pattern += D * (self.n_heads * H) + 2 * D * (self.n_kv_heads * H)
                per_pattern += (self.n_heads * H) * D             # o_proj
                if blk.cross_attn:
                    per_pattern += D * (self.n_heads * H) + 2 * D * (self.n_kv_heads * H)
                    per_pattern += (self.n_heads * H) * D
            elif blk.kind == "mamba":
                s = self.ssm
                d_in = s.expand * D
                proj_in = 2 * d_in + 2 * s.n_groups * s.d_state + (d_in // s.head_dim)
                per_pattern += D * proj_in + d_in * D
                per_pattern += (d_in + 2 * s.n_groups * s.d_state) * s.conv_kernel
            if blk.mlp == "moe":
                m = self.moe
                per_pattern += m.n_experts * 3 * D * m.d_ff_expert
            elif blk.mlp in ("gated_silu", "gated_gelu"):
                per_pattern += 3 * D * self.d_ff
            elif blk.mlp in ("squared_relu", "relu"):
                per_pattern += 2 * D * self.d_ff
        n += per_pattern * self.n_periods
        if self.enc_dec:
            # encoder stack: full attn + same mlp kind as pattern[0]
            enc = D * (self.n_heads * H) * 2 + 2 * D * (self.n_kv_heads * H)
            enc += (2 if self.pattern[0].mlp in ("squared_relu", "relu") else 3) * D * self.d_ff
            n += enc * self.n_enc_layers
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        moe_positions = sum(1 for b in self.pattern if b.mlp == "moe")
        total_moe = moe_positions * self.n_periods * m.n_experts * 3 * self.d_model * m.d_ff_expert
        active_moe = total_moe * m.top_k // m.n_experts
        return full - total_moe + active_moe

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=len(self.pattern) * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 // max(1, self.q_per_kv)),
            d_head=16,
            d_ff=128,
            vocab_size=256,
            n_enc_layers=2 if self.enc_dec else 0,
            n_prefix_embeds=min(4, self.n_prefix_embeds),
            remat=False,
        )
        if self.moe is not None:
            # capacity_factor 4.0 => dropless at test scale, so the
            # prefill/decode teacher-forcing equivalence is exact (capacity
            # dropping legitimately breaks it at cf=1.25; see DESIGN.md)
            kw["moe"] = dataclasses.replace(self.moe, n_experts=4,
                                            top_k=min(2, self.moe.top_k),
                                            d_ff_expert=64, capacity_factor=4.0)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=32)
        if any(b.window for b in self.pattern):
            kw["pattern"] = tuple(
                dataclasses.replace(b, window=(16 if b.window else None)) for b in self.pattern
            )
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape cells (assigned shape set for LM-family transformers)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {c.name: c for c in SHAPE_CELLS}

# Archs eligible for the long_500k cell (sub-quadratic / windowed story).
LONG_CONTEXT_OK = frozenset({
    "mamba2-780m", "jamba-v0.1-52b", "gemma2-27b", "h2o-danube-3-4b", "mixtral-8x22b",
})


def cells_for(arch_name: str):
    for cell in SHAPE_CELLS:
        if cell.name == "long_500k" and arch_name not in LONG_CONTEXT_OK:
            continue
        yield cell
