"""Deterministic, shardable, checkpointable synthetic data pipeline.

Every batch is a pure function of (seed, step, shard) via counter-based RNG,
so (a) any worker can regenerate any batch — restart-safe without data-state
checkpoints beyond the step counter, (b) elastic re-sharding is exact: a
host joining with a different shard count reproduces the same global batch.
Emits the modality-stub inputs (patch/frame embeddings) for vlm/audio archs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass
class PipelineState:
    step: int = 0

    def to_json(self):
        return {"step": self.step}

    @classmethod
    def from_json(cls, d):
        return cls(step=int(d["step"]))


class TokenPipeline:
    """Synthetic LM token stream with a Zipfian unigram mixture + structured
    n-gram correlations (so losses are non-trivial and decodes non-uniform)."""

    def __init__(self, cfg: ArchConfig, seq_len: int, global_batch: int,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1):
        assert global_batch % num_shards == 0, (global_batch, num_shards)
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.state = PipelineState()
        # fixed Zipf weights per vocab (derived from seed only)
        v = cfg.vocab_size
        rank = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / rank) / np.sum(1.0 / rank)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_index]))

    def batch_at(self, step: int) -> dict:
        rng = self._rng(step)
        B, S, cfg = self.local_batch, self.seq_len, self.cfg
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._probs)
        # inject local correlations: with p=0.3, copy the previous token + 1
        copy = rng.random((B, S)) < 0.3
        toks[:, 1:][copy] = (toks[:, :-1][copy] + 1) % cfg.vocab_size
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.modality == "vision" and cfg.n_prefix_embeds:
            batch["prefix_embeds"] = rng.standard_normal(
                (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
            batch["labels"][:, :cfg.n_prefix_embeds] = -1   # no loss on patches
        if cfg.enc_dec:
            batch["enc_frames"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        return batch

    def next_batch(self) -> dict:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    # -- checkpointing -----------------------------------------------------------
    def state_dict(self) -> dict:
        return self.state.to_json()

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState.from_json(d)

    # -- elastic re-sharding --------------------------------------------------------
    def reshard(self, shard_index: int, num_shards: int) -> "TokenPipeline":
        p = TokenPipeline(self.cfg, self.seq_len, self.global_batch, self.seed,
                          shard_index, num_shards)
        p.state = PipelineState(self.state.step)
        return p
