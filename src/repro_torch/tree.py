"""Nested dicts of tensors, walked in the order ``jax.tree_util`` walks a
dict (sorted keys): the parameter, gradient and optimizer-moment trees of
the training path."""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of ``rest``, which
    share its structure; returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, ``path`` the tuple of
    keys from the root; returns a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    return fn(path, tree)


def zeros_like(t, dtype=None):
    """``torch.zeros_like``; a DTensor's zeros are built from its local
    shard, placed alike (no sharding propagation)."""
    if isinstance(t, DTensor):
        return DTensor.from_local(torch.zeros_like(t.to_local(), dtype=dtype), t.device_mesh,
                                  t.placements, run_check=False)
    return torch.zeros_like(t, dtype=dtype)
