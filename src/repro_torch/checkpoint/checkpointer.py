"""Atomic, resumable checkpointing: the counterpart of
``repro.checkpoint.checkpointer``, with the same on-disk format.

  * arrays are saved in logical layout, one ``arrays.npz`` per tree (keys
    are the tree paths joined with ``\\x1f``), beside a JSON manifest
    carrying step, extra state (the pipeline's) and the npz's sha256;
  * writes are atomic: temp dir -> fsync -> rename; a crash mid-save leaves
    the previous checkpoint intact;
  * keeps the newest ``keep`` checkpoints, deletes older ones.

So a checkpoint written by either package restores in the other with
identical arrays.  Tensor leaves are saved from ``t.detach().cpu().numpy()``;
a bf16 leaf raises ``ValueError`` (numpy has no bf16, and the training state
is fp32).

Under a process group ``save`` is a collective: every rank calls it with
the same tree.  A DTensor leaf is gathered whole (``full_tensor()``, which
sums a ``Partial`` placement), one leaf at a time in the tree's sorted
order, and moved to the host before the next: the device holds one whole
leaf at most.  Global rank 0 alone writes, publishes and deletes; every
rank returns once rank 0 has published (a broadcast of its outcome, which
a failure on rank 0 raises on every rank), with the same path.  The
directory must be one that every rank sees.

``restore(step, shardings=, device=)`` is the JAX package's
``restore(step, shardings)``: with ``shardings`` (``place``), each leaf
becomes a DTensor on the active mesh, placed as the matching entry says,
or stays a plain tensor where the entry is None.  Every rank reads the
whole file, checks its hash (read in blocks), cuts its own shard on the
host with no communication and moves only that shard to the device; a
``Partial`` entry puts the saved array on the ranks at index 0 of that
mesh axis and zeros on the others, so the sum over the axis is the saved
value.  The arrays are logical, so a checkpoint restores onto any mesh:
the one it was saved from or another (the elastic re-mesh path).
DTensors land on the mesh's device type, plain leaves on ``device`` (the
CPU when None).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Placement
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.distributed import context as ctx


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaves(tree, prefix="") -> dict:
    """{path: leaf} in the order ``jax.tree_util`` walks the tree."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict) and node and all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _placement_leaves(tree, prefix="") -> dict:
    """{path: entry} of a shardings tree: an entry is a tuple of DTensor
    placements or None; dicts and other tuples are walked as ``_leaves``
    walks the state."""
    if isinstance(tree, (list, tuple)) and tree and all(isinstance(p, Placement)
                                                       for p in tree):
        return {prefix[:-1]: tuple(tree)}
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {prefix[:-1]: None}
    else:
        raise TypeError(f"shardings entry {prefix[:-1]!r} is {tree!r}: a tuple of "
                        f"placements or None")
    out = {}
    for k, v in items:
        out.update(_placement_leaves(v, f"{prefix}{k}/"))
    return out


def _shard(t: torch.Tensor, mesh, pl: tuple) -> DTensor:
    """This rank's shard of the whole host array ``t``, placed ``pl`` on
    ``mesh``: cut on the host with no communication, and only the shard
    moved to the mesh's device."""
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    if any(isinstance(p, Partial) and mesh.get_local_rank(i) != 0
           for i, p in enumerate(pl)):              # the sum over the axis is the array
        local = torch.zeros(shape, dtype=t.dtype, device=mesh.device_type)
    else:                                           # a copy: a view would keep the whole
        local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        local = local.to(mesh.device_type, copy=mesh.size() > 1).contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                              stride=t.stride())


def _placed(flat: dict, shardings, device) -> dict:
    mesh = ctx.get_mesh()
    if mesh is None:
        raise RuntimeError("shardings place leaves on the active mesh, and none is set "
                           "(distributed.context.set_mesh)")
    entries = _placement_leaves(shardings)
    unmatched = sorted(set(flat) ^ set(entries))
    if unmatched:
        key = unmatched[0]
        side = "the checkpoint" if key in flat else "shardings"
        raise ValueError(f"shardings do not match the checkpoint: {key!r} is only in {side}")
    out = {}
    for key, t in flat.items():
        pl = entries[key]
        if pl is None:
            out[key] = t if device is None else t.to(device)
        elif len(pl) != mesh.ndim:
            raise ValueError(f"shardings entry {key!r} has {len(pl)} placements for a "
                             f"mesh of {mesh.ndim} dims")
        else:
            out[key] = _shard(t, mesh, pl)
    return out


def place(state, shardings, device=None):
    """``state`` (whole tensors, as ``restore`` returns them) placed by
    ``shardings``, a tree shaped like it: each leaf a DTensor on the active
    mesh where its entry is a tuple of placements, a tensor on ``device``
    (the CPU when None) where it is None.  A ``ResilientRunner``'s
    ``load_state_fn`` places the tree it is handed so."""
    return _unflatten(_placed(_leaves(state), shardings, device))


def _digest(path: str) -> str:
    """sha256 of the file, read in blocks (the reference hashes it whole)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _collective() -> bool:
    return dist.is_available() and dist.is_initialized()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: dict, extra: Optional[dict] = None) -> str:
        leaves = _leaves(state)
        for key, leaf in leaves.items():
            if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
                raise ValueError(f"checkpoint leaf {key!r} is bf16, which numpy cannot "
                                 "hold; the training state is fp32")
        collective = _collective()
        writer = not collective or dist.get_rank() == 0
        flat = {}
        for key, leaf in leaves.items():
            if isinstance(leaf, DTensor):
                leaf = leaf.detach().full_tensor()       # a collective: every rank
            if writer:
                flat[key] = _array(leaf)
        final = os.path.join(self.directory, f"step_{step:010d}")
        error = None
        if writer:
            try:
                self._write(final, step, flat, extra)
            except Exception as e:
                if not collective:
                    raise
                error = f"{type(e).__name__}: {e}"
        if collective:
            outcome = [error]
            dist.broadcast_object_list(outcome, src=0)   # every rank waits for rank 0
            if outcome[0] is not None:
                raise IOError(f"checkpoint step {step}: rank 0 failed to save: "
                              f"{outcome[0]}")
        return final

    def _write(self, final: str, step: int, flat: dict, extra: Optional[dict]) -> None:
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_save_")
        try:
            arr_path = os.path.join(tmp, "arrays.npz")
            np.savez(arr_path, **{k.replace("/", "\x1f"): v for k, v in flat.items()})
            manifest = {
                "step": step,
                "sha256": _digest(arr_path),
                "keys": sorted(flat),
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)                       # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- load ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, shardings=None, device=None
                ) -> tuple[int, dict, dict]:
        """Returns (step, state, extra).  Verifies the content hash.  Without
        ``shardings`` every array is a tensor on ``device`` (the CPU when
        None); with it, ``place(state, shardings, device)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arr_path = os.path.join(d, "arrays.npz")
        if _digest(arr_path) != manifest["sha256"]:
            raise IOError(f"checkpoint {d} corrupt: hash mismatch")
        with np.load(arr_path) as npz:
            flat = {k.replace("\x1f", "/"): torch.from_numpy(npz[k]) for k in npz.files}
        if shardings is not None:
            flat = _placed(flat, shardings, device)
        elif device is not None:
            flat = {k: t.to(device) for k, t in flat.items()}
        return step, _unflatten(flat), manifest.get("extra", {})
