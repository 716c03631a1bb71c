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
is fp32).  ``restore(step, device)`` returns tensors on ``device`` (the CPU
by default) where the JAX package takes ``shardings``.
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


def _array(leaf, key: str) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(f"checkpoint leaf {key!r} is bf16, which numpy cannot "
                             "hold; the training state is fp32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _array(tree, prefix[:-1])
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


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: dict, extra: Optional[dict] = None) -> str:
        flat = _flatten(state)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_save_")
        try:
            arr_path = os.path.join(tmp, "arrays.npz")
            np.savez(arr_path, **{k.replace("/", "\x1f"): v for k, v in flat.items()})
            with open(arr_path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest = {
                "step": step,
                "sha256": digest,
                "keys": sorted(flat),
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.directory, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)                       # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

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

    def restore(self, step: Optional[int] = None, device=None
                ) -> tuple[int, dict, dict]:
        """Returns (step, state, extra), every array a tensor on ``device``
        (the CPU when None).  Verifies the content hash."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arr_path = os.path.join(d, "arrays.npz")
        with open(arr_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != manifest["sha256"]:
            raise IOError(f"checkpoint {d} corrupt: hash mismatch")
        with np.load(arr_path) as npz:
            flat = {k.replace("\x1f", "/"): torch.from_numpy(npz[k]) for k in npz.files}
        if device is not None:
            flat = {k: t.to(device) for k, t in flat.items()}
        return step, _unflatten(flat), manifest.get("extra", {})
