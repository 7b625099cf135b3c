"""Flat-key npz checkpoints of trees of tensors, with step retention — the
port of ``repro.checkpoint.io``, in the same file format.

``save(dir, step, tree)`` writes ``step_<8 digits>.npz`` with one array
per leaf under its '/'-joined path (dict keys in sorted order, list and
tuple positions; a ``Model.params()`` dict's keys are its names), and an
optional ``__meta__`` entry holding JSON as uint8 bytes, atomically (a
temporary file, then a rename), keeping the newest ``keep`` steps.
``restore(dir, like)`` loads the latest (or a given) step into the
structure of ``like``, checking every leaf's shape and casting to its
dtype, on its device. A file either package writes loads with the other's
``load`` to the same flat arrays and meta.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch


def _items(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in the
    reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, meta: dict | None = None,
         keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {k: _numpy(v) for k, v in _items(tree)}
    if meta is not None:
        flat["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    for s in sorted(all_steps(ckpt_dir))[:-keep]:
        os.remove(os.path.join(ckpt_dir, f"step_{s:08d}.npz"))
    return path


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(f[5:-4]) for f in os.listdir(ckpt_dir)
            if f.startswith("step_") and f.endswith(".npz")]


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def load(ckpt_dir: str, step: int) -> tuple[dict[str, np.ndarray], dict]:
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}.npz")) as z:
        flat = {k: z[k] for k in z.files}
    meta = {}
    if "__meta__" in flat:
        meta = json.loads(flat.pop("__meta__").tobytes().decode())
    return flat, meta


def _rebuild(like, flat: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    if like is None:
        return None
    key = prefix[:-1]
    arr = flat[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(
            f"{key}: checkpoint shape {tuple(arr.shape)} != "
            f"{tuple(like.shape)}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=like.device, dtype=like.dtype)
    return arr.astype(np.asarray(like).dtype)


def restore(ckpt_dir: str, like, step: int | None = None
            ) -> tuple[Any, dict, int]:
    """Load the latest (or the given) step into the structure of ``like``:
    (tree, meta, step). Raises ``FileNotFoundError`` without a checkpoint
    and ``ValueError`` on a missing key or a leaf of another shape."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    flat, meta = load(ckpt_dir, step)
    missing = {k for k, _ in _items(like)} - set(flat)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}…")
    return _rebuild(like, flat), meta, step
