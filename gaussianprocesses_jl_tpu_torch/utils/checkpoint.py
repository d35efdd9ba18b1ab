"""Checkpoint and resume for long sampling runs (counterpart of
`gaussianprocesses_jl_tpu/utils/checkpoint.py`).

A state is a nested dict, list or tuple of tensors and Python scalars (the
port's analog of a pytree; None is a node without leaves). It goes to one
.npz file: its leaves in flattening order, a string of its structure and a
format version. `load_checkpoint` checks all three against a `like` state,
so that a checkpoint written by another configuration with the same number
of leaves never resumes into the wrong leaves. The write is atomic: a temp
file, then `os.replace`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

_FORMAT_VERSION = 2
_SCALARS = (bool, int, float)


def _flatten(state, leaves: list) -> str:
    """Append `state`'s leaves to `leaves` in order; return its structure.
    Dict keys are taken in sorted order, as JAX's flattening does."""
    if isinstance(state, dict):
        keys = sorted(state)
        return "{" + ",".join(f"{k!r}:{_flatten(state[k], leaves)}" for k in keys) + "}"
    if isinstance(state, (list, tuple)):
        inner = ",".join(_flatten(s, leaves) for s in state)
        return f"[{inner}]" if isinstance(state, list) else f"({inner})"
    if state is None:
        return "None"
    if isinstance(state, torch.Tensor) or isinstance(state, _SCALARS):
        leaves.append(state)
        return "*"
    raise TypeError(f"a checkpoint holds tensors and Python scalars, not {type(state).__name__}")


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken, in order, from the iterator."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(s, leaves) for s in like)
    if like is None:
        return None
    return next(leaves)


def _encode_str(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def save_checkpoint(path: str, state) -> None:
    """Write `state` to `path` (.npz), through a temp file and os.replace."""
    leaves = []
    structure = _flatten(state, leaves)
    arrays = {f"leaf_{i}": (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                            else np.asarray(leaf))
              for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = _encode_str(structure)
    arrays["__version__"] = np.asarray(_FORMAT_VERSION, dtype=np.int64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str, like):
    """The state saved at `path`, in `like`'s structure: each tensor leaf
    with its `like` leaf's dtype and device, each scalar leaf of its type.

    Raises ValueError when the stored structure, the leaf count or a leaf's
    shape differs from `like`'s."""
    like_leaves = []
    structure = _flatten(like, like_leaves)
    with np.load(path) as data:
        stored = data["__treedef__"].tobytes().decode() if "__treedef__" in data else None
        if stored is not None and stored != structure:
            raise ValueError(f"checkpoint {path} was written for another structure:\n"
                             f"  stored:   {stored}\n  expected: {structure}")
        n = len(like_leaves)
        out = []
        for i, ref in enumerate(like_leaves):
            key = f"leaf_{i}"
            if key not in data:
                raise ValueError(f"checkpoint {path} has {i} leaves, expected {n}")
            arr = data[key]
            shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint {path} leaf {i} has shape {arr.shape}, "
                                 f"expected {shape}")
            if isinstance(ref, torch.Tensor):
                out.append(torch.as_tensor(arr).to(dtype=ref.dtype, device=ref.device))
            else:
                out.append(type(ref)(arr.item()))
        if f"leaf_{n}" in data:
            raise ValueError(f"checkpoint {path} has more than the expected {n} leaves")
    return _unflatten(like, iter(out))
