"""Carry parameters across from the JAX package.

`load_flat(obj, vec, names)` takes a flat parameter vector as the JAX
package's `flat_params()` gives it (as a numpy array), and optionally its
`param_names()`, and returns `obj` with those values, on `obj`'s device and
in its dtype. Both packages keep the same flat order and names, so this is
how one model is made to compute the same thing in both.

`load_chains(obj, states, names)` carries a (C, D) array of chain states
(the JAX package's vmapped samplers give one flat vector a row) into a
(C, D) tensor on `obj`'s device and in its dtype, after the same checks: the
starting points or draws of a batch of chains.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_flat", "load_chains"]


def _checked(obj, arr, names, ndim):
    arr = np.asarray(arr)
    if arr.ndim != ndim or arr.shape[-1] != obj.n_params:
        raise ValueError(
            f"{type(obj).__name__} has {obj.n_params} parameters, "
            f"got an array of shape {arr.shape}")
    if names is not None and list(names) != obj.param_names():
        raise ValueError(
            f"parameter names differ: got {list(names)}, "
            f"expected {obj.param_names()}")
    return torch.as_tensor(arr, dtype=obj.dtype).to(obj.device)


def load_flat(obj, vec, names=None):
    """`obj.with_flat_params(vec)` after checking the count and the names."""
    return obj.with_flat_params(_checked(obj, vec, names, 1))


def load_chains(obj, states, names=None):
    """The (C, D) chain states `states` as a tensor on `obj`'s device and in
    its dtype, after checking that D is obj's parameter count and the names;
    row c is chain c's flat vector in obj's order."""
    return _checked(obj, states, names, 2)
