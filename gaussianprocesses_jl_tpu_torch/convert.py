"""Carry parameters across from the JAX package.

`load_flat(obj, vec, names)` takes a flat parameter vector as the JAX
package's `flat_params()` gives it (as a numpy array), and optionally its
`param_names()`, and returns `obj` with those values, on `obj`'s device and
in its dtype. Both packages keep the same flat order and names, so this is
how one model is made to compute the same thing in both.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_flat"]


def load_flat(obj, vec, names=None):
    """`obj.with_flat_params(vec)` after checking the count and the names."""
    vec = np.asarray(vec)
    if vec.ndim != 1 or vec.shape[0] != obj.n_params:
        raise ValueError(
            f"{type(obj).__name__} has {obj.n_params} parameters, "
            f"got a vector of shape {vec.shape}")
    if names is not None and list(names) != obj.param_names():
        raise ValueError(
            f"parameter names differ: got {list(names)}, "
            f"expected {obj.param_names()}")
    t = torch.as_tensor(vec, dtype=obj.dtype).to(obj.device)
    return obj.with_flat_params(t)
