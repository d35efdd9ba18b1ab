"""Gauss-Hermite quadrature (counterpart of
`gaussianprocesses_jl_tpu/utils/quadrature.py`).

Nodes and weights come once from numpy (physicists' convention, weight
e^{-x^2}) and become tensors in the caller's dtype and device, once for
each: a CUDA graph that takes the expectation (VI's step) copies nothing
from the host."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["gauss_hermite", "hermgauss_expectation"]


@lru_cache(maxsize=None)
def _hermgauss(n: int):
    return np.polynomial.hermite.hermgauss(n)


@lru_cache(maxsize=None)
def gauss_hermite(n: int = 20, dtype=torch.float64, device=None):
    """(nodes, weights) with the weights normalized by 1/sqrt(pi), so that
    E_{z~N(0,1)}[g(z)] ~= sum_i w_i g(sqrt(2) x_i). Kept for each (n,
    dtype, device): do not write into them."""
    x, w = _hermgauss(n)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(w / np.sqrt(np.pi), dtype=dtype, device=device))


def hermgauss_expectation(g, mu, var, n: int = 20):
    """E_{f ~ N(mu, var)}[g(f)] elementwise over (mu, var) tensors. g maps a
    tensor of f-values to a tensor of the same shape."""
    x, w = gauss_hermite(n, mu.dtype, mu.device)
    f = mu[..., None] + torch.sqrt(2.0 * var)[..., None] * x  # (..., n)
    return torch.sum(g(f) * w, dim=-1)
