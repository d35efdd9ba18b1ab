"""Pairwise distances (counterpart of `gaussianprocesses_jl_tpu/ops/distance.py`).

Squared Euclidean distances are the exact broadcast difference for small
problems and the ||x||^2 + ||y||^2 - 2 x.y expansion (one matmul) above
`_EXACT_BROADCAST_BUDGET`, clamped at 0, with exact zeros on a symmetric
diagonal. ARD distances come from rescaling the inputs before this call.
"""
from __future__ import annotations

import torch

__all__ = ["sqdist", "safe_dist", "cross_dot"]

# below this many pairwise cells x dims, the exact O(n^2 d) broadcast
# difference is cheap and numerically preferable
_EXACT_BROADCAST_BUDGET = 4_000_000


def sqdist(X1: torch.Tensor, X2: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise squared Euclidean distances.

    X1: (n1, d), X2: (n2, d) or None for the symmetric case.
    Returns (n1, n2), non-negative.
    """
    sym = X2 is None
    if sym:
        X2 = X1
    n1, d = X1.shape
    n2 = X2.shape[0]
    if n1 * n2 * max(d, 1) <= _EXACT_BROADCAST_BUDGET:
        diff = X1[:, None, :] - X2[None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
    else:
        s1 = torch.sum(X1 * X1, dim=1)
        s2 = s1 if sym else torch.sum(X2 * X2, dim=1)
        d2 = s1[:, None] + s2[None, :] - 2.0 * cross_dot(X1, X2)
        d2 = torch.maximum(d2, torch.zeros_like(d2))
    if sym:
        # exact zeros on the diagonal regardless of rounding
        eye = torch.eye(n1, dtype=torch.bool, device=X1.device)
        d2 = torch.where(eye, torch.zeros_like(d2), d2)
    return d2


def safe_dist(d2: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """sqrt of a squared distance with a NaN-free gradient at zero: the
    double `where` pins both the value and the gradient to 0 there."""
    pos = d2 > eps
    safe = torch.where(pos, d2, torch.ones_like(d2))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(d2))


def cross_dot(X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """X1 @ X2.T in the inputs' precision (TF32 stays off)."""
    return X1 @ X2.T
