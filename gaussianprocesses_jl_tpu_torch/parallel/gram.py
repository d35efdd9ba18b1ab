"""Ring-sharded gram construction (counterpart of
`gaussianprocesses_jl_tpu/parallel/gram.py`).

The observation axis is sharded over the mesh axis; each process holds its
(n/P, d) rows of X and builds its (n/P, n) block-row of K = k(X, X) by
passing X row blocks around the ring (`ppermute`): it only ever holds its
own block and one visitor, so X and K stay sharded. Each hop is one
(n/P) x (n/P) gram launch. Differentiable: the kernel's parameters enter
the shard-local grams through `copy`, and a visitor's gradient travels
back around the ring.
"""
from __future__ import annotations

import torch

from .collectives import copy_module, ppermute

__all__ = ["ring_gram"]


def ring_gram(kernel, X_loc: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This process's block-row (n/P, n) of K = k(X, X), from its own row
    block X_loc (n/P, d); blocks of rows are in axis order. The exchange is
    each X block sent P - 1 times around the ring (n d numbers), where an
    all-gather of K would move n^2 / P."""
    P_, me = mesh.shape[axis], mesh.coords[axis]
    kern = copy_module(kernel, mesh, axis)
    blocks = [None] * P_
    V = X_loc
    for s in range(P_):
        blocks[(me - s) % P_] = kern.gram(X_loc, V)  # V: the rows of (me - s) mod P
        if s + 1 < P_:
            V = ppermute(V, mesh, axis)
    return torch.cat(blocks, dim=1)
