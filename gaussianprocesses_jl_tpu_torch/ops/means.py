"""Mean functions (counterpart of `gaussianprocesses_jl_tpu/ops/means.py`).

`mean(X) -> (n,)` is vectorized over observations; gradients with respect
to the flat parameters come from autograd."""
from __future__ import annotations

import math
from typing import Any

import torch

from ..utils.modules import Module, module

__all__ = [
    "Mean",
    "MeanZero",
    "MeanConst",
    "MeanLin",
    "MeanPoly",
    "MeanPeriodic",
    "SumMean",
    "ProdMean",
]


class Mean(Module):
    def mean(self, X):
        """X: (n, d) -> (n,)"""
        raise NotImplementedError

    def __call__(self, X):
        return self.mean(X)

    def __add__(self, other):
        return SumMean(self, other)

    def __mul__(self, other):
        return ProdMean(self, other)

    def grad_stack(self, X):
        """(n, p) Jacobian of the mean vector at X with respect to the flat
        parameters (ref: src/means/means.jl grad_stack)."""

        def f(vec):
            return self.with_flat_params(vec).mean(X)

        return torch.func.jacfwd(f)(self.flat_params().detach())


@module(static=())
class MeanZero(Mean):
    """m(x) = 0."""

    def mean(self, X):
        return X.new_zeros(X.shape[0])


@module(static=("priors",))
class MeanConst(Mean):
    """m(x) = beta."""

    beta: Any
    priors: tuple = ()

    def mean(self, X):
        return self.beta.expand(X.shape[0])


@module(static=("priors",))
class MeanLin(Mean):
    """m(x) = x . beta."""

    beta: Any  # (d,)
    priors: tuple = ()

    def mean(self, X):
        return X @ self.beta


@module(static=("priors",))
class MeanPoly(Mean):
    """m(x) = sum_ij beta_ij x_i^j, with beta stored as (deg, d) so the
    C-order flat vector is the reference's column-major vec(β)."""

    beta: Any  # (deg, d)
    priors: tuple = ()

    def mean(self, X):
        deg = self.beta.shape[0]
        exps = torch.arange(1, deg + 1, dtype=X.dtype, device=X.device)
        powers = X[None, :, :] ** exps[:, None, None]  # (deg, n, d)
        return torch.einsum("jnd,jd->n", powers, self.beta)


@module(static=("priors",))
class MeanPeriodic(Mean):
    """m(x) = a'cos(2 pi x / p) + b'sin(2 pi x / p); params [a; b; lp]."""

    a: Any  # (d,)
    b: Any  # (d,)
    lp: Any  # (d,) log period
    priors: tuple = ()

    def mean(self, X):
        ang = 2.0 * math.pi * X * torch.exp(-self.lp)[None, :]
        return torch.cos(ang) @ self.a + torch.sin(ang) @ self.b


@module(static=())
class SumMean(Mean):
    """m1 + m2."""

    m1: Mean
    m2: Mean

    def mean(self, X):
        return self.m1.mean(X) + self.m2.mean(X)


@module(static=())
class ProdMean(Mean):
    """m1 * m2."""

    m1: Mean
    m2: Mean

    def mean(self, X):
        return self.m1.mean(X) * self.m2.mean(X)
