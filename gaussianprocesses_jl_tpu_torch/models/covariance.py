"""Covariance strategies (counterpart of `gaussianprocesses_jl_tpu/models/covariance.py`).

A GP model holds a covariance strategy and all likelihood and prediction
code is generic over it:

  build(kernel, noise_var, X) -> PD        factorized train covariance
  quad_logdet(kernel, noise_var, X, r)     fused (r^T K^-1 r, logdet, ok)
  predict_mvn(pd, kernel, X, r, alpha, Xs, full_cov, blockindpred=None)
      -> (mu_cross, cov/var)

`FullCovariance` is the dense exact strategy.
"""
from __future__ import annotations

from typing import Any

import torch

from ..ops.linalg import (
    add_diag,
    chol_logdet,
    chol_solve,
    dense_quad_logdet,
    safe_cholesky,
    solve_lower,
)
from ..utils.modules import Module, module

__all__ = ["DensePD", "FullCovariance"]


@module(static=())
class DensePD(Module):
    """Dense PD matrix held as its lower Cholesky factor. `ok` flags
    factorization success; on failure the factor is the identity and
    downstream targets must be rejected."""

    L: Any  # (n, n) lower triangular
    ok: Any  # () bool

    def solve(self, B):
        return chol_solve(self.L, B)

    def whiten(self, B):
        """L^-1 B."""
        return solve_lower(self.L, B)

    def unwhiten(self, v):
        """L v: maps whitened latents to f-space."""
        return self.L @ v

    def logdet(self):
        return chol_logdet(self.L)

    def quad(self, y):
        """y^T K^-1 y via the whitened vector."""
        w = solve_lower(self.L, y)
        return torch.sum(w * w)


@module(static=())
class FullCovariance(Module):
    """Exact dense covariance strategy."""

    # the built PD exposes unwhiten(), so GPA's whitened-latent
    # parameterization (f = mu + L v) is available
    supports_whitened_latents = True

    def build(self, kernel, noise_var, X) -> DensePD:
        """K(X, X) + diag(noise_var); noise_var scalar or (n,) vector
        (heteroscedastic)."""
        L, ok = safe_cholesky(add_diag(kernel.gram(X), noise_var))
        return DensePD(L=L, ok=ok)

    def quad_logdet(self, kernel, noise_var, X, r):
        """Fused (r^T K^-1 r, logdet K, ok) for the mll hot path, with the
        explicit-inverse backward of ops.linalg.dense_quad_logdet."""
        K = add_diag(kernel.gram(X), noise_var)
        return dense_quad_logdet(K, r)

    def predict_mvn(self, pd: DensePD, kernel, X, r, alpha, Xs, full_cov: bool,
                    blockindpred=None):
        """Batched posterior MVN at test points: (K(Xs,X) alpha, cov or var);
        the caller adds the prior mean. `r` and `blockindpred` (FSA's) are
        unused by the dense strategy."""
        Kxs = kernel.gram(X, Xs)  # (n, ns)
        mu_cross = Kxs.T @ alpha
        V = pd.whiten(Kxs)  # (n, ns)
        if full_cov:
            return mu_cross, kernel.gram(Xs) - V.T @ V
        var = kernel.diag(Xs) - torch.sum(V * V, dim=0)
        return mu_cross, torch.clamp(var, min=0.0)
