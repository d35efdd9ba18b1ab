"""Observation-sharded FITC marginal likelihood (counterpart of
`gaussianprocesses_jl_tpu/parallel/fitc.py`; BASELINE configuration #4).

The observations are sharded over the 'data' axis: each process holds its
rows (X_loc, y_loc) and forms its m x n_loc cross gram and diagonal
residuals. The global pieces come from collectives:

  * Sigma's factor by augmented TSQR: each process QRs its whitened panel
    [Lam_loc^-1/2 Kfu_loc | Lam_loc^-1/2 r_loc] to R_loc ((m+1) x (m+1)),
    the R_locs are all-gathered, and the stack [R_1; ...; R_P; Luu^T 0] is
    QR'd again on every process. The appended residual column makes the
    quadratic form a by-product, quad = R_aug[m, m]^2, never negative;
  * the log-determinant's sum of log Lam and the count n are psum'd.

The QRs are `torch.linalg.qr(mode="reduced")`: `mode="r"` has no backward
in PyTorch (the JAX package differentiates its "r" mode). The replicated
parameters, Luu and the inducing points enter the local work through
`copy`, and the gathered R_locs give back this process's slice of their
gradient, so every process ends with the whole gradient of the mll.
"""
from __future__ import annotations

import math

import torch

from ..ops.linalg import add_diag, chol_logdet, safe_cholesky, solve_lower
from .collectives import all_gather, copy, copy_module, psum

__all__ = ["fitc_mll_sharded_fn", "sharded_fitc_mll", "shard_data"]

_LOG_2PI = math.log(2.0 * math.pi)


def shard_data(X, y, mesh, axis: str = "data"):
    """This process's rows (X_loc, y_loc) of the replicated (X, y): the
    n/P rows at its axis coordinate (n must divide by the axis size)."""
    P_, me = mesh.shape[axis], mesh.coords[axis]
    n = X.shape[0]
    if n % P_:
        raise ValueError(f"n={n} observations not divisible by {P_} processes on axis {axis!r}")
    k = n // P_
    return X[me * k:(me + 1) * k], y[me * k:(me + 1) * k]


def fitc_mll_sharded_fn(kernel_template, mesh, axis: str = "data"):
    """A function (params, X_loc, y_loc, Xu) -> mll with this process's rows
    of the data; `params` is a GPEParams (lognoise, mean, kernel). The mll
    is replicated, -inf when a factor failed, and differentiable in the
    parameters. `kernel_template` is unused (the JAX signature)."""

    def mll_fn(params, X_loc, y_loc, Xu):
        kern = params.kernel
        noise_var = torch.exp(2.0 * params.lognoise.value)
        m = Xu.shape[0]

        Kuu = kern.gram(Xu)
        rel = 1e-10 if X_loc.dtype == torch.float64 else 1e-4
        scale = torch.clamp(torch.max(torch.diagonal(Kuu)), min=1.0)
        Luu, ok_uu = safe_cholesky(add_diag(Kuu, rel * scale))

        # the shard-local work: the replicated pieces enter through copy
        kl = copy_module(kern, mesh, axis)
        Kuf = kl.gram(copy(Xu, mesh, axis), X_loc)  # (m, n_loc)
        Lk = solve_lower(copy(Luu, mesh, axis), Kuf)
        qdiag = torch.sum(Lk * Lk, dim=0)
        # clamp the residual (Kff - Qff >= 0 exactly) before adding the noise
        d = copy(noise_var, mesh, axis) + torch.clamp(kl.diag(X_loc) - qdiag, min=0.0)
        r = y_loc - copy_module(params.mean, mesh, axis).mean(X_loc)
        sd = torch.sqrt(d)
        # augmented TSQR: the whitened residual rides along as column m + 1
        Aw = torch.cat([Kuf.T / sd[:, None], (r / sd)[:, None]], dim=1)  # (n_loc, m+1)
        R_loc = torch.linalg.qr(Aw, mode="reduced").R
        R_all = all_gather(R_loc, mesh, axis)
        bottom = torch.cat([Luu.T, Luu.new_zeros((m, 1))], dim=1)
        R_aug = torch.linalg.qr(torch.cat([R_all, bottom], dim=0), mode="reduced").R
        Rdiag = torch.abs(torch.diagonal(R_aug)[:m])

        quad = R_aug[m, m] ** 2
        logdet = (2.0 * torch.sum(torch.log(Rdiag)) - chol_logdet(Luu)
                  + psum(torch.sum(torch.log(d)), mesh, axis))
        n_total = psum(y_loc.new_full((), float(y_loc.shape[0])), mesh, axis)
        mll = -0.5 * (quad + logdet + n_total * _LOG_2PI)
        ok = ok_uu & torch.isfinite(R_aug).all() & (Rdiag > 0).all()
        return torch.where(ok, mll, torch.full_like(mll, -math.inf))

    return mll_fn


def sharded_fitc_mll(params, X_loc, y_loc, Xu, mesh, axis: str = "data"):
    """The distributed FITC mll in one call, on this process's rows (from
    `shard_data`); differentiable in `params`."""
    return fitc_mll_sharded_fn(params.kernel, mesh, axis)(params, X_loc, y_loc, Xu)
