"""Analytic cross-validation for GPE (counterpart of
`gaussianprocesses_jl_tpu/inference/crossvalidation.py`).

Leave-one-out through Rasmussen & Williams eq. 5.12 (sigma_i^2 =
1/[K^-1]_ii, mu_i = y_i - alpha_i sigma_i^2), and arbitrary folds through the
inverse-submatrix identity Sigma_V = inv([K^-1]_VV), mu_V = y_V - Sigma_V
alpha_V. The folds are padded to one width with masks and run as one batch
(batched Cholesky factorizations and triangular solves over (folds, fmax,
fmax)); a padded lane is an independent unit-variance dimension centred on
y, which adds nothing to the criterion. Gradients are `torch.autograd.grad`
of the criterion over the selected parameter blocks, through the gram op
(the VJP kernel on a CUDA tensor).

On the card each of the six functions replays a CUDA graph
(`utils/graphs.py`) kept for the model, the counterpart of the JAX
package's jitted ones: its inputs are the parameters, the data and, for
the folds, the padded index and mask tensors, built outside it from the
fold lists, so another fold set of the same padded shape replays it. A
graph returns the factorizations' flags beside its result, and the host
reads them after the replay (`require_pd`).
"""
from __future__ import annotations

import math

import torch

from ..models.gpe import GPEParams, _embed, gpe_factorize
from ..ops.linalg import require_pd, solve_lower, solve_upper
from ..utils import graphs

__all__ = [
    "predict_LOO",
    "logp_LOO",
    "dlogp_LOO",
    "predict_CVfold",
    "logp_CVfold",
    "dlogp_CVfold",
]

_LOG_2PI = math.log(2.0 * math.pi)
_WHAT = "cross-validation's train covariance"


def _Linv_alpha(params: GPEParams, X, y, covstrat):
    """(L^-1, alpha = K^-1 r, ok) of the model's factorized train
    covariance; ok the factorization's flag."""
    pd = gpe_factorize(params, X, covstrat)
    alpha = pd.solve(y - params.mean.mean(X))
    eye = torch.eye(pd.L.shape[0], dtype=pd.L.dtype, device=pd.L.device)
    return solve_lower(pd.L, eye), alpha, pd.ok


def _loo_parts(params: GPEParams, X, y, covstrat):
    Linv, alpha, ok = _Linv_alpha(params, X, y, covstrat)
    sigma2 = 1.0 / torch.sum(Linv * Linv, dim=0)  # 1 / diag(K^-1)
    return y - alpha * sigma2, sigma2, ok


def _logp_loo(params, X, y, covstrat):
    mu, sigma2, ok = _loo_parts(params, X, y, covstrat)
    return torch.sum(-0.5 * (_LOG_2PI + torch.log(sigma2) + (y - mu) ** 2 / sigma2)), ok


def _checked(out):
    """`out` without its last entry, the flag, which must hold."""
    require_pd(out[-1], _WHAT)
    return out[0] if len(out) == 2 else out[:-1]


def _run(gp, fn, *args, static):
    """fn(gp.params, gp.x, gp.y, gp.covstrat, *args), through the model's
    graph `static`, its flag checked."""
    with torch.no_grad():
        return _checked(graphs.run(gp, fn, gp.params, gp.x, gp.y, gp.covstrat, *args,
                                   static=static))


def predict_LOO(gp):
    """(mu_i, sigma_i^2) of y_i | y_-i for every i."""
    return _run(gp, _loo_parts, static="predict_LOO")


def logp_LOO(gp):
    """Sum of the LOO predictive log densities."""
    return _run(gp, _logp_loo, static="logp_LOO")


def _criterion_grad(criterion, params, X, y, covstrat, sub, full0, flags, *args):
    """(gradient, ok) of criterion(params, X, y, covstrat, *args) over the
    flat parameters `sub` of the blocks `flags` selects."""
    with torch.enable_grad():
        sub = sub.detach().requires_grad_()
        p = params.with_flat_params(_embed(full0, sub, params.block_slices(), flags))
        value, ok = criterion(p, X, y, covstrat, *args)
        (g,) = torch.autograd.grad(value, sub)
    return g, ok


def _grad(gp, flags, criterion, *args, static):
    """Gradient of criterion over the blocks selected by flags."""
    _, x0, _ = gp._block_plumbing(flags)
    full0 = gp.params.flat_params().detach()
    return _checked(graphs.run(
        gp, lambda *a: _criterion_grad(criterion, *a), gp.params, gp.x, gp.y, gp.covstrat,
        x0.detach(), full0, flags, *args, static=static))


def dlogp_LOO(gp, noise=True, domean=True, kern=True):
    """Gradient of the LOO criterion over the selected blocks."""
    return _grad(gp, (noise, domean, kern), _logp_loo, static="dlogp_LOO")


def _pad_folds(gp, folds):
    """The folds padded to one width: (idx, mask), (nf, fmax) each, on the
    model's device; padded lanes index 0 with mask 0. Made from the host's
    lists, outside any graph."""
    folds = [list(f) for f in folds]
    fmax = max(len(f) for f in folds)
    idx = [f + [0] * (fmax - len(f)) for f in folds]
    mask = [[1.0] * len(f) + [0.0] * (fmax - len(f)) for f in folds]
    return (torch.as_tensor(idx, dtype=torch.int64, device=gp.device),
            torch.as_tensor(mask, dtype=gp.dtype, device=gp.device))


def _spd_inv(A):
    """A^-1 of a batch of SPD matrices through their factors, and the
    factors' flag."""
    L, info = torch.linalg.cholesky_ex(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    return solve_upper(L, solve_lower(L, eye)), (info == 0).all()


def _cvfold_mvns(params, X, y, covstrat, idx, mask):
    """Every fold's (mu_V, Sigma_V), (nf, fmax) and (nf, fmax, fmax), in one
    batch, and the factorizations' flag; padded lanes get Sigma 1 and mu y."""
    Linv, alpha, ok = _Linv_alpha(params, X, y, covstrat)
    Kinv = Linv.T @ Linv
    KVV = Kinv[idx[:, :, None], idx[:, None, :]] * (mask[:, :, None] * mask[:, None, :])
    KVV = KVV + torch.diag_embed(1.0 - mask)  # identity padding
    SigmaV, ok_v = _spd_inv(KVV)
    muV = y[idx] - (SigmaV @ (alpha[idx] * mask)[:, :, None])[:, :, 0]
    return muV, SigmaV, ok & ok_v


def predict_CVfold(gp, folds):
    """Cross-validated fold predictions: a list of (mu_V, Sigma_V)."""
    mus, Sigmas = _run(gp, _cvfold_mvns, *_pad_folds(gp, folds), static="predict_CVfold")
    return [(mus[i, :len(f)], Sigmas[i, :len(f), :len(f)]) for i, f in enumerate(folds)]


def _logp_cvfold(params, X, y, covstrat, idx, mask):
    mus, Sigmas, ok = _cvfold_mvns(params, X, y, covstrat, idx, mask)
    yV = y[idx] * mask + mus * (1.0 - mask)  # padded lanes add 0
    L, info = torch.linalg.cholesky_ex(Sigmas)
    w = solve_lower(L, (yV - mus)[:, :, None])[:, :, 0]
    k = torch.sum(mask, dim=1)
    logdiag = torch.log(L.diagonal(dim1=-2, dim2=-1))
    value = torch.sum(-0.5 * (torch.sum(w * w, dim=1) + k * _LOG_2PI)
                      - torch.sum(logdiag * mask, dim=1))
    return value, ok & (info == 0).all()


def logp_CVfold(gp, folds):
    """The CV criterion for arbitrary folds."""
    return _run(gp, _logp_cvfold, *_pad_folds(gp, folds), static="logp_CVfold")


def dlogp_CVfold(gp, folds, noise=True, domean=True, kern=True):
    """Gradient of the fold-CV criterion over the selected blocks."""
    return _grad(gp, (noise, domean, kern), _logp_cvfold, *_pad_folds(gp, folds),
                 static="dlogp_CVfold")
