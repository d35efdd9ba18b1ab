"""Analytic cross-validation for GPE (counterpart of
`gaussianprocesses_jl_tpu/inference/crossvalidation.py`).

Leave-one-out through Rasmussen & Williams eq. 5.12 (sigma_i^2 =
1/[K^-1]_ii, mu_i = y_i - alpha_i sigma_i^2), and arbitrary folds through the
inverse-submatrix identity Sigma_V = inv([K^-1]_VV), mu_V = y_V - Sigma_V
alpha_V. The folds are padded to one width with masks and run as one batch
(a batched `torch.linalg.inv` and `cholesky` over (folds, fmax, fmax)); a
padded lane is an independent unit-variance dimension centred on y, which
adds nothing to the criterion. Gradients are `torch.autograd.grad` of the
criterion over the selected parameter blocks, through the gram op (the VJP
kernel on a CUDA tensor).
"""
from __future__ import annotations

import math

import torch

from ..models.gpe import GPEParams, gpe_factorize
from ..ops.linalg import require_pd, solve_lower

__all__ = [
    "predict_LOO",
    "logp_LOO",
    "dlogp_LOO",
    "predict_CVfold",
    "logp_CVfold",
    "dlogp_CVfold",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _Linv_alpha(params: GPEParams, X, y, covstrat):
    """(L^-1, alpha = K^-1 r) of the model's factorized train covariance."""
    pd = gpe_factorize(params, X, covstrat)
    require_pd(pd.ok, "cross-validation's train covariance")
    alpha = pd.solve(y - params.mean.mean(X))
    eye = torch.eye(pd.L.shape[0], dtype=pd.L.dtype, device=pd.L.device)
    return solve_lower(pd.L, eye), alpha


def _loo_parts(params: GPEParams, X, y, covstrat):
    Linv, alpha = _Linv_alpha(params, X, y, covstrat)
    sigma2 = 1.0 / torch.sum(Linv * Linv, dim=0)  # 1 / diag(K^-1)
    return y - alpha * sigma2, sigma2


def predict_LOO(gp):
    """(mu_i, sigma_i^2) of y_i | y_-i for every i."""
    with torch.no_grad():
        return _loo_parts(gp.params, gp.x, gp.y, gp.covstrat)


def _logp_loo(params, X, y, covstrat):
    mu, sigma2 = _loo_parts(params, X, y, covstrat)
    return torch.sum(-0.5 * (_LOG_2PI + torch.log(sigma2) + (y - mu) ** 2 / sigma2))


def logp_LOO(gp):
    """Sum of the LOO predictive log densities."""
    with torch.no_grad():
        return _logp_loo(gp.params, gp.x, gp.y, gp.covstrat)


def _grad(gp, flags, criterion):
    """Gradient of criterion(params) over the blocks selected by flags."""
    embed, x0, _ = gp._block_plumbing(flags)
    sub = x0.detach().requires_grad_()
    (g,) = torch.autograd.grad(criterion(gp.params.with_flat_params(embed(sub))), sub)
    return g


def dlogp_LOO(gp, noise=True, domean=True, kern=True):
    """Gradient of the LOO criterion over the selected blocks."""
    return _grad(gp, (noise, domean, kern),
                 lambda p: _logp_loo(p, gp.x, gp.y, gp.covstrat))


def _pad_folds(gp, folds):
    """The folds padded to one width: (idx, mask), (nf, fmax) each, on the
    model's device; padded lanes index 0 with mask 0."""
    folds = [list(f) for f in folds]
    fmax = max(len(f) for f in folds)
    idx = [f + [0] * (fmax - len(f)) for f in folds]
    mask = [[1.0] * len(f) + [0.0] * (fmax - len(f)) for f in folds]
    return (torch.as_tensor(idx, dtype=torch.int64, device=gp.device),
            torch.as_tensor(mask, dtype=gp.dtype, device=gp.device))


def _cvfold_mvns(params, X, y, covstrat, idx, mask):
    """Every fold's (mu_V, Sigma_V), (nf, fmax) and (nf, fmax, fmax), in one
    batch; padded lanes get Sigma 1 and mu y."""
    Linv, alpha = _Linv_alpha(params, X, y, covstrat)
    Kinv = Linv.T @ Linv
    KVV = Kinv[idx[:, :, None], idx[:, None, :]] * (mask[:, :, None] * mask[:, None, :])
    KVV = KVV + torch.diag_embed(1.0 - mask)  # identity padding
    SigmaV = torch.linalg.inv(KVV)
    muV = y[idx] - (SigmaV @ (alpha[idx] * mask)[:, :, None])[:, :, 0]
    return muV, SigmaV


def predict_CVfold(gp, folds):
    """Cross-validated fold predictions: a list of (mu_V, Sigma_V)."""
    idx, mask = _pad_folds(gp, folds)
    with torch.no_grad():
        mus, Sigmas = _cvfold_mvns(gp.params, gp.x, gp.y, gp.covstrat, idx, mask)
    return [(mus[i, :len(f)], Sigmas[i, :len(f), :len(f)]) for i, f in enumerate(folds)]


def _logp_cvfold(params, X, y, covstrat, idx, mask):
    mus, Sigmas = _cvfold_mvns(params, X, y, covstrat, idx, mask)
    yV = y[idx] * mask + mus * (1.0 - mask)  # padded lanes add 0
    L = torch.linalg.cholesky(Sigmas)
    w = torch.linalg.solve_triangular(L, (yV - mus)[:, :, None], upper=False)[:, :, 0]
    k = torch.sum(mask, dim=1)
    logdiag = torch.log(L.diagonal(dim1=-2, dim2=-1))
    return torch.sum(-0.5 * (torch.sum(w * w, dim=1) + k * _LOG_2PI)
                     - torch.sum(logdiag * mask, dim=1))


def logp_CVfold(gp, folds):
    """The CV criterion for arbitrary folds."""
    idx, mask = _pad_folds(gp, folds)
    with torch.no_grad():
        return _logp_cvfold(gp.params, gp.x, gp.y, gp.covstrat, idx, mask)


def dlogp_CVfold(gp, folds, noise=True, domean=True, kern=True):
    """Gradient of the fold-CV criterion over the selected blocks."""
    idx, mask = _pad_folds(gp, folds)
    return _grad(gp, (noise, domean, kern),
                 lambda p: _logp_cvfold(p, gp.x, gp.y, gp.covstrat, idx, mask))
