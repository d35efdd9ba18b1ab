"""Plain Gaussian-process arithmetic: grams, the exact GP's negative log
marginal likelihood, and the whitened-latent probit
GP's log target, with gradients by autograd.

Every gram is built from squared distances written as
|x|^2 + |x'|^2 - 2 x.x', so that its one matrix product takes the mode's
precision (`precision.mm`). Flat parameter orders are the package's:
the exact GP's [log noise std, log lengthscale, log signal std]; the
latent GP's [v (n whitened latents), log lengthscales (d), log signal std].
"""
from __future__ import annotations

import math

import torch

from .precision import mm

__all__ = ["sq_dist", "se_iso_gram", "mat32_ard_gram", "gpe_nll",
           "gpa_factor", "gpa_target", "value_and_grad", "normal_logpdf"]

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT3 = math.sqrt(3.0)


def sq_dist(X1: torch.Tensor, X2: torch.Tensor, mode: str) -> torch.Tensor:
    """Squared distances between the rows of X1 (..., n1, d) and X2 (..., n2, d),
    clamped at 0."""
    x1 = torch.sum(X1 * X1, dim=-1)
    x2 = torch.sum(X2 * X2, dim=-1)
    r2 = x1[..., :, None] + x2[..., None, :] - 2.0 * mm(X1, X2.transpose(-1, -2), mode)
    return torch.clamp_min(r2, 0.0)


def se_iso_gram(X1, X2, ll, lsigma, mode):
    """sigma^2 exp(-r^2 / (2 l^2))."""
    return torch.exp(2.0 * lsigma - 0.5 * sq_dist(X1, X2, mode) * torch.exp(-2.0 * ll))


def mat32_ard_gram(X1, X2, ll, lsigma, mode):
    """sigma^2 (1 + s) exp(-s), s = sqrt(3) r over inputs scaled by exp(-ll);
    ll (..., d), lsigma (...). A tiny offset under the square root keeps
    its gradient finite at r = 0, where dk/dr^2 is finite."""
    s1 = X1 * torch.exp(-ll)[..., None, :]
    s2 = X2 * torch.exp(-ll)[..., None, :]
    s = _SQRT3 * torch.sqrt(sq_dist(s1, s2, mode) + 1e-30)
    return torch.exp(2.0 * lsigma)[..., None, None] * (1.0 + s) * torch.exp(-s)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def gpe_nll(theta, X, y, mode):
    """-log p(y | theta) of the exact GP with an isotropic SE kernel and a
    zero mean; +inf where K + noise I does not factor."""
    lognoise, ll, lsigma = theta[0], theta[1], theta[2]
    n = X.shape[0]
    K = se_iso_gram(X, X, ll, lsigma, mode) + torch.exp(2.0 * lognoise) * _eye(n, X)
    L, info = torch.linalg.cholesky_ex(K)
    w = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    nll = 0.5 * (torch.sum(w * w) + 2.0 * torch.sum(torch.log(torch.diagonal(L)))
                 + n * _LOG_2PI)
    ok = (info == 0) & torch.isfinite(nll)
    return torch.where(ok, nll, torch.full_like(nll, math.inf))


def normal_logpdf(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * z * z - math.log(sigma) - 0.5 * _LOG_2PI


def gpa_factor(hyp, X, nugget, mode, perturb=None):
    """(L (C, n, n), ok (C,)): the factors of K + nugget I for the kernel
    hyperparameters hyp (C, d + 1), Matern 3/2 with ARD; `perturb`, if
    given, maps K + nugget I to the matrix factored in its place."""
    d = X.shape[-1]
    K = mat32_ard_gram(X, X, hyp[:, :d], hyp[:, d], mode) + nugget * _eye(X.shape[0], X)
    if perturb is not None:
        K = perturb(K)
    L, info = torch.linalg.cholesky_ex(K)
    return L, (info == 0) & torch.isfinite(L).flatten(1).all(1)


def gpa_target(v, hyp, X, y, nugget, prior, mode, factor=None, perturb=None):
    """The latent probit GP's log target (C,) at whitened latents v (C, n)
    and kernel hyperparameters hyp (C, d + 1): sum log Phi((2y - 1) f)
    with f = L v, + log N(v; 0, I) + the hyperparameters' Normal(mu, sigma)
    priors; -inf where K does not factor. `factor`: (L, ok) held fixed
    (the split sampler's A block), else built from hyp (and `perturb`, as
    in `gpa_factor`)."""
    L, ok = gpa_factor(hyp, X, nugget, mode, perturb) if factor is None else factor
    f = mm(L, v[..., None], mode)[..., 0]
    ll = torch.sum(torch.special.log_ndtr((2.0 * y - 1.0) * f), dim=-1)
    logp_v = -0.5 * (torch.sum(v * v, dim=-1) + v.shape[-1] * _LOG_2PI)
    logp_h = torch.sum(normal_logpdf(hyp, prior[0], prior[1]), dim=-1)
    t = ll + logp_v + logp_h
    return torch.where(ok, t, torch.full_like(t, -math.inf))


def value_and_grad(fn, x):
    """(fn(x), d sum(fn(x)) / dx), both detached: for a batch of chains,
    each chain's own gradient."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        value = fn(x)
        (grad,) = torch.autograd.grad(value.sum(), x)
    return value.detach(), grad.detach()
