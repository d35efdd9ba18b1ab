"""Observation likelihoods for non-Gaussian GP models (counterpart of
`gaussianprocesses_jl_tpu/ops/likelihoods.py`).

Protocol:
  log_dens(f, y)       elementwise log p(y_i | f_i)              -> (n,)
  dlog_dens_df(f, y)   d/df log p, by autograd                    -> (n,)
  mean_lik / var_lik   moments of y | f                           -> (n,)
  predict_obs(mu, var) predictive moments of y given f ~ N(mu, var):
                       20-point Gauss-Hermite, closed forms for the
                       Bernoulli and the Gaussian
  var_exp(y, m, v)     sum_i E_{f~N(m,v)}[log p(y_i|f_i)], the VI term:
                       closed form for the Poisson and the Gaussian,
                       quadrature for the rest
  dv_var_exp(y, m, v)  d var_exp / d v elementwise, by autograd

Plain elementwise PyTorch: nothing here needs a kernel of its own. `nu`
(Student-t) and `n` (binomial) are static integers. y is cast to f's dtype
and device.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.special import gammaln, ndtr

from ..utils.modules import Module, module
from ..utils.quadrature import hermgauss_expectation

__all__ = [
    "Likelihood",
    "GaussLik",
    "BernLik",
    "PoisLik",
    "StuTLik",
    "ExpLik",
    "BinLik",
]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _like(y, f):
    return torch.as_tensor(y).to(dtype=f.dtype, device=f.device)


class _LogNdtr(torch.autograd.Function):
    """torch.special.log_ndtr with a vmap rule: the operator has no batching
    rule of its own, and `torch.func.vmap` would run it once a chain. It is
    elementwise, so the rule applies it to the batched tensor as it is. The
    derivative, phi(x) / Phi(x) = exp(-x^2 / 2 - log(2 pi) / 2 - log_ndtr(x)),
    is written in operators that batch."""

    @staticmethod
    def forward(x):
        return torch.special.log_ndtr(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(-0.5 * x * x - _HALF_LOG_2PI - out)

    @staticmethod
    def vmap(info, in_dims, x):
        return _LogNdtr.apply(x), in_dims[0]


def log_ndtr(x):
    return _LogNdtr.apply(x)


class Likelihood(Module):
    def log_dens(self, f, y):
        raise NotImplementedError

    def dlog_dens_df(self, f, y):
        """d log p(y|f) / df elementwise, by autograd."""
        y = _like(y, f)
        return torch.func.grad(lambda ff: self.log_dens(ff, y).sum())(f)

    def mean_lik(self, f):
        raise NotImplementedError

    def var_lik(self, f):
        raise NotImplementedError

    def predict_obs(self, fmean, fvar):
        """Predictive mean and variance of y when f ~ N(fmean, fvar), by
        Gauss-Hermite quadrature."""
        m = hermgauss_expectation(lambda f: self.mean_lik(f), fmean, fvar)
        second = hermgauss_expectation(
            lambda f: self.var_lik(f) + self.mean_lik(f) ** 2, fmean, fvar)
        return m, second - m**2

    def var_exp(self, y, m, v):
        """sum_i E_{f_i~N(m_i, v_i)}[log p(y_i | f_i)] (the VI objective)."""
        y = _like(y, m)
        return torch.sum(hermgauss_expectation(lambda f: self.log_dens(f, y[..., None]), m, v))

    def dv_var_exp(self, y, m, v):
        """d var_exp / d v elementwise."""
        return torch.func.grad(lambda vv: self.var_exp(y, m, vv))(v)


@module(static=("priors",))
class GaussLik(Likelihood):
    """Gaussian likelihood with std sigma = exp(lsigma); params [lsigma].

    The closed-form `var_exp` is -0.5 log(2 pi) - log sigma
    - ((y-m)^2 + v) / (2 sigma^2), as in the JAX package, which departs from
    the reference's gaussian.jl (it divides by sigma, not sigma^2, and uses
    -0.5 log sigma): a reference bug, not behavior to replicate."""

    lsigma: Any
    priors: tuple = ()

    def log_dens(self, f, y):
        s2 = torch.exp(2.0 * self.lsigma)
        return -_HALF_LOG_2PI - self.lsigma - 0.5 * (_like(y, f) - f) ** 2 / s2

    def mean_lik(self, f):
        return f

    def var_lik(self, f):
        return torch.ones_like(f) * torch.exp(2.0 * self.lsigma)

    def predict_obs(self, fmean, fvar):
        return fmean, fvar + torch.exp(2.0 * self.lsigma)

    def var_exp(self, y, m, v):
        s2 = torch.exp(2.0 * self.lsigma)
        return torch.sum(-_HALF_LOG_2PI - self.lsigma - 0.5 * ((_like(y, m) - m) ** 2 + v) / s2)


@module(static=())
class BernLik(Likelihood):
    """Bernoulli with probit link theta = Phi(f); y in {0, 1}."""

    def log_dens(self, f, y):
        y = _like(y, f)
        return y * log_ndtr(f) + (1.0 - y) * log_ndtr(-f)

    def mean_lik(self, f):
        return ndtr(f)

    def var_lik(self, f):
        p = ndtr(f)
        return p * (1.0 - p)

    def predict_obs(self, fmean, fvar):
        # closed form: p = Phi(mu / sqrt(1 + var))
        p = ndtr(fmean / torch.sqrt(1.0 + fvar))
        return p, p - p * p


@module(static=())
class PoisLik(Likelihood):
    """Poisson with log link theta = exp(f)."""

    def log_dens(self, f, y):
        y = _like(y, f)
        return y * f - torch.exp(f) - gammaln(1.0 + y)

    def mean_lik(self, f):
        return torch.exp(f)

    def var_lik(self, f):
        return torch.exp(f)

    def var_exp(self, y, m, v):
        # closed form: sum y m - exp(m + v/2) - log y!
        y = _like(y, m)
        return torch.sum(y * m - torch.exp(m + 0.5 * v) - gammaln(1.0 + y))


@module(static=("nu", "priors"))
class StuTLik(Likelihood):
    """Student-t with fixed integer df nu and scale sigma = exp(lsigma);
    params [lsigma]."""

    lsigma: Any
    nu: int = 3
    priors: tuple = ()

    def log_dens(self, f, y):
        nu = float(self.nu)
        c = (math.lgamma(0.5 * (nu + 1.0)) - math.lgamma(0.5 * nu)
             - 0.5 * math.log(math.pi * nu) - self.lsigma)
        z = (_like(y, f) - f) / torch.exp(self.lsigma)
        return c - 0.5 * (nu + 1.0) * torch.log1p(z * z / nu)

    def mean_lik(self, f):
        return f

    def var_lik(self, f):
        nu = float(self.nu)
        return torch.ones_like(f) * (torch.exp(2.0 * self.lsigma) * nu / (nu - 2.0))


@module(static=())
class ExpLik(Likelihood):
    """Exponential with rate theta = exp(-f)."""

    def log_dens(self, f, y):
        return -f - torch.exp(-f) * _like(y, f)

    def mean_lik(self, f):
        return torch.exp(f)

    def var_lik(self, f):
        return torch.exp(2.0 * f)


@module(static=("n",))
class BinLik(Likelihood):
    """Binomial with fixed trial count n, logistic link."""

    n: int = 1

    def log_dens(self, f, y):
        y = _like(y, f)
        n = float(self.n)
        return (math.lgamma(n + 1.0) - gammaln(y + 1.0) - gammaln(n - y + 1.0)
                + y * F.logsigmoid(f) + (n - y) * F.logsigmoid(-f))

    def mean_lik(self, f):
        return float(self.n) * torch.sigmoid(f)

    def var_lik(self, f):
        p = torch.sigmoid(f)
        return float(self.n) * p * (1.0 - p)
