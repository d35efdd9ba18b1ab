"""GPA: the latent-variable GP with a non-Gaussian likelihood (counterpart
of `gaussianprocesses_jl_tpu/models/gpa.py`).

Whitened parameterization: f = m(x) + L v with v ~ N(0, I) and
L L^T = K + nugget I. The joint log target is log p(y|f) + log p(v) +
log p(theta); its gradient comes from autograd through the gram op and the
library's Cholesky. The flat order is [v; lik; mean; kernel], as in the JAX
package. The model's tensors live on one device in the data's float dtype:
the card unless the caller passes `device="cpu"`. Every target here is
written for one chain; the samplers batch chains with `torch.func.vmap`.
On the card `target_and_dtarget` and the optimizer's objective replay one
CUDA graph, as the GPE's do (`models/gpe.py`).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..ops.kernels import Kernel
from ..ops.leapfrog import ProbitA
from ..ops.likelihoods import BernLik, Likelihood
from ..ops.linalg import require_pd
from ..ops.means import Mean, MeanZero
from ..utils import graphs
from ..utils.modules import Module, module, replace
from .covariance import FullCovariance
from .gpe import _as_X, _device, _embed, _mvn_draws, value_and_grad

__all__ = ["GPAParams", "GPA", "gpa_nugget", "gpa_ll", "gpa_target", "gpa_predict_f",
           "fused_block_a"]

_LOG_2PI = math.log(2.0 * math.pi)

# the latent model's fixed stabilizing nugget on K; in f32 a 1e-6 nugget
# cannot stabilize a smooth (near-low-rank) gram, so it follows the dtype
GPA_NUGGET = 1e-6


def gpa_nugget(dtype) -> float:
    return GPA_NUGGET if dtype == torch.float64 else 1e-4


@module(static=())
class GPAParams(Module):
    """Sampled state of a GPA; flat order [v; lik; mean; kernel]."""

    v: Any  # (n,) whitened latents
    lik: Likelihood
    mean: Mean
    kernel: Kernel

    def block_slices(self):
        n0 = self.v.numel()
        n1 = self.lik.n_params
        n2 = self.mean.n_params
        n3 = self.kernel.n_params
        return (slice(0, n0), slice(n0, n0 + n1), slice(n0 + n1, n0 + n1 + n2),
                slice(n0 + n1 + n2, n0 + n1 + n2 + n3))


def _hyper_prior(params: GPAParams):
    """Log prior of the lik, mean and kernel blocks (v's N(0, I) is written
    out by the targets): a module without priors adds nothing, so a block
    with no parameters (BernLik, MeanZero) adds no tensor of another dtype
    or device."""
    lp = 0.0
    for m in (params.lik, params.mean, params.kernel):
        if any(pr is not None for pr in m.priors_flat()):
            lp = lp + m.prior_logpdf()
    return lp


def fused_block_a(params: GPAParams, X, y, covstrat, include_priors: bool = True):
    """Block A of the split target as the fused leapfrog kernel computes it
    (`ops.leapfrog.ProbitA`), or None where it does not: a probit
    likelihood (`BernLik`), block A the latents v alone (the likelihood and
    the mean carry no parameters) and a dense lower factor
    (`FullCovariance`). Its prior(b) is the hyperprior at each chain's
    kernel parameters b (C, Db)."""
    if not (type(params.lik) is BernLik and params.mean.n_params == 0
            and type(covstrat) is FullCovariance):
        return None
    v0 = params.v.detach().reshape(-1)
    with_priors = include_priors and any(
        pr is not None for m in (params.lik, params.mean, params.kernel) for pr in m.priors_flat())

    def prior(b):
        if not with_priors:
            return b.new_zeros(b.shape[0])
        return torch.func.vmap(
            lambda b1: _hyper_prior(params.with_flat_params(torch.cat([v0, b1]))))(b)

    with torch.no_grad():
        mu = params.mean.mean(X).contiguous()
    return ProbitA(y=y.contiguous(), mu=mu, prior=prior)


def _reject(ok, value):
    return torch.where(ok, value, torch.full_like(value, -math.inf))


def _latent_f(params: GPAParams, X, covstrat):
    pd = covstrat.build(params.kernel, gpa_nugget(X.dtype), X)
    mu = params.mean.mean(X)
    return pd, mu, pd.unwhiten(params.v) + mu


def gpa_ll(params: GPAParams, X, y, covstrat=FullCovariance()):
    """log p(y | v, theta); -inf when the factorization failed.

    A strategy declaring `supports_fused_latent_f = True` (an explicit
    protocol flag, for the distributed strategies of a later slice) must
    expose `latent_f(kernel, nugget, X, v) -> (f, ok)`; its aux pd is then
    None."""
    if getattr(covstrat, "supports_fused_latent_f", False):
        mu = params.mean.mean(X)
        f, ok = covstrat.latent_f(params.kernel, gpa_nugget(X.dtype), X, params.v)
        f = f + mu
        return _reject(ok, torch.sum(params.lik.log_dens(f, y))), (None, mu, f)
    pd, mu, f = _latent_f(params, X, covstrat)
    return _reject(pd.ok, torch.sum(params.lik.log_dens(f, y))), (pd, mu, f)


def gpa_target(params: GPAParams, X, y, covstrat=FullCovariance()):
    """log p(theta, v | y) up to a constant: ll + log N(v; 0, I) + log
    priors."""
    ll, aux = gpa_ll(params, X, y, covstrat)
    n = params.v.numel()
    logp_v = -0.5 * (torch.sum(params.v ** 2) + n * _LOG_2PI)
    return ll + logp_v + _hyper_prior(params), aux


def _predict_f(params: GPAParams, X, y, Xs, covstrat, full_cov: bool):
    """(mean, variance or covariance, ok) of the latent posterior at Xs; ok
    the prior's factorization flag."""
    pd, mu, f = _latent_f(params, X, covstrat)
    alpha = pd.solve(f - mu)
    mu_cross, cov = covstrat.predict_mvn(pd, params.kernel, X, f - mu, alpha, Xs, full_cov)
    return params.mean.mean(Xs) + mu_cross, cov, pd.ok


_WHAT = "the latent predictive's prior K + nugget"


def gpa_predict_f(params: GPAParams, X, y, Xs, covstrat=FullCovariance(),
                  full_cov: bool = False):
    """Latent posterior at Xs: alpha = cK^-1 L v, then the strategy's
    predictive MVN."""
    mu, cov, ok = _predict_f(params, X, y, Xs, covstrat, full_cov)
    require_pd(ok, _WHAT)
    return mu, cov


def _gpa_value_and_grad(*args):
    """The GPA target's `value_and_grad`, as the CUDA graphs capture it."""
    return value_and_grad(gpa_target, *args)


def _gpa_objective(*args):
    """The optimizer's objective: -target and its gradient."""
    t, g = value_and_grad(gpa_target, *args)
    return -t, -g


class GPA:
    """Latent GP with a non-Gaussian likelihood, for the samplers of
    `inference/` and the optimizer. `device` defaults to the CUDA device
    and raises when there is none."""

    def __init__(self, x, y, mean: Mean | None, kernel: Kernel, lik: Likelihood,
                 covstrat=None, v=None, device=None):
        dev = _device(device, "GPA")
        self.x = _as_X(x, device=dev)
        self.y = torch.as_tensor(y).to(dtype=self.x.dtype, device=dev).reshape(-1)
        n = self.x.shape[0]
        if self.y.shape[0] != n:
            raise ValueError("Input and output observations must have consistent dimensions")
        mean = mean if mean is not None else MeanZero()
        v = torch.zeros(n, dtype=torch.float64) if v is None else torch.as_tensor(v)
        params = GPAParams(v=v, lik=lik, mean=mean, kernel=kernel)
        self.params = params.to(dtype=self.x.dtype, device=dev)
        covstrat = covstrat if covstrat is not None else FullCovariance()
        if not getattr(covstrat, "supports_whitened_latents", False):
            # f = mu + L v needs pd.unwhiten, a square factor
            raise TypeError(
                f"GPA requires a covariance strategy with whitened-latent support "
                f"(full dense factor); got {type(covstrat).__name__}")
        self.covstrat = covstrat

    # -- accessors ---------------------------------------------------------
    @property
    def device(self):
        return self.x.device

    @property
    def dtype(self):
        return self.x.dtype

    @property
    def nobs(self):
        return self.x.shape[0]

    @property
    def dim(self):
        return self.x.shape[1]

    @property
    def kernel(self):
        return self.params.kernel

    @property
    def mean(self):
        return self.params.mean

    @property
    def lik(self):
        return self.params.lik

    @property
    def v(self):
        return self.params.v

    def _tensor(self, v):
        return torch.as_tensor(v).to(dtype=self.dtype, device=self.device)

    # -- targets -----------------------------------------------------------
    @property
    def ll(self):
        with torch.no_grad():
            return gpa_ll(self.params, self.x, self.y, self.covstrat)[0]

    @property
    def target(self):
        with torch.no_grad():
            return gpa_target(self.params, self.x, self.y, self.covstrat)[0]

    def target_and_dtarget(self):
        """(target, gradient w.r.t. the flat params), one CUDA graph on the
        card, kept for this model."""
        return graphs.run(self, _gpa_value_and_grad, self.params.flat_params().detach(), None,
                          None, self.params, self.x, self.y, self.covstrat)

    @property
    def dtarget(self):
        return self.target_and_dtarget()[1]

    # -- parameter protocol ------------------------------------------------
    def get_params(self, lik=True, domean=True, kern=True):
        vec = self.params.flat_params()
        sv, *rest = self.params.block_slices()
        parts = [vec[sv]]  # v is always included
        parts += [vec[s] for flag, s in zip((lik, domean, kern), rest) if flag]
        return torch.cat(parts)

    def set_params(self, hyp, process=True, lik=True, domean=True, kern=True):
        hyp = self._tensor(hyp).reshape(-1)
        expected = self.num_params(lik=lik, domean=domean, kern=kern)
        if not process:
            expected -= self.nobs
        if hyp.shape[0] != expected:
            raise ValueError(f"expected {expected} parameters, got {hyp.shape[0]}")
        self.params = self.params.with_flat_params(_embed(
            self.params.flat_params(), hyp, self.params.block_slices(),
            (process, lik, domean, kern)))
        return self

    def num_params(self, lik=True, domean=True, kern=True):
        sv, *rest = self.params.block_slices()
        return (sv.stop - sv.start) + sum(s.stop - s.start for flag, s in
                                          zip((lik, domean, kern), rest) if flag)

    def set_priors(self, *, lik=None, mean=None, kern=None):
        p = self.params
        if lik is not None:
            p = replace(p, lik=p.lik.set_priors(tuple(lik)))
        if mean is not None:
            p = replace(p, mean=p.mean.set_priors(tuple(mean)))
        if kern is not None:
            p = replace(p, kernel=p.kernel.set_priors(tuple(kern)))
        self.params = p
        return self

    # -- objective plumbing ------------------------------------------------
    def block_flag_names(self):
        return ("lik", "domean", "kern")

    def _block_plumbing(self, flags):
        """(embed, x0, blocks) over [v (always); selected blocks]."""
        flags = (True,) + tuple(flags)
        full0 = self.params.flat_params().detach()
        sls = self.params.block_slices()
        names = ("process",) + self.block_flag_names()
        active = [(n, s) for n, s, f in zip(names, sls, flags) if f]

        def embed(sub):
            return _embed(full0, sub, sls, flags)

        x0 = torch.cat([full0[s] for _, s in active])
        blocks = [(n, s.stop - s.start) for n, s in active]
        return embed, x0, blocks

    def make_logprob(self, lik=True, domean=True, kern=True, *, include_priors=True):
        """Log target over [v; selected hyperparameter blocks], for the
        samplers: (logprob, x0, embed, blocks)."""
        embed, x0, blocks = self._block_plumbing((lik, domean, kern))
        base, X, y, cs = self.params, self.x, self.y, self.covstrat

        def logprob(sub):
            p = base.with_flat_params(embed(sub))
            if include_priors:
                return gpa_target(p, X, y, cs)[0]
            return gpa_ll(p, X, y, cs)[0]

        return logprob, x0, embed, blocks

    def make_split_logprob(self, *, include_priors=True):
        """The target split for `inference.split.split_hmc`: block A =
        [v; lik; mean] (the factor is constant given the kernel), block B =
        [kern] (a move refactorizes). Returns (precompute, logprob_a,
        logprob_b, a0, b0):

          precompute(b)          -> pd (the factorized K at kernel params b)
          logprob_a(a, pd, b)    -> the full joint target with the CACHED pd
          logprob_b(b, a)        -> the full joint target, rebuilding pd

        In float32, `logprob_a.fused` is `fused_block_a`'s description of
        block A (None where the kernel does not compute it): the split
        sampler's fused leapfrog route on the card.
        """
        base, X, y, cs = self.params, self.x, self.y, self.covstrat
        na = base.block_slices()[3].start
        full0 = base.flat_params().detach()
        nugget = gpa_nugget(X.dtype)

        def to_params(a, b):
            return base.with_flat_params(torch.cat([a, b]))

        def precompute(b):
            return cs.build(base.kernel.with_flat_params(b), nugget, X)

        def logprob_a(a, pd, b):
            p = to_params(a, b)
            f = pd.unwhiten(p.v) + p.mean.mean(X)  # one matvec, no factorization
            lp = torch.sum(p.lik.log_dens(f, y)) - 0.5 * (torch.sum(p.v ** 2)
                                                          + p.v.numel() * _LOG_2PI)
            if include_priors:
                lp = lp + _hyper_prior(p)
            return _reject(pd.ok, lp)

        def logprob_b(b, a):
            p = to_params(a, b)
            if include_priors:
                return gpa_target(p, X, y, cs)[0]
            return gpa_ll(p, X, y, cs)[0]

        logprob_a.fused = (fused_block_a(base, X, y, cs, include_priors)
                           if X.dtype == torch.float32 else None)
        return precompute, logprob_a, logprob_b, full0[:na], full0[na:]

    def make_objective(self, lik=True, domean=True, kern=True):
        """(vg, x0, embed, blocks), vg(sub) = (-logprob, its gradient) over
        [v; selected blocks]: v is always free. One CUDA graph on the card (a
        `graphs.Bound`)."""
        embed, x0, blocks = self._block_plumbing((lik, domean, kern))
        vg = graphs.Bound(self, _gpa_objective, self.params.flat_params().detach(),
                          (True, lik, domean, kern), self.params, self.x, self.y, self.covstrat)
        return vg, x0, embed, blocks

    # -- prediction --------------------------------------------------------
    def predict_f(self, xs, full_cov: bool = False):
        """The latent predictive; on the card one CUDA graph kept for the
        model at each shape of xs and `full_cov`."""
        xs = _as_X(xs, dtype=self.dtype, device=self.device)
        with torch.no_grad():
            mu, cov, ok = graphs.run(self, _predict_f, self.params, self.x, self.y, xs,
                                     self.covstrat, full_cov, static="predict_f")
        require_pd(ok, _WHAT)
        return mu, cov

    def predict_y(self, xs, full_cov: bool = False):
        """Predictive observation moments through the likelihood's
        predict_obs."""
        mu, cov = self.predict_f(xs, full_cov=full_cov)
        with torch.no_grad():
            return self.params.lik.predict_obs(mu, cov.diagonal() if full_cov else cov)

    def rand(self, xs, n_samples: int = 1, generator: torch.Generator | None = None):
        """Latent draws at xs from the current (v, theta) posterior, through
        eigh with the spectrum clamped at 0; `generator` lives on the model's
        device."""
        mu, cov = self.predict_f(xs, full_cov=True)
        return _mvn_draws(mu, cov, n_samples, generator)

    def optimize(self, **kwargs):
        from ..inference.optimize import optimize

        return optimize(self, **kwargs)

    def sample_params(self, generator: torch.Generator | None = None):
        """Hyperparameters (not latents) drawn from their priors."""
        parts = [m.sample_priors(generator) for m in (self.lik, self.mean, self.kernel)]
        return torch.cat([t.to(dtype=self.dtype, device=self.device) for t in parts])

    def __repr__(self):
        return (f"GPA(nobs={self.nobs}, dim={self.dim}, lik={type(self.lik).__name__}, "
                f"kernel={self.kernel!r}, device={self.device})")

