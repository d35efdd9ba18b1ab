"""Exact GP regression, GPE (counterpart of `gaussianprocesses_jl_tpu/models/gpe.py`).

The marginal likelihood is one function of the hyperparameters; its
gradient comes from autograd on the flat parameter vector. Data are
row-major (n, d). The model's tensors live on one device in the data's
float dtype: the card unless the caller passes `device="cpu"`.

On the card the value and gradient (`target_and_dtarget`, and the
optimizer's objective from `make_objective`) replay one CUDA graph
(`utils/graphs.py`), the counterpart of the JAX package's jitted
`value_and_grad`: its inputs are the flat parameters, the parameter
module's tensors, the data and the strategy's tensors, so `set_params` and
a `fit` of the same size replay it, and a new size (`push`) or structure
(a prior, a kernel) captures a graph of its own. The graphs are kept for
the model (its last `graphs.PER_OWNER`) and go with it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.kernels import Kernel, SEIso
from ..ops.linalg import require_pd
from ..ops.means import Mean, MeanZero
from ..utils import graphs
from ..utils.modules import Module, module, replace
from ..utils.params import Param, wrap_param
from .covariance import FullCovariance

__all__ = ["GPEParams", "GPE", "GP", "gpe_factorize", "gpe_mll", "gpe_target",
           "gpe_predict_f", "noise_variance"]

_LOG_2PI = math.log(2.0 * math.pi)


@module(static=())
class GPEParams(Module):
    """Trainable state of a GPE; flat order [lognoise; mean; kernel]."""

    lognoise: Param
    mean: Mean
    kernel: Kernel

    def block_slices(self):
        n0 = self.lognoise.n_params
        n1 = self.mean.n_params
        n2 = self.kernel.n_params
        return slice(0, n0), slice(n0, n0 + n1), slice(n0 + n1, n0 + n1 + n2)


def _noise_var(lognoise_value):
    return torch.exp(2.0 * lognoise_value)


# ---------------------------------------------------------------------------
# Inference core
# ---------------------------------------------------------------------------


def gpe_factorize(params: GPEParams, X, covstrat):
    return covstrat.build(params.kernel, _noise_var(params.lognoise.value), X)


def gpe_mll(params: GPEParams, X, y, covstrat=FullCovariance()):
    """Marginal log likelihood -1/2 (r^T K^-1 r + logdet + n log 2pi).
    Returns (mll, (pd, mu)); mll is -inf when the factorization failed, the
    quadratic form is negative or a piece is not finite. pd is None for
    strategies with a fused quad_logdet."""
    mu = params.mean.mean(X)
    r = y - mu
    n = y.shape[0]
    fused = getattr(covstrat, "quad_logdet", None)
    if fused is not None:
        quad, logdet, ok = fused(params.kernel, _noise_var(params.lognoise.value), X, r)
        pd = None
    else:
        pd = gpe_factorize(params, X, covstrat)
        quad = pd.quad(r)
        logdet = pd.logdet()
        ok = pd.ok
    mll = -0.5 * (quad + logdet + n * _LOG_2PI)
    valid = ok & (quad >= 0.0) & torch.isfinite(quad) & torch.isfinite(logdet)
    mll = torch.where(valid, mll, torch.full_like(mll, -math.inf))
    return mll, (pd, mu)


def gpe_target(params: GPEParams, X, y, covstrat=FullCovariance()):
    """Log posterior target = mll + log priors."""
    mll, aux = gpe_mll(params, X, y, covstrat)
    return mll + params.prior_logpdf(), aux


def _predict_f(params: GPEParams, X, y, Xs, covstrat, full_cov: bool, blockindpred):
    """(mean, variance or covariance, ok) of the latent predictive; ok the
    train covariance's factorization flag."""
    pd = gpe_factorize(params, X, covstrat)
    r = y - params.mean.mean(X)
    alpha = pd.solve(r)
    mu_cross, cov = covstrat.predict_mvn(pd, params.kernel, X, r, alpha, Xs, full_cov,
                                         blockindpred)
    return params.mean.mean(Xs) + mu_cross, cov, pd.ok


def gpe_predict_f(params: GPEParams, X, y, Xs, covstrat=FullCovariance(),
                  full_cov: bool = False, blockindpred=None):
    """Posterior predictive of the latent f at Xs, batched.

    blockindpred: padded (idx, mask) tuples (`models.sparse.pad_pred_blocks`)
    assigning test points to FSA training blocks for the cross-Lambda
    correction; only FullScaleApproxStrat accepts it."""
    mu, cov, ok = _predict_f(params, X, y, Xs, covstrat, full_cov, blockindpred)
    require_pd(ok, "the predictive's train covariance")
    return mu, cov


def value_and_grad(target, sub, full0, flags, params, X, y, covstrat):
    """(target, its gradient in sub) of `target(params, X, y, covstrat)[0]`
    at the flat parameters `sub` of the blocks `flags` selects, the others
    taken from `full0` (flags None: sub is the whole flat vector)."""
    with torch.enable_grad():
        sub = sub.detach().requires_grad_()
        vec = sub if flags is None else _embed(full0, sub, params.block_slices(), flags)
        t = target(params.with_flat_params(vec), X, y, covstrat)[0]
        (g,) = torch.autograd.grad(t, sub)
    return t.detach(), g


def _gpe_value_and_grad(*args):
    """The GPE target's `value_and_grad`, as the CUDA graphs capture it."""
    return value_and_grad(gpe_target, *args)


def _gpe_objective(*args):
    """The optimizer's objective: -target and its gradient."""
    t, g = value_and_grad(gpe_target, *args)
    return -t, -g


# ---------------------------------------------------------------------------
# Stateful user-facing wrapper
# ---------------------------------------------------------------------------


def _device(device, model: str = "GPE") -> torch.device:
    """The model's device: the card unless the caller names another."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{model} runs on the CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return device


def _as_X(x, dtype=None, device=None):
    """(n, d) contiguous tensor; a float input keeps its dtype."""
    t = torch.as_tensor(x)
    if dtype is None:
        dtype = t.dtype if t.is_floating_point() else torch.get_default_dtype()
    t = t.to(dtype=dtype, device=device)
    if t.ndim == 1:
        t = t[:, None]
    return t.contiguous()


def _embed(full, sub, slices, flags):
    """`full` with the flagged blocks taken, in order, from `sub`."""
    parts, i = [], 0
    for flag, s in zip(flags, slices):
        if flag:
            m = s.stop - s.start
            parts.append(sub[i : i + m])
            i += m
        else:
            parts.append(full[s])
    return torch.cat(parts)


def _mvn_draws(mu, cov, n_samples, generator):
    """mu + U sqrt(max(w, 0)) z for cov = U diag(w) U^T: exact for a PSD cov,
    robust for a slightly indefinite f32 one."""
    with torch.no_grad():
        w, U = torch.linalg.eigh(cov)
        scale = torch.sqrt(torch.clamp(w, min=0.0))
        z = torch.randn((cov.shape[0], n_samples), generator=generator, dtype=cov.dtype,
                        device=cov.device)
        out = mu[:, None] + U @ (scale[:, None] * z)
    return out[:, 0] if n_samples == 1 else out


class GPE:
    """Exact GP regression model: `mll`, `target`, `target_and_dtarget`,
    `dtarget`, `predict_f`, `predict_y`, `fit`, `push`, `optimize`.

    lognoise is the log observation noise std; pass a vector for
    heteroscedastic noise. `device` defaults to the CUDA device and raises
    when there is none; the parameters move to the data's float dtype and
    to `device`."""

    def __init__(self, x, y, mean: Mean | None = None,
                 kernel: Kernel | None = None, lognoise=-2.0,
                 covstrat=None, device=None):
        dev = _device(device)
        self.x = _as_X(x, device=dev)
        self.y = torch.as_tensor(y).to(dtype=self.x.dtype, device=dev).reshape(-1)
        mean = mean if mean is not None else MeanZero()
        kernel = kernel if kernel is not None else SEIso(ll=0.0, lsigma=0.0)
        params = GPEParams(lognoise=wrap_param(lognoise), mean=mean, kernel=kernel)
        self.params = params.to(dtype=self.x.dtype, device=dev)
        self.covstrat = covstrat if covstrat is not None else FullCovariance()

    # -- basic accessors ---------------------------------------------------
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
    def lognoise(self):
        return self.params.lognoise.value

    def _tensor(self, v):
        return torch.as_tensor(v).to(dtype=self.dtype, device=self.device)

    # -- targets -----------------------------------------------------------
    @property
    def mll(self):
        with torch.no_grad():
            return gpe_mll(self.params, self.x, self.y, self.covstrat)[0]

    @property
    def target(self):
        """mll + log prior."""
        with torch.no_grad():
            return gpe_target(self.params, self.x, self.y, self.covstrat)[0]

    def target_and_dtarget(self):
        """(target, gradient w.r.t. the flat params): the hot path, one CUDA
        graph on the card, kept for this model."""
        return graphs.run(self, _gpe_value_and_grad, self.params.flat_params().detach(), None,
                          None, self.params, self.x, self.y, self.covstrat)

    @property
    def dtarget(self):
        return self.target_and_dtarget()[1]

    # -- parameter protocol ------------------------------------------------
    def get_params(self, noise=True, domean=True, kern=True):
        vec = self.params.flat_params()
        parts = [vec[s] for flag, s in zip((noise, domean, kern),
                                           self.params.block_slices()) if flag]
        return torch.cat(parts) if parts else vec[:0]

    def set_params(self, hyp, noise=True, domean=True, kern=True):
        hyp = self._tensor(hyp).reshape(-1)
        expected = self.num_params(noise=noise, domean=domean, kern=kern)
        if hyp.shape[0] != expected:
            raise ValueError(
                f"expected {expected} parameters for the selected blocks, "
                f"got {hyp.shape[0]}"
            )
        self.params = self.params.with_flat_params(_embed(
            self.params.flat_params(), hyp, self.params.block_slices(),
            (noise, domean, kern)))
        return self

    def num_params(self, noise=True, domean=True, kern=True):
        return sum((s.stop - s.start)
                   for flag, s in zip((noise, domean, kern), self.params.block_slices())
                   if flag)

    def set_priors(self, *, noise=None, mean=None, kern=None):
        p = self.params
        if noise is not None:
            p = replace(p, lognoise=p.lognoise.set_priors(tuple(noise)))
        if mean is not None:
            p = replace(p, mean=p.mean.set_priors(tuple(mean)))
        if kern is not None:
            p = replace(p, kernel=p.kernel.set_priors(tuple(kern)))
        self.params = p
        return self

    # -- prediction --------------------------------------------------------
    def predict_f(self, xs, full_cov: bool = False, blockindpred=None):
        """Posterior latent predictive (mean, variance or covariance). For an
        FSA model, `blockindpred` (one sequence of test-point indices for
        each training block) turns on the cross-block Lambda_xf correction;
        test points left unassigned are treated as their own blocks. On
        the card one CUDA graph kept for the model at each shape of xs and
        `full_cov`."""
        xs = _as_X(xs, dtype=self.dtype, device=self.device)
        if blockindpred is not None:
            from .sparse import FullScaleApproxStrat, pad_pred_blocks

            if not isinstance(self.covstrat, FullScaleApproxStrat):
                raise TypeError(
                    "blockindpred is only meaningful for the FSA strategy; "
                    f"got {type(self.covstrat).__name__}")
            idx, mask = pad_pred_blocks(blockindpred, xs.shape[0],
                                        self.covstrat.block_idx.shape[0])
            # device tensors made here, outside the graph
            blockindpred = (torch.as_tensor(idx, dtype=torch.int64, device=self.device),
                            torch.as_tensor(mask, dtype=self.dtype, device=self.device))
        with torch.no_grad():
            mu, cov, ok = graphs.run(self, _predict_f, self.params, self.x, self.y, xs,
                                     self.covstrat, full_cov, blockindpred, static="predict_f")
        require_pd(ok, "the predictive's train covariance")
        return mu, cov

    def predict_y(self, xs, full_cov: bool = False):
        """The latent predictive plus observation noise.

        A heteroscedastic (vector-noise) model predicts y only at its
        training locations, where the per-observation noise is defined;
        the check compares host copies of the inputs."""
        xs = _as_X(xs, dtype=self.dtype, device=self.device)
        nv = _noise_var(self.lognoise)
        if self.lognoise.ndim > 0:
            if xs.shape != self.x.shape or not np.array_equal(
                    xs.cpu().numpy(), self.x.cpu().numpy()):
                raise ValueError(
                    "heteroscedastic (vector-noise) predict_y is defined "
                    "only at the training locations (the per-observation "
                    "noise vector); use predict_f at new locations")
        mu, cov = self.predict_f(xs, full_cov=full_cov)
        if full_cov:
            return mu, cov + torch.diag(nv.expand(cov.shape[0]))
        return mu, cov + nv

    def rand(self, xs, n_samples: int = 1, *, from_prior: bool = False,
             generator: torch.Generator | None = None):
        """Latent draws at xs, from the posterior (or the prior when
        `from_prior` or there is no data), through eigh with the spectrum
        clamped at 0: in f32 the posterior covariance can be slightly
        indefinite. `generator` lives on the model's device; its draws differ
        from `jax.random`'s."""
        xs = _as_X(xs, dtype=self.dtype, device=self.device)
        if from_prior or self.nobs == 0:
            with torch.no_grad():
                mu, cov = self.params.mean.mean(xs), self.params.kernel.gram(xs)
        else:
            mu, cov = self.predict_f(xs, full_cov=True)
        return _mvn_draws(mu, cov, n_samples, generator)

    # -- data updates ------------------------------------------------------
    def fit(self, x, y):
        """Replace the data."""
        self.x = _as_X(x, dtype=self.dtype, device=self.device)
        self.y = self._tensor(y).reshape(-1)
        return self

    def push(self, x, y):
        """Append observations by refitting."""
        x = _as_X(x, dtype=self.dtype, device=self.device)
        y = self._tensor(y).reshape(-1)
        if self.nobs == 0:
            return self.fit(x, y)
        if x.shape[1] != self.dim:
            raise ValueError("inconsistent input dimension")
        return self.fit(torch.cat([self.x, x]), torch.cat([self.y, y]))

    # -- objective plumbing for the optimizer -------------------------------
    def block_flag_names(self):
        return ("noise", "domean", "kern")

    def _block_plumbing(self, flags):
        """(embed, x0, blocks) over the selected parameter blocks: embed(sub)
        is the full flat vector with those blocks taken from sub."""
        full0 = self.params.flat_params().detach()
        sls = self.params.block_slices()
        active = [(n, s) for n, s, f in zip(self.block_flag_names(), sls, flags) if f]

        def embed(sub):
            return _embed(full0, sub, sls, flags)

        x0 = torch.cat([full0[s] for _, s in active]) if active else full0[:0]
        blocks = [(n, s.stop - s.start) for n, s in active]
        return embed, x0, blocks

    def make_logprob(self, noise=True, domean=True, kern=True, *,
                     include_priors=True):
        """Log target over the selected blocks: (logprob, x0, embed, blocks)."""
        embed, x0, blocks = self._block_plumbing((noise, domean, kern))
        base, X, y, cs = self.params, self.x, self.y, self.covstrat

        def logprob(sub):
            p = base.with_flat_params(embed(sub))
            if include_priors:
                return gpe_target(p, X, y, cs)[0]
            return gpe_mll(p, X, y, cs)[0]

        return logprob, x0, embed, blocks

    def make_objective(self, noise=True, domean=True, kern=True):
        """(vg, x0, embed, blocks) where vg(sub) = (-logprob, its gradient)
        over the selected blocks, one CUDA graph on the card (a
        `graphs.Bound`)."""
        flags = (noise, domean, kern)
        embed, x0, blocks = self._block_plumbing(flags)
        vg = graphs.Bound(self, _gpe_objective, self.params.flat_params().detach(), flags,
                          self.params, self.x, self.y, self.covstrat)
        return vg, x0, embed, blocks

    def optimize(self, **kwargs):
        from ..inference.optimize import optimize

        return optimize(self, **kwargs)

    def sample_params(self, generator: torch.Generator | None = None):
        """Draw a flat parameter vector from the priors."""
        return self.params.sample_priors(generator)

    def __repr__(self):
        return (
            f"GPE(nobs={self.nobs}, dim={self.dim}, kernel={self.params.kernel!r}, "
            f"mean={self.params.mean!r}, lognoise={self.lognoise}, "
            f"device={self.device})"
        )


def GP(x, y, mean=None, kernel=None, lik=None, lognoise=-2.0, device=None):
    """GPE for Gaussian observations, GPA when a likelihood is given."""
    if lik is not None:
        from .gpa import GPA

        return GPA(x, y, mean, kernel, lik, device=device)
    return GPE(x, y, mean=mean, kernel=kernel, lognoise=lognoise, device=device)


def noise_variance(gp):
    """Observation-noise variance exp(2*lognoise): scalar, or a vector for
    heteroscedastic models."""
    return _noise_var(gp.lognoise)
