"""Elliptical slice sampling over a batch of chains (counterpart of
`gaussianprocesses_jl_tpu/inference/ess.py`; Murray, Adams & MacKay 2010).

Reference semantics kept: hyperparameters only, every prior Normal (the
joint ellipse); the slice likelihood is the marginal log likelihood without
the prior; a non-finite value counts as -inf.

The angle bracket's shrink loop runs over the batch with a per-chain "done"
mask: each round evaluates every chain's proposal in one batched call and
reads one flag back to the host (whether any chain is still shrinking), none
per chain. It stops when every chain is done or at `_MAX_SHRINK` rounds;
a chain that hits the cap keeps its current state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from .hmc import RandomStream, as_stream

__all__ = ["ess", "ESSResult", "ess_iteration"]

_MAX_SHRINK = 200


@dataclass
class ESSResult:
    samples: torch.Tensor  # (n_iter, D), or (C, n_iter, D)
    mean_proposals: torch.Tensor  # average shrink proposals an iteration, () or (C,)
    final: torch.Tensor  # (D,) or (C, D)
    final_loglik: torch.Tensor  # the log likelihood at the final state, () or (C,)


def _safe(ll):
    return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -math.inf))


def ess_iteration(ll_fn: Callable, f, ll_f, prior_mu, prior_sigma, stream: RandomStream):
    """One elliptical-slice iteration of every chain: f (C, D) the states,
    ll_f (C,) their safe log likelihoods, `ll_fn` the batched log
    likelihood. Returns (f', ll_f', proposals (C,))."""
    C, D = f.shape
    z, u, theta = stream.ess_start(C, D, f)
    nu = prior_sigma * z
    logy = ll_f + torch.log(u)
    tmin, tmax = theta - 2.0 * math.pi, theta

    def propose(th):
        return (f - prior_mu) * torch.cos(th)[:, None] + nu * torch.sin(th)[:, None] + prior_mu

    fp = propose(theta)
    llp = _safe(ll_fn(fp))
    it = torch.zeros(C, dtype=torch.int64, device=f.device)
    active = llp <= logy
    for _ in range(_MAX_SHRINK):
        if not bool(active.any()):
            break
        tmin = torch.where(active & (theta < 0), theta, tmin)
        tmax = torch.where(active & (theta >= 0), theta, tmax)
        theta = torch.where(active, stream.ess_shrink(C, f) * (tmax - tmin) + tmin, theta)
        fp = torch.where(active[:, None], propose(theta), fp)
        llp = torch.where(active, _safe(ll_fn(fp)), llp)
        it = it + active
        active = active & (llp <= logy) & (it < _MAX_SHRINK)
    # a chain that hit the cap (numerically stuck) keeps its current state
    stuck = it >= _MAX_SHRINK
    return (torch.where(stuck[:, None], f, fp), torch.where(stuck, ll_f, llp), it + 1)


def ess(loglik_fn: Callable, theta0, prior_mu, prior_sigma, generator=None,
        n_iter: int = 1000) -> ESSResult:
    """ESS over a per-chain `loglik_fn` with independent Normal priors
    N(prior_mu, prior_sigma^2) per coordinate, from theta0 (D,) for one
    chain or (C, D) for C chains at once. `generator`: a torch.Generator on
    theta0's device, or a RandomStream."""
    single = theta0.ndim == 1
    f = (theta0[None] if single else theta0).detach()
    C, D = f.shape
    prior_mu = torch.as_tensor(prior_mu, dtype=f.dtype, device=f.device)
    prior_sigma = torch.as_tensor(prior_sigma, dtype=f.dtype, device=f.device)
    stream = as_stream(generator, f)
    ll_fn = torch.func.vmap(loglik_fn)
    with torch.no_grad():
        ll_f = _safe(ll_fn(f))
        samples = f.new_empty((C, n_iter, D))
        props = torch.zeros(C, dtype=torch.int64, device=f.device)
        for i in range(n_iter):
            f, ll_f, p = ess_iteration(ll_fn, f, ll_f, prior_mu, prior_sigma, stream)
            samples[:, i] = f
            props += p
    mean_props = props.to(torch.float32) / n_iter
    if single:
        return ESSResult(samples[0], mean_props[0], f[0], ll_f[0])
    return ESSResult(samples, mean_props, f, ll_f)
