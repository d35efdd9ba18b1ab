"""Elliptical slice sampling over a batch of chains (counterpart of
`gaussianprocesses_jl_tpu/inference/ess.py`; Murray, Adams & MacKay 2010).

Reference semantics kept: hyperparameters only, every prior Normal (the
joint ellipse); the slice likelihood is the marginal log likelihood without
the prior; a non-finite value counts as -inf.

The angle bracket's shrink loop (the JAX package's `lax.while_loop`) runs
over the batch with a per-chain "active" mask, in blocks of `rounds` rounds:
a masked round leaves a chain that is done as it was, so a block runs
a fixed number of rounds whatever the chains need. After each block the
host reads one flag, whether any chain is still shrinking, and runs another
block while one is and fewer than `_MAX_SHRINK` rounds have run; a chain
that hits the cap keeps its current state. The uniforms of a block's
rounds are drawn before it, as one (rounds, C) block; round r of the block
reads row r, so chain c's k-th shrink uniform is the same whichever block
holds it and whichever process holds the chain.

On the card the iteration's start with its first block, and every later
block, replay two CUDA graphs (`utils/graphs.py`) kept for the log
likelihood, the counterpart of the JAX package's jitted loop; their draws
are made outside them. `graphs.eager()` runs the same blocks eagerly, on
the same draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..utils import graphs
from .hmc import RandomStream, _owner, as_stream

__all__ = ["ess", "ESSResult", "ess_iteration", "batched_loglik", "SHRINK_BLOCK"]

_MAX_SHRINK = 200
# shrink rounds a block (a graph replay, one host read): the shortest
# iteration of configuration #5 at 1024 chains of R = 1, 4, 8 and 16 on an
# H100 (`perf/student_t_study.py`'s sweep, PERF.md §5)
SHRINK_BLOCK = 4


@dataclass
class ESSResult:
    samples: torch.Tensor  # (n_iter, D), or (C, n_iter, D)
    mean_proposals: torch.Tensor  # average shrink proposals an iteration, () or (C,)
    final: torch.Tensor  # (D,) or (C, D)
    final_loglik: torch.Tensor  # the log likelihood at the final state, () or (C,)


def _safe(ll):
    return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -math.inf))


def batched_loglik(loglik_fn: Callable) -> Callable:
    """ll(theta (C, D)) -> (C,) of a per-chain log likelihood, batched with
    `torch.func.vmap`; its `__wrapped__` is `loglik_fn`, for which the
    sampler's graphs are kept."""
    ll = torch.func.vmap(loglik_fn)
    ll.__wrapped__ = loglik_fn
    return ll


def _propose(f, nu, mu, theta):
    return (f - mu) * torch.cos(theta)[:, None] + nu * torch.sin(theta)[:, None] + mu


def _rounds(ll_fn, f, ll_f, mu, nu, logy, state, U):
    """U.shape[0] masked shrink rounds from `state` = (theta, tmin, tmax,
    fp, llp, it, active), round r on the uniforms U[r] (C,). Returns the
    new state, whether any chain is still active, and the iteration's
    result were it to stop here: (f', ll_f', proposals)."""
    theta, tmin, tmax, fp, llp, it, active = state
    for u in U:
        tmin = torch.where(active & (theta < 0), theta, tmin)
        tmax = torch.where(active & (theta >= 0), theta, tmax)
        theta = torch.where(active, u * (tmax - tmin) + tmin, theta)
        fp = torch.where(active[:, None], _propose(f, nu, mu, theta), fp)
        llp = torch.where(active, _safe(ll_fn(fp)), llp)
        it = it + active
        active = active & (llp <= logy) & (it < _MAX_SHRINK)
    # a chain that hit the cap (numerically stuck) keeps its current state
    stuck = it >= _MAX_SHRINK
    done = (torch.where(stuck[:, None], f, fp), torch.where(stuck, ll_f, llp), it + 1)
    return (theta, tmin, tmax, fp, llp, it, active), active.any(), done


def _start(ll_fn, f, ll_f, mu, sigma, z, u, theta, U):
    """The iteration's start (the ellipse, the slice height, the first
    proposal) and its first block of rounds: (nu, logy, *`_rounds`)."""
    nu = sigma * z
    logy = ll_f + torch.log(u)
    fp = _propose(f, nu, mu, theta)
    llp = _safe(ll_fn(fp))
    it = torch.zeros_like(llp, dtype=torch.int64)
    state = (theta, theta - 2.0 * math.pi, theta, fp, llp, it, llp <= logy)
    return (nu, logy, *_rounds(ll_fn, f, ll_f, mu, nu, logy, state, U))


def ess_iteration(ll_fn: Callable, f, ll_f, prior_mu, prior_sigma, stream: RandomStream,
                  rounds: int = SHRINK_BLOCK):
    """One elliptical-slice iteration of every chain: f (C, D) the states,
    ll_f (C,) their safe log likelihoods, `ll_fn` the batched log likelihood
    (`batched_loglik`). Shrink rounds run in blocks of `rounds`, one host
    read a block. Returns (f', ll_f', proposals (C,))."""
    C, D = f.shape
    z, u, theta = stream.ess_start(C, D, f)
    owner = _owner(ll_fn)
    nu, logy, state, more, done = graphs.run(
        owner, lambda *a: _start(ll_fn, *a), f, ll_f, prior_mu, prior_sigma, z, u, theta,
        stream.ess_shrink_block(rounds, C, f), static=("ess_start", rounds))
    ran = rounds
    while ran < _MAX_SHRINK and bool(more):
        state, more, done = graphs.run(
            owner, lambda *a: _rounds(ll_fn, *a), f, ll_f, prior_mu, nu, logy, state,
            stream.ess_shrink_block(rounds, C, f), static=("ess_rounds", rounds))
        ran += rounds
    return done


def ess(loglik_fn: Callable, theta0, prior_mu, prior_sigma, generator=None,
        n_iter: int = 1000, rounds: int = SHRINK_BLOCK) -> ESSResult:
    """ESS over a per-chain `loglik_fn` with independent Normal priors
    N(prior_mu, prior_sigma^2) per coordinate, from theta0 (D,) for one
    chain or (C, D) for C chains at once. `generator`: a torch.Generator on
    theta0's device, or a RandomStream; `rounds`: shrink rounds a block."""
    single = theta0.ndim == 1
    f = (theta0[None] if single else theta0).detach()
    C, D = f.shape
    prior_mu = torch.as_tensor(prior_mu, dtype=f.dtype, device=f.device)
    prior_sigma = torch.as_tensor(prior_sigma, dtype=f.dtype, device=f.device)
    stream = as_stream(generator, f)
    ll_fn = batched_loglik(loglik_fn)
    with torch.no_grad():
        ll_f = _safe(ll_fn(f))
        samples = f.new_empty((C, n_iter, D))
        props = torch.zeros(C, dtype=torch.int64, device=f.device)
        for i in range(n_iter):
            f, ll_f, p = ess_iteration(ll_fn, f, ll_f, prior_mu, prior_sigma, stream, rounds)
            samples[:, i] = f
            props += p
    mean_props = props.to(torch.float32) / n_iter
    if single:
        return ESSResult(samples[0], mean_props[0], f[0], ll_f[0])
    return ESSResult(samples, mean_props, f, ll_f)
