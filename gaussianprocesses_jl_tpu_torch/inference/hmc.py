"""Hamiltonian Monte Carlo over a batch of chains (counterpart of
`gaussianprocesses_jl_tpu/inference/hmc.py`).

The JAX package writes one chain and `vmap`s it. Here the target is still
written for one chain, and `batched_value_and_grad` batches it with
`torch.func.vmap(torch.func.grad_and_value(...))`: one call evaluates every
chain, so the kernels under it launch once for all of them. The sampler's
own loop is plain PyTorch over (C, D) tensors, with the JAX package's
fixed-Lmax leapfrog masked per chain for the randomized path length; it
reads nothing back to the host. On the card one transition of every chain
(all Lmax leapfrog steps) is one CUDA graph (`utils/graphs.py`), the
counterpart of the JAX package's leapfrog `lax.scan`; its draws are made
outside the graph, from the same generator in the same order.

Reference semantics kept: path length L ~ U{Lmin..Lmax} and step size eps;
a proposal whose endpoint target is non-finite is rejected; the sample
matrix holds the current state at every iteration. The "glide" through
non-finite points is the JAX package's deliberate departure from the
reference (see `hmc_transition`).

Random numbers come from a `RandomStream` over one `torch.Generator` on the
chains' device. They differ from `jax.random`'s; the tests replay the JAX
package's draws through a stream of their own and compare the deterministic
core `hmc_transition` exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..utils import graphs

__all__ = ["hmc", "HMCResult", "RandomStream", "as_stream", "batched_value_and_grad", "start",
           "hmc_transition", "hmc_iteration"]


@dataclass
class HMCResult:
    samples: torch.Tensor  # (n_iter, D), or (C, n_iter, D) for a batch of chains
    accept_rate: torch.Tensor  # () or (C,)
    final: torch.Tensor  # (D,) or (C, D)
    final_target: torch.Tensor  # () or (C,)


class RandomStream:
    """Every random number of a sampler, drawn from one `torch.Generator`
    on the chains' device (`like`, a tensor, gives the dtype and device)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape, like):
        return torch.randn(shape, generator=self.generator, dtype=like.dtype, device=like.device)

    def uniform(self, shape, like):
        return torch.rand(shape, generator=self.generator, dtype=like.dtype, device=like.device)

    def hmc(self, C, D, Lmin, Lmax, like):
        """(z (C, D) standard normal, L (C,) uniform on Lmin..Lmax, u (C,)
        uniform on [0, 1)) for one HMC transition of C chains."""
        z = self.normal((C, D), like)
        L = torch.randint(Lmin, Lmax + 1, (C,), generator=self.generator, device=like.device)
        return z, L, self.uniform((C,), like)

    def ess_start(self, C, D, like):
        """(z (C, D) standard normal, u (C,), angle (C,) uniform on
        [0, 2 pi)) for one elliptical-slice iteration."""
        z = self.normal((C, D), like)
        u = self.uniform((C,), like)
        return z, u, 2.0 * torch.pi * self.uniform((C,), like)

    def ess_shrink_block(self, R, C, like):
        """(R, C) uniforms for a block of R shrink rounds of the angle
        bracket, row r for round r."""
        return self.uniform((R, C), like)


def as_stream(generator, like) -> RandomStream:
    """A RandomStream: `generator` itself if it is one, a stream over it if it
    is a torch.Generator, over a new generator seeded 0 on `like`'s device
    if it is None."""
    if isinstance(generator, RandomStream):
        return generator
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(0)
    return RandomStream(generator)


def batched_value_and_grad(logprob: Callable, *rest_dims):
    """vg(theta (C, D), *rest) -> (target (C,), gradient (C, D)) of a
    per-chain log target `logprob(theta, *rest)`, batched over chains with
    torch.func; `rest_dims` are vmap's in_dims of the extra arguments
    (0: per chain, None: shared). `vg.__wrapped__` is `logprob`: the
    samplers' CUDA graphs of vg are kept for it."""
    gv = torch.func.vmap(torch.func.grad_and_value(logprob), in_dims=(0, *rest_dims))

    def vg(theta, *rest):
        g, t = gv(theta, *rest)
        return t, g

    vg.__wrapped__ = logprob
    return vg


def _owner(vg: Callable):
    """What the graphs of `vg` are kept for: the log target it wraps, so a
    second run of the same target replays them; else vg itself."""
    return getattr(vg, "__wrapped__", vg)


def _finite0(g):
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def _like(x, theta):
    return torch.as_tensor(x, dtype=theta.dtype, device=theta.device)


def _col(x, theta):
    """A step size, scalar or one a chain (C,), shaped to multiply (C, D)."""
    x = _like(x, theta)
    return x[:, None] if x.ndim == 1 else x


def start(vg: Callable, theta, rest=()):
    """(target (C,), gradient (C, D)) of `vg(theta, *rest)` at a chain's
    start, a non-finite gradient set to 0 (a -inf start, say from a failed
    f32 Cholesky, would freeze the chain; 0 lets it reach finite
    proposals). On the card one CUDA graph, kept for `_owner(vg)`."""

    def fn(th, *r):
        t, g = vg(th, *r)
        return t, _finite0(g)

    return graphs.run(_owner(vg), fn, theta, *rest, static="start")


def hmc_transition(vg: Callable, theta, tgt, grad, nu0, L, log_u, eps, Lmax: int, minv=None,
                   rest=()):
    """One HMC transition of every chain from given draws: the deterministic
    core of `hmc_iteration` (the body of the reference's iteration loop).

    theta (C, D), tgt (C,), grad (C, D) the current states; nu0 (C, D) the
    momenta, drawn N(0, M); L (C,) the path lengths in 1..Lmax; log_u (C,)
    the log uniforms of the accept tests; eps a scalar or (C,); `minv` the
    diagonal inverse mass matrix M^-1 (None: the identity). Positions move
    by eps M^-1 nu; the kinetic energy is nu^T M^-1 nu / 2.

    `rest`: further arguments of every `vg(theta, *rest)` call.

    Returns (theta', tgt', grad', accept_prob, accepted). The leapfrog runs
    a fixed Lmax steps, each masked per chain beyond its L. Non-finite
    targets: the trajectory glides through points whose target or gradient
    is non-finite (the force is 0 there, a function of position alone, so
    the integrator stays reversible and volume-preserving) and the accept
    test uses the true target at the endpoint, so a proposal ending at -inf
    is rejected. Only a non-finite position (overflowed momenta) freezes the
    chain and rejects. This is the JAX package's deliberate departure from
    the reference, which rejects any trajectory that touches a non-finite
    point: both are exact (the test sees true endpoint targets), but the
    glide can tunnel across a forbidden region."""
    eps = _col(eps, theta)
    minv = torch.ones_like(theta[0]) if minv is None else _like(minv, theta)
    nu = nu0 + 0.5 * eps * grad
    th, g, t = theta, grad, tgt
    bad = torch.isnan(theta.sum(-1))
    for step in range(Lmax):
        active = (step < L) & ~bad
        th_n = th + eps * minv * nu
        t_n, g_n = vg(th_n, *rest)
        # the force: the gradient where finite, 0 elsewhere (glide)
        g_eff = _finite0(g_n)
        fin = torch.isfinite(th_n).all(-1)
        bad = torch.where(active, ~fin, bad)
        use = active & fin
        th = torch.where(use[:, None], th_n, th)
        g = torch.where(use[:, None], g_eff, g)
        # the TRUE target at the current position (may be -inf mid-path; the
        # accept test sees only the endpoint's)
        t = torch.where(use, t_n, t)
        nu = torch.where(use[:, None], nu + eps * g_eff, nu)
    nu = nu - 0.5 * eps * g
    kin = 0.5 * torch.sum(nu * minv * nu, dim=-1)
    kin0 = 0.5 * torch.sum(nu0 * minv * nu0, dim=-1)
    log_alpha = t - kin - tgt + kin0
    # an endpoint with a non-finite target is never accepted, and a NaN
    # log_alpha (-inf - -inf) does not poison the accept statistic that
    # drives step-size adaptation
    ok_end = torch.isfinite(t) & ~bad
    zero = torch.zeros_like(log_alpha)
    accept_prob = torch.where(ok_end, torch.exp(torch.clamp(log_alpha, max=0.0)), zero)
    accept_prob = torch.where(torch.isnan(accept_prob), zero, accept_prob)
    accepted = (log_u < log_alpha) & ok_end
    return (torch.where(accepted[:, None], th, theta), torch.where(accepted, t, tgt),
            torch.where(accepted[:, None], g, grad), accept_prob, accepted)


def hmc_iteration(vg: Callable, theta, tgt, grad, stream: RandomStream, eps, Lmin: int,
                  Lmax: int, minv=None, rest=()):
    """One HMC transition of every chain, its momenta, path lengths and
    accept uniforms drawn from `stream`. On the card the transition is one
    CUDA graph, kept for `_owner(vg)` and Lmax, its inputs the states, the
    draws, eps, M^-1 and `rest`."""
    C, D = theta.shape
    z, L, u = stream.hmc(C, D, Lmin, Lmax, theta)
    if minv is not None:
        minv = _like(minv, theta)
    nu0 = z if minv is None else z / torch.sqrt(minv)

    def fn(th, t, g, nu, L_, log_u, eps_, minv_, *r):
        return hmc_transition(vg, th, t, g, nu, L_, log_u, eps_, Lmax, minv_, r)

    return graphs.run(_owner(vg), fn, theta, tgt, grad, nu0, L, torch.log(u), _like(eps, theta),
                      minv, *rest, static=("transition", Lmax))


def hmc(logprob_fn: Callable, theta0, generator=None, n_iter: int = 1000, eps: float = 0.1,
        Lmin: int = 5, Lmax: int = 15, minv=None) -> HMCResult:
    """HMC on a per-chain log target from theta0: (D,) for one chain, (C, D)
    for C chains at once.

    logprob_fn: (D,) -> scalar log target (may be -inf or NaN on bad
    regions). generator: a torch.Generator on theta0's device, or a
    RandomStream. Returns all n_iter states (burn and thin are slicing
    afterwards). On the card the start and every transition replay CUDA
    graphs kept for `logprob_fn`."""
    single = theta0.ndim == 1
    theta = (theta0[None] if single else theta0).detach()
    C, D = theta.shape
    stream = as_stream(generator, theta)
    vg = batched_value_and_grad(logprob_fn)
    eps = _like(eps, theta)
    with torch.no_grad():
        t, g = start(vg, theta)
        samples = theta.new_empty((C, n_iter, D))
        acc = torch.zeros(C, dtype=torch.int64, device=theta.device)
        for i in range(n_iter):
            theta, t, g, _, accepted = hmc_iteration(vg, theta, t, g, stream, eps, Lmin, Lmax,
                                                     minv)
            acc += accepted
            samples[:, i] = theta
    rate = acc.to(theta.dtype) / n_iter
    if single:
        return HMCResult(samples[0], rate[0], theta[0], t[0])
    return HMCResult(samples, rate, theta, t)
