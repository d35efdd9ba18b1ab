"""Sharded variational inference (counterpart of
`gaussianprocesses_jl_tpu/parallel/vi.py`).

Two axes of scale over a mesh:

  * `sharded_vi`: R restarts of the mean-field fit, each process running
    its R/P rows of one (R, 2n) batch of [m; rho] under one Adam
    (`inference/vi.adam`, optax's update; on the card one CUDA graph a
    step, no collective in it). Each step
    evaluates the rows' objectives one row at a time, so a row's
    arithmetic is `vi`'s to the bit and the host's work grows with R/P
    (a `torch.func.vmap` over the rows batches the solves and changes
    their last bits). Restart 0 starts at
    `vi`'s start; the others jitter it by `jitter` N(0, I). The rows are
    independent, so the summed objective's gradient is each restart's own
    gradient. The best restart by final ELBO wins.
  * `sharded_elbo_fn` / `sharded_vi_train`: the observation-sharded ELBO.
    The per-observation terms (the variational expectations, sum log v and
    v . diag(K^-1)) run on this process's observations and are psum'd; the
    coupled terms (logdet K and the K^-1 quadratic form) stay replicated
    against the prior's factor. m and v enter the local terms through
    `copy`, so every process ends with the whole gradient of the ELBO.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from ..inference.vi import Approx, _prior_pieces, adam, make_neg_elbo
from ..utils import graphs
from .collectives import copy, gather_, psum

__all__ = ["sharded_vi", "ShardedVIResult", "sharded_elbo_fn", "sharded_elbo",
           "sharded_vi_train", "ShardedVITrainResult"]


@dataclass
class ShardedVIResult:
    approx: Approx  # the best restart's Q = N(m, diag v)
    elbo: float  # its final ELBO
    elbos: torch.Tensor  # (R,) final ELBO of each restart
    best: int  # the winning restart


def _start_noise(seed, R: int, like: torch.Tensor) -> torch.Tensor:
    """(R, D) standard-normal draws: from a torch.Generator on `like`'s
    device seeded with `seed`, or `seed(R, D)` where it is a function (a
    test replays the JAX package's keys through it)."""
    D = like.shape[0]
    if callable(seed):
        return torch.as_tensor(seed(R, D)).to(like)
    gen = torch.Generator(device=like.device).manual_seed(int(seed))
    return torch.randn((R, D), generator=gen, dtype=like.dtype, device=like.device)


def sharded_vi(gp, mesh, *, axis: str = "chains", restarts: int | None = None,
               nits: int = 200, lr: float = 0.05, jitter: float = 0.3,
               seed=0) -> ShardedVIResult:
    """Multi-restart mean-field VI over `mesh` axis `axis`: R restarts (the
    axis size by default; R must divide by it), `nits` Adam steps each, on
    the replicated full-batch objective. Every process draws the whole (R,
    2n) block of starts and keeps its rows. Returns the best restart.

    This scales the restarts; `sharded_vi_train` scales the observations."""
    neg_elbo, theta0, n = make_neg_elbo(gp)
    P_ = mesh.shape[axis]
    R = restarts if restarts is not None else P_
    if R % P_:
        raise ValueError(f"{R} restarts not divisible by {P_} processes")
    scale = torch.full((R, 1), float(jitter), dtype=theta0.dtype, device=theta0.device)
    scale[0] = 0.0
    starts = theta0[None, :] + scale * _start_noise(seed, R, theta0)
    r = R // P_
    me = mesh.coords[axis]

    def objective(theta):
        return sum(neg_elbo(theta[i]) for i in range(r))

    theta, _ = adam(objective, starts[me * r:(me + 1) * r], nits, lr)
    with torch.no_grad():
        final = -torch.stack([neg_elbo(theta[i]) for i in range(r)])
    thetas = gather_(theta, mesh, axis)
    elbos = gather_(final, mesh, axis)
    best = int(torch.argmax(elbos))
    th = thetas[best]
    return ShardedVIResult(approx=Approx(m=th[:n], v=torch.exp(2.0 * th[n:])),
                           elbo=float(elbos[best]), elbos=elbos, best=best)


def _make_sharded_elbo(gp, mesh, axis: str = "data"):
    """(elbo(m, v), mu, n): the observation-sharded ELBO at the model's
    current hyperparameters, its prior factored here once."""
    with torch.no_grad():
        pd, mu, diag_Kinv = _prior_pieces(gp)
    y, lik = gp.y, gp.params.lik
    n = mu.shape[0]
    P_ = mesh.shape[axis]
    if n % P_:
        raise ValueError(f"n={n} observations not divisible by {P_} processes on axis "
                         f"{axis!r}; pad the data or pick a dividing axis size")
    k = n // P_
    rows = slice(mesh.coords[axis] * k, (mesh.coords[axis] + 1) * k)
    y_loc, dki_loc = y[rows], diag_Kinv[rows]

    def elbo_fn(m, v):
        coupled = 0.5 * (-pd.logdet() - pd.quad(m - mu) + n)
        m_loc, v_loc = copy(m, mesh, axis)[rows], copy(v, mesh, axis)[rows]
        local = (lik.var_exp(y_loc, m_loc, v_loc)
                 + 0.5 * (torch.sum(torch.log(v_loc)) - torch.dot(v_loc, dki_loc)))
        return coupled + psum(local, mesh, axis)

    return elbo_fn, mu, n


def sharded_elbo_fn(gp, mesh, axis: str = "data"):
    """The observation-sharded `elbo(m, v)` of `gp` at its current
    hyperparameters: the per-observation pieces on this process's
    observations, psum'd over `axis`, the coupled pieces replicated. Equals
    `inference.vi.elbo` to reduction-order rounding, in value and gradient
    (differentiable in m and v). n must divide by the axis size."""
    return _make_sharded_elbo(gp, mesh, axis)[0]


def sharded_elbo(gp, m, v, mesh, axis: str = "data"):
    """The observation-sharded ELBO's value at (m, v)."""
    fn = sharded_elbo_fn(gp, mesh, axis)
    with torch.no_grad():
        return fn(gp._tensor(m), gp._tensor(v))


@dataclass
class ShardedVITrainResult:
    approx: Approx  # the fitted Q = N(m, diag v)
    elbo: float  # the final ELBO (sharded objective)
    elbo_trace: torch.Tensor  # (nits,) the ELBO at each Adam step's start


def sharded_vi_train(gp, mesh, *, axis: str = "data", nits: int = 200, lr: float = 0.05,
                     theta0=None) -> ShardedVITrainResult:
    """Mean-field VI by Adam on the observation-sharded ELBO: each step
    evaluates the sharded objective and its gradient, every process doing
    only its observations' share of the per-observation work, forward and
    backward. From the same start it follows the replicated
    `vi(method="adam")` to reduction-order rounding. At P = 1 on the card
    each step replays the CUDA graph of `inference/vi.adam`; at P > 1 it
    runs eagerly (`graphs.eager()`: no collective under capture).

    theta0: an optional (2n,) start [m; rho]; by default the prior's, as in
    `vi` (m = mu, v = diag K)."""
    elbo_fn, mu, n = _make_sharded_elbo(gp, mesh, axis)
    if theta0 is None:
        with torch.no_grad():
            v0 = torch.clamp(gp.params.kernel.diag(gp.x), min=1e-8)
            theta0 = torch.cat([mu, 0.5 * torch.log(v0)])

    def neg_elbo(theta):
        return -elbo_fn(theta[:n], torch.exp(2.0 * theta[n:]))

    with graphs.eager() if mesh.shape[axis] > 1 else contextlib.nullcontext():
        theta, values = adam(neg_elbo, gp._tensor(theta0), nits, lr)
    m, v = theta[:n], torch.exp(2.0 * theta[n:])
    with torch.no_grad():
        final = float(elbo_fn(m, v))
    return ShardedVITrainResult(approx=Approx(m=m, v=v), elbo=final, elbo_trace=-values)
