"""Mean-field variational inference for GPA models (counterpart of
`gaussianprocesses_jl_tpu/inference/vi.py`).

Q(f) = N(m, diag(v)) over the latent function values, fitted to the ELBO

  ELBO = 1/2 [ sum log v_i - logdet K - tr(K^-1 diag v)
               - (m-mu)^T K^-1 (m-mu) + n ] + E_Q[log p(y|f)]

with the kernel's hyperparameters held fixed: K + nugget is factorized once
per `vi` call, and each step is elementwise work and two triangular solves
with a vector. theta = [m; rho] with v = exp(2 rho). The predictive is the
variational conditional mu* = m* + A (m - mu), S* = K** - A (K - diag v) A^T,
A = K*x K^-1, as in the JAX package.

Two methods: "lbfgs" (scipy L-BFGS-B on the host, a non-finite value read
as 1e100) and "adam" (`adam_update`, optax's `adam` written out, so in f64
its iterates follow the JAX package's step for step). On the card the
value and gradient of the L-BFGS-B route, and the whole Adam step (value,
gradient and update), replay CUDA graphs (`utils/graphs.py`) kept for the
fit's objective: the counterparts of the JAX package's jitted
`value_and_grad` and `step`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.gpa import gpa_nugget
from ..models.gpe import _as_X
from ..ops.linalg import require_pd, solve_lower
from ..utils import graphs

__all__ = ["Approx", "elbo", "vi", "make_neg_elbo", "vi_predict_f", "vi_predict_y",
           "adam_update", "adam_init", "adam_step", "adam"]


@dataclass
class Approx:
    """Variational posterior Q = N(m, diag(v))."""

    m: torch.Tensor  # (n,)
    v: torch.Tensor  # (n,) marginal variances


def _prior_factor(gp, nugget=None):
    """The latent prior K + nugget (`gpa_nugget(dtype)` unless given),
    factorized at the current kernel parameters, and the prior mean at the
    data. Raises ValueError when the factorization fails: the fit would be
    of K = I (the JAX package fits it silently)."""
    nugget = gpa_nugget(gp.dtype) if nugget is None else nugget
    pd = gp.covstrat.build(gp.params.kernel, nugget, gp.x)
    require_pd(pd.ok, "VI's prior K + nugget")
    return pd, gp.params.mean.mean(gp.x)


def _diag_Kinv(pd):
    Linv = solve_lower(pd.L, torch.eye(pd.L.shape[0], dtype=pd.L.dtype, device=pd.L.device))
    return torch.sum(Linv * Linv, dim=0)


def _prior_pieces(gp, nugget=None):
    """(pd, mu, diag(K^-1)) of the latent prior."""
    pd, mu = _prior_factor(gp, nugget)
    return pd, mu, _diag_Kinv(pd)


def _neg_elbo(pd, mu, diag_Kinv, lik, y, m, v, sum_log_v):
    n = m.shape[0]
    kl_terms = sum_log_v - pd.logdet() - torch.dot(v, diag_Kinv) - pd.quad(m - mu) + n
    return -(0.5 * kl_terms + lik.var_exp(y, m, v))


def elbo(gp, m, v):
    """Evidence lower bound at Q = N(m, diag(v))."""
    m = gp._tensor(m)
    v = gp._tensor(v)
    with torch.no_grad():
        pd, mu, diag_Kinv = _prior_pieces(gp)
        return -_neg_elbo(pd, mu, diag_Kinv, gp.params.lik, gp.y, m, v, torch.sum(torch.log(v)))


def make_neg_elbo(gp, nugget=None):
    """(neg_elbo(theta), theta0, n) with theta = [m; rho], v = exp(2 rho),
    started at the prior: m = mu, v = diag(K). The prior's factor is built
    here, once, outside autograd, with `nugget` on K (`gpa_nugget(dtype)`,
    the one `vi` fits with, unless given)."""
    with torch.no_grad():
        pd, mu, diag_Kinv = _prior_pieces(gp, nugget)
        v0 = torch.clamp(gp.params.kernel.diag(gp.x), min=1e-8)
        theta0 = torch.cat([mu, 0.5 * torch.log(v0)])
    lik, y, n = gp.params.lik, gp.y, mu.shape[0]

    def neg_elbo(theta):
        m, rho = theta[:n], theta[n:]
        return _neg_elbo(pd, mu, diag_Kinv, lik, y, m, torch.exp(2.0 * rho),
                         2.0 * torch.sum(rho))

    return neg_elbo, theta0, n


def _value_and_grad(objective, theta):
    with torch.enable_grad():
        theta = theta.detach().requires_grad_()
        val = objective(theta)
        (g,) = torch.autograd.grad(val, theta)
    return val.detach(), g


def adam_update(theta, g, m, v, t, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """One step of `optax.adam(lr)` from the gradient g: the moments m and v
    and the step count t (a tensor of theta's dtype) in, (theta', m', v',
    t') out, the bias corrections as optax writes them."""
    m = (1 - b1) * g + b1 * m
    v = (1 - b2) * g ** 2 + b2 * v
    t = t + 1
    update = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
    return theta + (-lr) * update, m, v, t


def _adam_step(objective, lr, theta, m, v, t):
    val, g = _value_and_grad(objective, theta)
    return (*adam_update(theta, g, m, v, t, lr), val)


def adam_init(theta0) -> tuple:
    """Adam's state at theta0: (theta, m, v, t), the moments and t zero."""
    theta = theta0.detach()
    return theta, torch.zeros_like(theta), torch.zeros_like(theta), theta.new_zeros(())


def adam_step(objective, state: tuple, lr: float) -> tuple:
    """(state', value): one Adam step on objective(theta) from `state`
    (`adam_init`), value the objective at the step's start. On the card one
    CUDA graph kept for `objective`."""
    *state, val = graphs.run(objective, lambda *a: _adam_step(objective, lr, *a), *state,
                             static=("adam", lr))
    return tuple(state), val


def adam(objective, theta0, nits: int, lr: float):
    """`nits` Adam steps on objective(theta) from theta0: (theta, values),
    values (nits,) the objective at each step's start; the step's graph is
    captured once and replayed `nits` times."""
    state, values = adam_init(theta0), []
    for _ in range(nits):
        state, val = adam_step(objective, state, lr)
        values.append(val)
    return state[0], torch.stack(values) if values else state[0].new_zeros(0)


def vi(gp, nits: int = 100, method: str = "lbfgs", lr: float = 0.05,
       verbose: bool = False) -> Approx:
    """Fit the mean-field approximation; returns Approx(m, v) and leaves the
    model untouched (its hyperparameters are held fixed)."""
    neg_elbo, theta0, n = make_neg_elbo(gp)

    if method == "lbfgs":
        from scipy.optimize import minimize

        def fun(x):
            val, g = graphs.run(neg_elbo, lambda th: _value_and_grad(neg_elbo, th),
                                torch.as_tensor(x).to(theta0), static="value_and_grad")
            val = float(val)
            return (np.float64(val) if np.isfinite(val) else 1e100,
                    g.cpu().numpy().astype(np.float64))

        out = minimize(fun, theta0.cpu().numpy().astype(np.float64), jac=True,
                       method="L-BFGS-B", options={"maxiter": nits})
        theta = torch.as_tensor(out.x).to(theta0)
        if verbose:
            print(f"vi: {out.nit} iterations, elbo={-float(out.fun):.4f}")
    elif method == "adam":
        theta, values = adam(neg_elbo, theta0, nits, lr)
        if verbose:
            print(f"vi: {nits} adam steps, elbo={-float(values[-1]):.4f}")
    else:
        raise ValueError(f"unknown vi method {method!r}")

    return Approx(m=theta[:n], v=torch.exp(2.0 * theta[n:]))


def vi_predict_f(gp, Q: Approx, xs, full_cov: bool = False, nugget=None):
    """Variational posterior predictive of the latent f at xs:
    mu* = m(xs) + Kxs^T K^-1 (Q.m - mu), S* = K** - W^T W + A^T diag(Q.v) A
    with W = L^-1 Kxs, A = K^-1 Kxs; `nugget` on K as in `make_neg_elbo`."""
    xs = _as_X(xs, dtype=gp.dtype, device=gp.device)
    kern = gp.params.kernel
    with torch.no_grad():
        pd, mu = _prior_factor(gp, nugget)
        Kxs = kern.gram(gp.x, xs)  # (n, ns)
        W = pd.whiten(Kxs)
        A_r = pd.solve(Kxs)
        mu_s = gp.params.mean.mean(xs) + Kxs.T @ pd.solve(Q.m - mu)
        if full_cov:
            return mu_s, kern.gram(xs) - W.T @ W + A_r.T @ (Q.v[:, None] * A_r)
        var = (kern.diag(xs) - torch.sum(W * W, dim=0)
               + torch.sum(A_r * (Q.v[:, None] * A_r), dim=0))
        return mu_s, torch.clamp(var, min=0.0)


def vi_predict_y(gp, Q: Approx, xs):
    """Observation-space predictive through the likelihood's predict_obs."""
    mu, var = vi_predict_f(gp, Q, xs)
    with torch.no_grad():
        return gp.params.lik.predict_obs(mu, var)
