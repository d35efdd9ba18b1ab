"""One outer iteration of split HMC over a batch of chains, plainly.

The latent probit GP's target splits into block A, the whitened latents v
(the factor of K is fixed while they move), and block B, the kernel's
hyperparameters (every step refactors K). An outer iteration makes
`a_iters` HMC updates of A against the factor at the current B, then one
HMC update of B. Each update draws, in this order, the momenta z (C, D)
standard normal, the path lengths L (C,) uniform on Lmin..Lmax and the
accept uniforms u (C,), from the sampler's torch.Generator in the
configuration's precision; the leapfrog takes a half step of momentum,
then L full steps (a fixed Lmax, each masked for the chains past their
own L), then takes the half step back. A step whose gradient is not
finite moves with zero force; a non-finite position stops the chain and
rejects; the proposal is accepted when log u < H(start) - H(end) and the
end's target is finite. Each update also returns its accept test's margin,
H(start) - H(end) - log u (infinite where the end or the path is not
finite, which rejects whatever the rounding).
"""
from __future__ import annotations

import torch

from .gp import gpa_factor, gpa_target, value_and_grad

__all__ = ["draws", "skip", "transition", "outer_iteration"]


def draws(gen: torch.Generator, C: int, D: int, Lmin: int, Lmax: int, dtype):
    """(z, L, u) of one update of C chains in D dimensions."""
    dev = gen.device
    z = torch.randn((C, D), generator=gen, dtype=dtype, device=dev)
    L = torch.randint(Lmin, Lmax + 1, (C,), generator=gen, device=dev)
    return z, L, torch.rand((C,), generator=gen, dtype=dtype, device=dev)


def skip(gen: torch.Generator, C: int, Da: int, Db: int, cfg: dict, iterations: int) -> None:
    """Advance the generator past the draws of `iterations` outer
    iterations of C chains (blocks of Da and Db dimensions)."""
    s = cfg["sampler"]
    for _ in range(iterations):
        for D in [Da] * s["a_iters"] + [Db]:
            draws(gen, C, D, s["Lmin"], s["Lmax"], _draw_dtype(cfg))


def _finite0(g):
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def transition(vg, theta, z, L, u, eps: float, Lmax: int):
    """One HMC update of every chain from theta (C, D): (theta', accepted,
    the accept test's margin)."""
    tgt, grad = vg(theta)
    grad = _finite0(grad)
    nu0 = z.to(theta.dtype)
    log_u = torch.log(u.to(theta.dtype))
    nu = nu0 + 0.5 * eps * grad
    th, g, t = theta, grad, tgt
    bad = torch.zeros(theta.shape[0], dtype=torch.bool, device=theta.device)
    for step in range(Lmax):
        active = (step < L) & ~bad
        th_n = th + eps * nu
        t_n, g_n = vg(th_n)
        g_n = _finite0(g_n)
        fin = torch.isfinite(th_n).all(-1)
        bad = torch.where(active, ~fin, bad)
        use = active & fin
        th = torch.where(use[:, None], th_n, th)
        g = torch.where(use[:, None], g_n, g)
        t = torch.where(use, t_n, t)
        nu = torch.where(use[:, None], nu + eps * g_n, nu)
    nu = nu - 0.5 * eps * g
    log_alpha = t - 0.5 * torch.sum(nu * nu, -1) - tgt + 0.5 * torch.sum(nu0 * nu0, -1)
    clear = torch.isfinite(t) & ~bad
    accepted = (log_u < log_alpha) & clear
    margin = torch.where(clear & torch.isfinite(log_alpha), log_alpha - log_u,
                         torch.full_like(log_alpha, torch.inf))
    return torch.where(accepted[:, None], th, theta), accepted, margin


def outer_iteration(a, b, gen, X, y, cfg: dict, mode: str, given_a=None, perturb=None):
    """One outer iteration from (a (C, n), b (C, d + 1)): (a after each A
    update (a_iters, C, n), b after the B update, the accept flags and the
    accept tests' margins (a_iters + 1, C)). With `given_a` (a_iters, C, n), the states another
    sampler reached, each update starts from that sampler's state before it
    (the A updates from a, then given_a[0], ...; the B update from
    given_a[-1]) and not from this one's own. `perturb` (`gp.gpa_factor`'s)
    acts on every matrix factored: A's one factor, and B's at each
    evaluation."""
    s = cfg["sampler"]
    dtype = a.dtype
    prior = cfg["kernel_prior"]
    C, Da = a.shape
    with torch.no_grad():
        factor = gpa_factor(b, X, cfg["nugget"], mode, perturb)

    def vg_a(v):
        return value_and_grad(lambda v1: gpa_target(v1, b, X, y, cfg["nugget"], prior, mode,
                                                    factor), v)

    out, acc, margins = [], [], []
    cur = a
    for j in range(s["a_iters"]):
        z, L, u = draws(gen, C, Da, s["Lmin"], s["Lmax"], _draw_dtype(cfg))
        new, ok, margin = transition(vg_a, cur, z, L, u, s["eps_a"], s["Lmax"])
        out.append(new)
        acc.append(ok)
        margins.append(margin)
        cur = new if given_a is None else given_a[j].to(dtype)

    def vg_b(h):
        return value_and_grad(lambda h1: gpa_target(cur, h1, X, y, cfg["nugget"], prior, mode,
                                                    perturb=perturb), h)

    z, L, u = draws(gen, C, b.shape[1], s["Lmin"], s["Lmax"], _draw_dtype(cfg))
    b_new, ok, margin = transition(vg_b, b, z, L, u, s["eps_b"], s["Lmax"])
    acc.append(ok)
    margins.append(margin)
    return torch.stack(out), b_new, torch.stack(acc), torch.stack(margins)


def _draw_dtype(cfg):
    return {"float32": torch.float32, "float64": torch.float64}[cfg["precision"]]
