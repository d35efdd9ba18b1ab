"""The plain reference of configuration gpa_bern_mat32, and its control:
the same reference in the program's place, in TF32."""
from __future__ import annotations

import torch

from . import lbfgs
from .gp import gpa_target, value_and_grad
from .precision import dtype_of
from .split_hmc import outer_iteration, skip

__all__ = ["objective", "outer_iteration", "skip", "Control"]


def objective(cfg: dict, X, y, mode: str):
    """theta = [v; ll; lsigma] -> (-log target, its gradient)."""
    dt = dtype_of(mode)
    X, y = X.to(dt), y.to(dt)
    n = X.shape[0]
    prior = cfg["kernel_prior"]

    def neg(theta):
        return -gpa_target(theta[None, :n], theta[None, n:], X, y, cfg["nugget"], prior, mode)[0]

    return lambda theta: value_and_grad(neg, theta.to(dt))


class Control:
    """The reference in the program's place, computed in TF32."""

    mode = "tf32"

    def __init__(self, cfg: dict, X, y):
        self.cfg, self.X, self.y = cfg, X, y
        self.vg = objective(cfg, X, y, self.mode)

    def fit(self, x0, maxiter: int, iterates: list | None = None):
        x, n_iter, evaluations = lbfgs.minimize(self.vg, x0.to(torch.float32), maxiter,
                                                trace=iterates)
        return x.double().cpu(), n_iter, evaluations

    def sweep(self, a, b, gen, n_iter: int):
        k = self.cfg["sampler"]["a_iters"]
        X, y = self.X.float(), self.y.float()
        rows, acc = [], []
        for _ in range(n_iter):
            b_cur = b  # each draw holds the b its A update ran against
            steps, b, ok, _ = outer_iteration(a, b_cur, gen, X, y, self.cfg, self.mode)
            a = steps[-1]
            rows.append(torch.cat([steps, b_cur[None].expand(k, -1, -1)], -1).transpose(0, 1))
            acc.append(ok[:-1].float().mean(0))
        return torch.cat(rows, 1), torch.cat([a, b], -1), torch.stack(acc).mean(0)
