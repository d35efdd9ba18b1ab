"""The plain reference of configuration gpe_se_d10, and its control: the
same reference in the program's place, in TF32."""
from __future__ import annotations

import torch

from . import lbfgs
from .gp import gpe_nll, value_and_grad
from .precision import dtype_of

__all__ = ["objective", "Control"]


def objective(cfg: dict, X, y, mode: str):
    """theta -> (-log marginal likelihood, its gradient)."""
    dt = dtype_of(mode)
    X, y = X.to(dt), y.to(dt)
    return lambda theta: value_and_grad(lambda t: gpe_nll(t, X, y, mode), theta.to(dt))


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
