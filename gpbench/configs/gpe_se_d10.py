"""Configuration gpe_se_d10: its data, made from the run's generator, and
the program under test, the package's exact `GPE` with an isotropic SE
kernel, float32, on the card."""
from __future__ import annotations

import numpy as np
import torch

from gpbench import port

__all__ = ["make_data", "Program"]


def make_data(cfg: dict, n: int, gen: torch.Generator):
    """(X (n, d), y (n,)) in float32 on the generator's device."""
    dev = gen.device
    X = torch.randn((n, cfg["d"]), generator=gen, dtype=torch.float32, device=dev)
    f = (torch.sin(X[:, 0] + X[:, 1]) + 0.5 * torch.cos(X[:, 2] - X[:, 3]) + 0.25 * X[:, 4])
    noise = torch.randn((n,), generator=gen, dtype=torch.float32, device=dev)
    return X, f + cfg["data"]["noise_std"] * noise


class Program:
    """The package's GPE on (X, y): `fit` from a start."""

    def __init__(self, cfg: dict, X: torch.Tensor, y: torch.Tensor):
        import gaussianprocesses_jl_tpu_torch as gp

        self.model = gp.GPE(X, y, gp.MeanZero(), gp.SE(0.0, 0.0), lognoise=0.0,
                            device=X.device)

    def fit(self, x0: torch.Tensor, maxiter: int, iterates: list | None = None):
        """optimize(method='optax') from x0: (the parameters it ends at, as
        float64 on the host; iterations; evaluations). `iterates`, if a
        list, gets the iterates x_k of the loop as it runs them."""
        self.model.set_params(x0)
        with port.lbfgs_iterates(iterates):
            res = self.model.optimize(method="optax", maxiter=maxiter)
        return torch.as_tensor(np.asarray(res.x, dtype=np.float64)), res.n_iter, int(
            res.message.split()[0])
