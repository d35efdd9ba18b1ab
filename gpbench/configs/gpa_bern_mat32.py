"""Configuration gpa_bern_mat32: its data, made from the run's generator,
and the program under test, the package's `GPA` (probit `BernLik`,
Matern 3/2 ARD, Normal priors on the kernel's parameters), float32, on
the card, with its split HMC sampler and its optimizer."""
from __future__ import annotations

import numpy as np
import torch

from gpbench import port

__all__ = ["make_data", "Program"]


def make_data(cfg: dict, n: int, gen: torch.Generator):
    """(X (n, d), y (n,) in {0, 1}) in float32 on the generator's device."""
    dev = gen.device
    X = torch.randn((n, cfg["d"]), generator=gen, dtype=torch.float32, device=dev)
    z = torch.randn((n,), generator=gen, dtype=torch.float32, device=dev)
    y = (torch.sin(X[:, 0]) + 0.5 * X[:, 1] + 0.3 * z > 0).to(torch.float32)
    return X, y


class Program:
    """The package's GPA on (X, y): `fit` from a start, `sweep` of the
    split sampler."""

    def __init__(self, cfg: dict, X: torch.Tensor, y: torch.Tensor):
        import gaussianprocesses_jl_tpu_torch as gp
        from gaussianprocesses_jl_tpu_torch.utils.priors import Normal

        d = cfg["d"]
        self.cfg = cfg
        self.model = gp.GPA(X, y, gp.MeanZero(), gp.Matern(1.5, np.zeros(d), 0.0), gp.BernLik(),
                            device=X.device)
        self.model.set_priors(kern=[Normal(*cfg["kernel_prior"])] * (d + 1))
        self._split = None

    def fit(self, x0: torch.Tensor, maxiter: int, iterates: list | None = None):
        """optimize(method='optax') from x0: (the parameters it ends at, as
        float64 on the host; iterations; evaluations). `iterates`, if a
        list, gets the iterates x_k of the loop as it runs them."""
        self.model.set_params(x0)
        with port.lbfgs_iterates(iterates):
            res = self.model.optimize(method="optax", maxiter=maxiter)
        return torch.as_tensor(np.asarray(res.x, dtype=np.float64)), res.n_iter, int(
            res.message.split()[0])

    def sweep(self, a: torch.Tensor, b: torch.Tensor, gen: torch.Generator, n_iter: int):
        """`n_iter` outer iterations of split HMC from (a (C, n), b (C, d + 1)):
        (draws (C, n_iter a_iters, n + d + 1), final state (C, n + d + 1),
        block A's accept rate a chain)."""
        from gaussianprocesses_jl_tpu_torch.inference.split import split_hmc

        if self._split is None:  # one target, so its graphs are kept and replayed
            self._split = self.model.make_split_logprob()[:3]
        s = self.cfg["sampler"]
        res = split_hmc(*self._split, a, b, gen, n_iter=n_iter, a_iters=s["a_iters"],
                        eps_a=s["eps_a"], eps_b=s["eps_b"], Lmin=s["Lmin"], Lmax=s["Lmax"])
        return res.samples, res.final, res.accept_rate_a
