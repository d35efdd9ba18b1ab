"""Configuration fitc_se_n100k: its data, drawn as the JAX package's
`bench_fitc100k` draws them, the choice of its inducing rows, and the
program under test, the package's `FITC` (a `GPE` on the sparse strategy)
with an isotropic SE kernel, float32, on the card."""
from __future__ import annotations

import numpy as np
import torch

from gpbench import port

__all__ = ["draw", "inducing_rows", "make_data", "Program"]


def draw(cfg: dict, n: int):
    """(X (n, d) float32, y (n,) float32, the inducing rows' indices (m,)) as
    numpy arrays, from RandomState(data_seed) in the bench's order."""
    rng = np.random.RandomState(cfg["data_seed"])
    X = rng.randn(n, cfg["d"]).astype(np.float32)
    noise = rng.randn(n)
    y = (np.sin(X[:, 0]) + 0.5 * np.cos(X[:, 1]) + cfg["data"]["noise_std"] * noise).astype(
        np.float32)
    return X, y, rng.choice(n, cfg["m"], replace=False)


def inducing_rows(cfg: dict, n: int) -> np.ndarray:
    """The indices of the m rows of X that are the inducing inputs: the
    program and the reference both take them from here."""
    return draw(cfg, n)[2]


def make_data(cfg: dict, n: int, gen: torch.Generator):
    """(X (n, d), y (n,)) in float32 on the generator's device; the data come
    from `data_seed`, not from the generator."""
    X, y, _ = draw(cfg, n)
    return torch.from_numpy(X).to(gen.device), torch.from_numpy(y).to(gen.device)


class Program:
    """The package's FITC on (X, y), its inducing rows fixed: `fit` from a
    start."""

    def __init__(self, cfg: dict, X: torch.Tensor, y: torch.Tensor):
        import gaussianprocesses_jl_tpu_torch as gp

        rows = torch.from_numpy(inducing_rows(cfg, X.shape[0])).to(X.device)
        self.model = gp.FITC(X, X[rows], y, kernel=gp.SE(0.0, 0.0), lognoise=0.0,
                             device=X.device)

    def fit(self, x0: torch.Tensor, maxiter: int, iterates: list | None = None):
        """optimize(method='optax') from x0 over the three hyperparameters:
        (the parameters it ends at, as float64 on the host; iterations;
        evaluations). `iterates`, if a list, gets the iterates x_k of the
        loop as it runs them."""
        self.model.set_params(x0)
        with port.lbfgs_iterates(iterates):
            res = self.model.optimize(method="optax", maxiter=maxiter)
        return torch.as_tensor(np.asarray(res.x, dtype=np.float64)), res.n_iter, int(
            res.message.split()[0])
