"""Robust regression with outliers: a Student-t GPA sampled by HMC against
a Gaussian GPE fitted by L-BFGS-B (the JAX repo's
`examples/robust_regression.py`).

    python -m gaussianprocesses_jl_tpu_torch.examples.robust_regression [--device cpu] [--n-iter 500]
"""
import sys

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.examples import generator, parser

__all__ = ["data", "gaussian_model", "student_t_model", "rmse", "run", "main"]


def data():
    """(x, f, y): 60 sorted points, f = sin(x), y = f + 0.15 noise with
    every eighth point moved by +-4, RandomState(1)."""
    rng = np.random.RandomState(1)
    n = 60
    x = np.sort(2 * np.pi * rng.rand(n))
    f = np.sin(x)
    y = f + 0.15 * rng.randn(n)
    y[::8] += rng.choice([-4.0, 4.0], size=len(y[::8]))
    return x, f, y


def gaussian_model(device, dtype=np.float64):
    x, _, y = data()
    return gp.GPE(x.astype(dtype), y.astype(dtype), kernel=gp.SE(0.0, 0.0), lognoise=-1.0,
                  device=device)


def student_t_model(device, dtype=np.float64):
    x, _, y = data()
    return gp.GPA(x.astype(dtype), y.astype(dtype), gp.MeanZero(), gp.SE(0.0, 0.0),
                  gp.StuTLik(lsigma=-1.0, nu=3), device=device)


def rmse(mu, f) -> float:
    return float(np.sqrt(np.mean((np.asarray(mu) - f) ** 2)))


def run(device, dtype=np.float64, n_iter: int = 500, verbose: bool = True) -> dict:
    """The Gaussian GPE fitted by L-BFGS-B (100 iterations) and the
    Student-t GPA sampled by HMC (eps 0.03, seed 0, `n_iter` draws, a fifth
    burnt): each latent mean's rmse from the true sine."""
    x, f, _ = data()
    gpe = gaussian_model(device, dtype)
    gpe.optimize(maxiter=100)
    mu_g, _ = gpe.predict_f(x.astype(dtype))
    m = student_t_model(device, dtype)
    res = gp.mcmc(m, generator(device, 0), n_iter=n_iter, eps=0.03, burn=n_iter // 5,
                  verbose=verbose)
    mu_t, _ = m.predict_f(x.astype(dtype))
    rmse_g, rmse_t = rmse(mu_g.cpu(), f), rmse(mu_t.cpu(), f)
    if verbose:
        print(f"rmse vs truth — gaussian GPE: {rmse_g:.3f}, student-t GPA: {rmse_t:.3f}")
    return {"rmse_g": rmse_g, "rmse_t": rmse_t, "accept": float(res.accept_rate),
            "finite": bool(torch.isfinite(mu_t).all())}


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n-iter", type=int, default=500)
    args = p.parse_args(argv)
    return run(args.device, n_iter=args.n_iter)


if __name__ == "__main__":
    main(sys.argv[1:])
