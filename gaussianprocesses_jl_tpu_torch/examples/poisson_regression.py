"""Poisson regression: a GPA with the exp-link Poisson likelihood, HMC
against mean-field VI (the JAX repo's `examples/poisson_regression.py`). It
reads `examples/data/coal.csv` where the repository holds it, and
otherwise makes the JAX example's synthetic counts. In a job of several
processes (`torchrun`) VI runs as `sharded_vi` (2 restarts a process), and
configuration #3 then trains by `sharded_vi_train` over the observations.

    python -m gaussianprocesses_jl_tpu_torch.examples.poisson_regression [--device cpu]
        [--n-iter 500] [--vi-iters 300]
"""
import sys

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.examples import DATA_DIR, generator, parser, say, world
from gaussianprocesses_jl_tpu_torch.perf import vi_study

__all__ = ["CSV", "load_counts", "model", "run", "sharded_train_demo", "main"]

CSV = DATA_DIR / "coal.csv"


def load_counts():
    """(X (n, 1), counts): the CSV's (year, disasters), or 50 synthetic
    counts of exp(1.2 + 0.8 sin t), RandomState(3)."""
    if CSV.exists():
        data = np.loadtxt(CSV, delimiter=",")
        return data[:, 0:1], data[:, 1].astype(float)
    rng = np.random.RandomState(3)
    t = np.linspace(0, 10, 50)
    return t[:, None], rng.poisson(np.exp(1.2 + 0.8 * np.sin(t))).astype(float)


def model(device, dtype=np.float64):
    """(the GPA on the standardized inputs, Matern 3/2; X; counts)."""
    X, y = load_counts()
    X = ((X - X.mean()) / X.std()).astype(dtype)
    return (gp.GPA(X, y.astype(dtype), gp.MeanZero(), gp.Matern(1.5, 0.0, 0.0), gp.PoisLik(),
                   device=device), X, y)


def sharded_train_demo(device, n_dev: int, nits: int = vi_study.NITS):
    """Configuration #3 (`perf/vi_study.py`'s model, n = 4096) trained by
    Adam on the observation-sharded ELBO over `n_dev` processes: f32 on the
    card; f64 on the CPU, where the f32 plain gram's expansion of r^2 leaves
    the prior unfactorable (vi_study's finding)."""
    dtype = np.float32 if torch.device(device).type == "cuda" else np.float64
    m = vi_study.config3_model(device, dtype)
    n = m.nobs
    mesh = gp.make_mesh({"data": n_dev}, device=device)
    r = gp.sharded_vi_train(m, mesh, nits=nits, lr=vi_study.LR)
    tr = r.elbo_trace.cpu().numpy()
    rate = np.exp(r.approx.m.cpu().numpy() + 0.5 * r.approx.v.cpu().numpy())
    corr = float(np.corrcoef(rate, m.y.cpu().numpy())[0, 1])
    say(f"sharded_vi_train: n={n} over {n_dev} devices, elbo {tr[0]:.1f} -> {r.elbo:.1f} "
          f"in {nits} steps, rate corr {corr:.3f}")
    return r.elbo, corr


def run(device, dtype=np.float64, n_iter: int = 500, vi_iters: int = 300, n_dev: int = 1,
        verbose: bool = True) -> dict:
    """HMC (eps 0.05, seed 0, `n_iter` draws, a fifth burnt), then
    mean-field VI (L-BFGS-B, `vi_iters`; over `n_dev` > 1 processes
    `sharded_vi` with 2 restarts a process) at the hyperparameters HMC
    left: each rate's correlation with the counts and the ELBO."""
    m, X, y = model(device, dtype)
    res = gp.mcmc(m, generator(device, 0), n_iter=n_iter, eps=0.05, burn=n_iter // 5,
                  verbose=verbose)
    mu_mcmc, _ = m.predict_y(X)
    if n_dev > 1:
        mesh = gp.make_mesh({"chains": n_dev}, device=device)
        r = gp.sharded_vi(m, mesh, restarts=2 * n_dev, nits=vi_iters, seed=2)
        Q = r.approx
        if verbose:
            say(f"sharded_vi: {len(r.elbos)} restarts on {n_dev} devices, "
                f"best elbo {r.elbo:.2f} (restart {r.best})")
    else:
        Q = gp.vi(m, nits=vi_iters)
    mu_vi, _ = gp.vi_predict_y(m, Q, X)
    c_m = float(np.corrcoef(mu_mcmc.cpu().numpy(), y)[0, 1])
    c_v = float(np.corrcoef(mu_vi.cpu().numpy(), y)[0, 1])
    elbo = float(gp.elbo(m, Q.m, Q.v))
    if verbose:
        say(f"rate corr with counts — mcmc: {c_m:.3f}, vi: {c_v:.3f}, elbo: {elbo:.2f}")
    return {"corr_mcmc": c_m, "corr_vi": c_v, "accept": float(res.accept_rate), "elbo": elbo,
            "finite": bool(torch.isfinite(mu_vi).all() and torch.isfinite(mu_mcmc).all())}


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n-iter", type=int, default=500)
    p.add_argument("--vi-iters", type=int, default=300)
    args = p.parse_args(argv)
    n_dev = world()
    out = run(args.device, n_iter=args.n_iter, vi_iters=args.vi_iters, n_dev=n_dev)
    if n_dev > 1:
        sharded_train_demo(args.device, n_dev)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
