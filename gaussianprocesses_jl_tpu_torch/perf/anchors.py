"""The notebook anchors of the JAX package's `tests/test_notebook_parity.py`,
rebuilt in the port from the examples' own seeds and sizes (the examples'
synthetic data, as they make it when the notebooks' CSVs are absent).

Each function runs one anchor's model through the port on `device` and
returns its numbers; the thresholds are the parity tests' and stand beside
each function as constants, checked by `chip_smoke.py` on the card. The
tests run the same functions on the CPU at a few iterations.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal

__all__ = ["robust_regression", "poisson", "mauna_loa_data", "mauna_loa_kernel", "mauna_loa",
           "sparse_golden", "regression", "ROBUST_RMSE_T", "POISSON_CORR", "POISSON_GAP",
           "MAUNA_LOA_RMSE", "SPARSE_GOLDEN"]

# examples/robust_regression.py: rmse_t < rmse_g and rmse_t < 0.15
ROBUST_RMSE_T = 0.15
# examples/poisson_regression.py: both correlations > 0.5, |c_m - c_v| < 0.15
POISSON_CORR, POISSON_GAP = 0.5, 0.15
# examples/mauna_loa.py: the 2004+ forecast's rmse < 3.5 ppm
MAUNA_LOA_RMSE = 3.5
# the sparse notebook test's golden mlls (N = 1000, 12 inducing points,
# lognoise -0.3, f64), held at abs 1e-3
SPARSE_GOLDEN = {"exact": -871.2615224318861, "SoR": -871.2615035337278,
                 "DTC": -871.2615035337278, "FITC": -871.2615489920295,
                 "FSA": -871.2615636292248}


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def robust_regression(device, n_iter=500, dtype=np.float64) -> dict:
    """Student-t GPA (HMC, eps 0.03) against a Gaussian GPE (L-BFGS-B, 100
    iterations) on 60 noisy sine points with every eighth moved by +-4:
    the latent means' rmse from the true sine."""
    rng = np.random.RandomState(1)
    n = 60
    x = np.sort(2 * np.pi * rng.rand(n))
    f = np.sin(x)
    y = f + 0.15 * rng.randn(n)
    y[::8] += rng.choice([-4.0, 4.0], size=len(y[::8]))
    x, y = x.astype(dtype), y.astype(dtype)

    gpe = gp.GPE(x, y, kernel=gp.SE(0.0, 0.0), lognoise=-1.0, device=device)
    gpe.optimize(maxiter=100)
    mu_g, _ = gpe.predict_f(x)
    m = gp.GPA(x, y, gp.MeanZero(), gp.SE(0.0, 0.0), gp.StuTLik(lsigma=-1.0, nu=3),
               device=device)
    res = gp.mcmc(m, _gen(device, 0), n_iter=n_iter, eps=0.03, burn=n_iter // 5,
                  verbose=False)
    mu_t, _ = m.predict_f(x)
    return {"rmse_g": _rmse(mu_g.cpu(), f), "rmse_t": _rmse(mu_t.cpu(), f),
            "accept": float(res.accept_rate), "finite": bool(torch.isfinite(mu_t).all())}


def poisson(device, n_iter=500, vi_iters=300, dtype=np.float64) -> dict:
    """Poisson GPA on the synthetic counts (50 points): HMC (eps 0.05), then
    mean-field VI (L-BFGS-B) at the hyperparameters HMC left; each rate's
    correlation with the counts."""
    rng = np.random.RandomState(3)
    t = np.linspace(0, 10, 50)
    y = rng.poisson(np.exp(1.2 + 0.8 * np.sin(t))).astype(float)
    X = ((t - t.mean()) / t.std())[:, None].astype(dtype)
    m = gp.GPA(X, y.astype(dtype), gp.MeanZero(), gp.Matern(1.5, 0.0, 0.0), gp.PoisLik(),
               device=device)
    res = gp.mcmc(m, _gen(device, 0), n_iter=n_iter, eps=0.05, burn=n_iter // 5,
                  verbose=False)
    mu_mcmc, _ = m.predict_y(X)
    Q = gp.vi(m, nits=vi_iters)
    mu_vi, _ = gp.vi_predict_y(m, Q, X)
    c_m = float(np.corrcoef(mu_mcmc.cpu().numpy(), y)[0, 1])
    c_v = float(np.corrcoef(mu_vi.cpu().numpy(), y)[0, 1])
    return {"corr_mcmc": c_m, "corr_vi": c_v, "accept": float(res.accept_rate),
            "elbo": float(gp.elbo(m, Q.m, Q.v)),
            "finite": bool(torch.isfinite(mu_vi).all() and torch.isfinite(mu_mcmc).all())}


def mauna_loa_data():
    """examples/mauna_loa.py's synthetic CO2 series: monthly 1958.2-2008."""
    t = np.arange(1958.2, 2008.0, 1.0 / 12)
    co2 = (315 + 1.5 * (t - 1958) + 0.013 * (t - 1958) ** 2
           + 3 * np.sin(2 * np.pi * t + 0.3)
           + 0.3 * np.random.RandomState(0).randn(len(t)))
    return t, co2


def mauna_loa_kernel(g):
    return (g.SE(4.0, 4.0) + g.Periodic(0.0, 1.0, 0.0) * g.SE(4.0, 0.0)
            + g.RQ(0.0, 0.0, -1.0) + g.SE(-2.0, -2.0))


def mauna_loa(device, method="lbfgs", maxiter=200, dtype=np.float64) -> dict:
    """The composite kernel fitted to the series before 2004 (zero mean on
    the centred series, lognoise -2) and the forecast's rmse after it."""
    year, co2 = mauna_loa_data()
    train = year < 2004
    ymean = co2[train].mean()
    m = gp.GPE(year[train].astype(dtype), (co2[train] - ymean).astype(dtype), gp.MeanZero(),
               mauna_loa_kernel(gp), lognoise=-2.0, device=device)
    mll0 = float(m.mll)
    t0 = time.perf_counter()
    res = m.optimize(method=method, maxiter=maxiter)
    secs = time.perf_counter() - t0
    mu, _ = m.predict_y(year[~train].astype(dtype))
    return {"method": method, "mll0": mll0, "mll": float(m.mll), "n_iter": res.n_iter,
            "s": secs, "rmse": _rmse(mu.cpu().numpy() + ymean, co2[~train])}


def sparse_golden(device, dtype=np.float64) -> dict:
    """The exact GP and SoR, DTC, FITC and FSA (10 blocks of 100) at N = 1000
    on the notebook test's data: each mll, and whether all stand within
    1e-3 of SPARSE_GOLDEN."""
    rng = np.random.RandomState(1)
    n = 1000
    x = (2 * np.pi * rng.rand(n)).astype(dtype)
    y = (np.sin(x) + 0.5 * rng.randn(n)).astype(dtype)
    ind = np.linspace(0, 2 * np.pi, 12).astype(dtype)
    blocks = [list(range(i, min(i + 100, n))) for i in range(0, n, 100)]
    kw = dict(kernel=gp.SE(0.3, 0.1), lognoise=-0.3, device=device)
    models = {"exact": gp.GPE(x, y, **kw), "SoR": gp.SoR(x, ind, y, **kw),
              "DTC": gp.DTC(x, ind, y, **kw), "FITC": gp.FITC(x, ind, y, **kw),
              "FSA": gp.FSA(x, ind, blocks, y, **kw)}
    mlls = {k: float(m.mll) for k, m in models.items()}
    return {"mll": mlls,
            "within": all(abs(v - SPARSE_GOLDEN[k]) <= 1e-3 for k, v in mlls.items())}


def regression(device, n_iter=500, dtype=np.float64) -> dict:
    """The regression quickstart: an ML fit (L-BFGS-B), then HMC and
    elliptical slice sampling over the hyperparameters under Normal priors;
    the posterior means of both samplers."""
    rng = np.random.RandomState(0)
    n = 40
    x = 2 * np.pi * rng.rand(n)
    y = np.sin(x) + 0.05 * rng.randn(n)
    m = gp.GPE(x.astype(dtype), y.astype(dtype), gp.MeanZero(), gp.SE(0.0, 0.0),
               lognoise=-1.0, device=device)
    m.optimize()
    mll = float(m.mll)
    m.set_priors(noise=[Normal(-2.0, 2.0)], kern=[Normal(0.0, 2.0), Normal(0.0, 2.0)])
    hmc = gp.mcmc(m, _gen(device, 0), n_iter=n_iter, burn=n_iter // 5, verbose=False)
    es = gp.ess(m, _gen(device, 1), n_iter=n_iter, burn=n_iter // 5, verbose=False)
    hmc_mean, ess_mean = hmc.samples.mean(0), es.samples.mean(0)
    return {"mll": mll, "hmc_mean": hmc_mean.tolist(), "ess_mean": ess_mean.tolist(),
            "accept": float(hmc.accept_rate),
            "finite": bool(np.isfinite(mll) and torch.isfinite(hmc_mean).all()
                           and torch.isfinite(ess_mean).all())}

