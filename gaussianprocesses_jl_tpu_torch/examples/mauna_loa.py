"""Mauna Loa CO2: an exact GPE with the reference notebook's composite
kernel SE(4,4) + Periodic(0,1,0) * SE(4,0) + RQ(0,0,-1) + SE(-2,-2) (the
JAX repo's `examples/mauna_loa.py`). It reads `examples/data/CO2_data.csv`
where the repository holds it, and otherwise makes the JAX example's
synthetic trend + seasonal series of the same shape.

    python -m gaussianprocesses_jl_tpu_torch.examples.mauna_loa [--device cpu] [--maxiter 200]
"""
import sys
import time

import numpy as np

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.examples import DATA_DIR, parser

__all__ = ["CSV", "load_data", "kernel", "model", "run", "main"]

CSV = DATA_DIR / "CO2_data.csv"


def load_data():
    """(year, co2): the CSV's columns, or monthly 1958.2-2008 synthetic."""
    if CSV.exists():
        data = np.loadtxt(CSV, delimiter=",")
        return data[:, 0], data[:, 1]
    t = np.arange(1958.2, 2008.0, 1.0 / 12)
    co2 = (315 + 1.5 * (t - 1958) + 0.013 * (t - 1958) ** 2
           + 3 * np.sin(2 * np.pi * t + 0.3)
           + 0.3 * np.random.RandomState(0).randn(len(t)))
    return t, co2


def kernel(g=gp):
    """The composite kernel, built from the package `g` (the port by
    default; a test passes the JAX package to build its twin)."""
    return (g.SE(4.0, 4.0) + g.Periodic(0.0, 1.0, 0.0) * g.SE(4.0, 0.0)
            + g.RQ(0.0, 0.0, -1.0) + g.SE(-2.0, -2.0))


def model(device, dtype=np.float64):
    """(the GPE on the centred series before 2004, lognoise -2, zero mean;
    the train mask; the train mean)."""
    year, co2 = load_data()
    train = year < 2004
    ymean = co2[train].mean()
    m = gp.GPE(year[train].astype(dtype), (co2[train] - ymean).astype(dtype), gp.MeanZero(),
               kernel(), lognoise=-2.0, device=device)
    return m, train, ymean


def run(device, dtype=np.float64, method: str = "lbfgs", maxiter: int = 200,
        verbose: bool = True) -> dict:
    """The fit by `optimize(method=method)` (scipy's L-BFGS-B for "lbfgs",
    optax's L-BFGS for "optax") from the notebook's start, and the 2004+
    forecast's rmse."""
    say = print if verbose else (lambda *a: None)
    year, co2 = load_data()
    m, train, ymean = model(device, dtype)
    ytest = co2[~train]
    mll0 = float(m.mll)
    say(f"initial mll: {mll0:.2f}")
    t0 = time.perf_counter()
    res = m.optimize(method=method, maxiter=maxiter)
    secs = time.perf_counter() - t0
    mll = float(m.mll)
    say(f"optimized mll: {mll:.2f}")
    mu, _ = m.predict_y(year[~train].astype(dtype))
    mu = mu.cpu().numpy() + ymean
    rmse = float(np.sqrt(np.mean((mu - ytest) ** 2)))
    say(f"forecast 2004+ rmse: {rmse:.3f} ppm "
        f"(data range {ytest.min():.1f}..{ytest.max():.1f})")
    return {"method": method, "mll0": mll0, "mll": mll, "n_iter": res.n_iter,
            "s": secs, "rmse": rmse}


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--maxiter", type=int, default=200)
    args = p.parse_args(argv)
    return run(args.device, maxiter=args.maxiter)


if __name__ == "__main__":
    main(sys.argv[1:])
