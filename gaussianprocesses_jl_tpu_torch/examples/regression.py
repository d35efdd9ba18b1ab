"""1-D regression quickstart: an exact GPE with an SE kernel, an ML fit,
then HMC and elliptical slice sampling over the hyperparameters (the JAX
repo's `examples/regression.py`).

    python -m gaussianprocesses_jl_tpu_torch.examples.regression [--device cpu] [--n-iter 500]
"""
import sys

import numpy as np

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.examples import generator, parser
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal

__all__ = ["data", "model", "set_priors", "run", "main"]


def data():
    """(x, y): 40 points of sin(x) + 0.05 noise, RandomState(0)."""
    rng = np.random.RandomState(0)
    n = 40
    x = 2 * np.pi * rng.rand(n)
    return x, np.sin(x) + 0.05 * rng.randn(n)


def model(device, dtype=np.float64):
    x, y = data()
    return gp.GPE(x.astype(dtype), y.astype(dtype), gp.MeanZero(), gp.SE(0.0, 0.0),
                  lognoise=-1.0, device=device)


def set_priors(m) -> None:
    m.set_priors(noise=[Normal(-2.0, 2.0)], kern=[Normal(0.0, 2.0), Normal(0.0, 2.0)])


def run(device, dtype=np.float64, n_iter: int = 500, verbose: bool = True) -> dict:
    """The ML fit (L-BFGS-B), then HMC (seed 0) and elliptical slice
    sampling (seed 1) under Normal priors, `n_iter` draws each (a fifth
    burnt): the fit's mll and parameters and both posterior means."""
    say = print if verbose else (lambda *a: None)
    m = model(device, dtype)
    m.optimize()
    mll, params = float(m.mll), m.get_params().cpu().numpy()
    say(f"ML fit: mll = {mll:.2f}, params = {params.round(3)}")

    set_priors(m)
    hmc = gp.mcmc(m, generator(device, 0), n_iter=n_iter, burn=n_iter // 5, verbose=verbose)
    hmc_mean = hmc.samples.mean(0).cpu().numpy()
    say(f"HMC posterior mean params: {hmc_mean.round(3)}")
    es = gp.ess(m, generator(device, 1), n_iter=n_iter, burn=n_iter // 5, verbose=verbose)
    ess_mean = es.samples.mean(0).cpu().numpy()
    say(f"ESS posterior mean params: {ess_mean.round(3)}")
    return {"mll": mll, "params": params.tolist(), "hmc_mean": hmc_mean.tolist(),
            "ess_mean": ess_mean.tolist(), "accept": float(hmc.accept_rate),
            "finite": bool(np.isfinite([mll, *hmc_mean, *ess_mean]).all())}


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n-iter", type=int, default=500)
    args = p.parse_args(argv)
    return run(args.device, n_iter=args.n_iter)


if __name__ == "__main__":
    main(sys.argv[1:])
