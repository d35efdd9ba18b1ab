"""Sparse approximations: SoR, DTC, FITC and FSA with 12 inducing points
against the exact GP at N = 1000 (the JAX repo's
`examples/sparse_approximations.py`).

    python -m gaussianprocesses_jl_tpu_torch.examples.sparse_approximations [--device cpu] [--n 1000]
"""
import sys

import numpy as np

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.examples import parser

__all__ = ["data", "models", "run", "main"]

N = 1000


def data(n: int = N):
    """(x, y, inducing points, blocks of 100): RandomState(1)."""
    rng = np.random.RandomState(1)
    x = 2 * np.pi * rng.rand(n)
    y = np.sin(x) + 0.5 * rng.randn(n)
    blocks = [list(range(i, min(i + 100, n))) for i in range(0, n, 100)]
    return x, y, np.linspace(0, 2 * np.pi, 12), blocks


def models(device, dtype=np.float64, n: int = N) -> dict:
    """{name: model}: the exact GPE, SoR, DTC, FITC and FSA, SE(0.3, 0.1),
    lognoise -0.3."""
    x, y, ind, blocks = data(n)
    x, y, ind = x.astype(dtype), y.astype(dtype), ind.astype(dtype)
    kw = dict(kernel=gp.SE(0.3, 0.1), lognoise=-0.3, device=device)
    return {"exact": gp.GPE(x, y, **kw), "SoR": gp.SoR(x, ind, y, **kw),
            "DTC": gp.DTC(x, ind, y, **kw), "FITC": gp.FITC(x, ind, y, **kw),
            "FSA": gp.FSA(x, ind, blocks, y, **kw)}


def run(device, dtype=np.float64, n: int = N, verbose: bool = True) -> dict:
    """{name: {"mll", "rmse"}}: each model's mll and, for the sparse ones,
    the predicted mean's rmse from sin at 100 points."""
    out = {}
    xs = np.linspace(0, 2 * np.pi, 100).astype(dtype)
    for name, model in models(device, dtype, n).items():
        mll = float(model.mll)
        if name == "exact":
            if verbose:
                print(f"{'exact':>6s}: mll = {mll:10.3f}")
            out[name] = {"mll": mll}
            continue
        mu, _ = model.predict_f(xs)
        rmse = float(np.sqrt(np.mean((mu.cpu().numpy() - np.sin(xs)) ** 2)))
        if verbose:
            print(f"{name:>6s}: mll = {mll:10.3f}   pred rmse vs sin = {rmse:.4f}")
        out[name] = {"mll": mll, "rmse": rmse}
    return out


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=N, help="observations (the notebook's 1000)")
    args = p.parse_args(argv)
    return run(args.device, n=args.n)


if __name__ == "__main__":
    main(sys.argv[1:])
