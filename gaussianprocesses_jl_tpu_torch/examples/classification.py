"""Binary GP classification: a GPA with a Bernoulli (probit) likelihood
and the factor-cached split sampler over latents and hyperparameters (the
JAX repo's `examples/classification.py`; d = 5, Matern 3/2 ARD).

    python -m gaussianprocesses_jl_tpu_torch.examples.classification [--device cpu] [--n-iter 1000]
"""
import sys

import numpy as np

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.examples import generator, parser
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal

__all__ = ["data", "model", "sample", "accuracy", "run", "main"]

D = 5


def data():
    """(X (80, 5), y in {0, 1}), RandomState(0)."""
    rng = np.random.RandomState(0)
    n = 80
    X = rng.randn(n, D)
    logit = 1.5 * X[:, 0] - 1.0 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    return X, (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(float)


def model(device, dtype=np.float64):
    """The GPA with Normal(0, 2) priors on the kernel's six parameters."""
    X, y = data()
    m = gp.GPA(X.astype(dtype), y.astype(dtype), gp.MeanZero(),
               gp.Matern(1.5, np.zeros(D), 0.0), gp.BernLik(), device=device)
    m.set_priors(kern=[Normal(0.0, 2.0)] * (D + 1))
    return m


def sample(m, device, outer: int, verbose: bool = True):
    """`outer` outer iterations of the split sampler (a_iters 8, eps 0.06
    each block), the first 8 * outer / 5 draws burnt; the model keeps the
    final state."""
    return gp.mcmc(m, generator(device, 0), n_iter=outer, a_iters=8, eps_a=0.06,
                   eps_b=0.06, sampler="split", burn=outer * 8 // 5, verbose=verbose)


def accuracy(m) -> float:
    X, y = data()
    p, _ = m.predict_y(X)
    return float(np.mean((p.cpu().numpy() > 0.5) == (y > 0.5)))


def run(device, dtype=np.float64, n_iter: int = 1000, verbose: bool = True) -> dict:
    """`n_iter` // 4 outer iterations of the split sampler, then the train
    accuracy at the final state."""
    m = model(device, dtype)
    res = sample(m, device, n_iter // 4, verbose)
    acc = accuracy(m)
    if verbose:
        print(f"train accuracy: {acc:.3f}  (posterior draws: {res.samples.shape[0]})")
    return {"accuracy": acc, "draws": int(res.samples.shape[0]),
            "accept": [round(r, 3) for r in res.accept_rate.tolist()]}


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n-iter", type=int, default=1000)
    args = p.parse_args(argv)
    return run(args.device, n_iter=args.n_iter)


if __name__ == "__main__":
    main(sys.argv[1:])
