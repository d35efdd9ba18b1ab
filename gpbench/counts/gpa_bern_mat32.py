"""Operations and bytes of configuration gpa_bern_mat32 (the whitened
latent probit GP, Matern 3/2 with ARD), from the mathematics and the
shapes, whatever computes them.

One evaluation of the log target and its gradient in every parameter at
n points: the gram, K = L L^T (n^3/3), f = L v (n^2), the likelihood, and
for the gradient the cotangents of f and L and the factor's VJP (taken at
its least, 2 n^3/3, as the exact GP's K^-1), and the gram's VJP with the
inputs' gradient (ARD scales them). One outer iteration of split HMC, a
chain: the factor of the A sweep; the A updates' leapfrog steps, each
f = L v and its transpose (4 n^2), the mean path length (Lmin + Lmax)/2 a
update and one start; the B update's steps, each a whole evaluation.
"""
from __future__ import annotations

from gpbench.roofline import gram_bound_s as _gram, gram_vjp_bound_s as _gram_vjp

__all__ = ["gram_flops", "evaluation_flops", "outer_iteration_flops", "launch_bound_s"]


def gram_flops(n, d):
    return n * (n + 1) / 2 * (3 * d + 4)


def evaluation_flops(cfg: dict, n: int) -> float:
    d = cfg["d"]
    vjp = n * (n + 1) / 2 * (3 * d + 16 + 4 * d + 4)
    return n ** 3 / 3 + 2 * n ** 2 + 2 * n ** 3 / 3 + 2 * n ** 2 + gram_flops(n, d) + vjp


def outer_iteration_flops(cfg: dict, n: int, chains: int) -> float:
    s = cfg["sampler"]
    steps = (s["Lmin"] + s["Lmax"]) / 2
    a_sweep = n ** 3 / 3 + gram_flops(n, cfg["d"]) + (s["a_iters"] * steps + 1) * 4 * n ** 2
    b_update = (steps + 1) * evaluation_flops(cfg, n)
    return chains * (a_sweep + b_update)


def launch_bound_s(cfg: dict, kernel: str, n1: int, n2: int, cross: bool, chains: int) -> float:
    """Least seconds of one launch of the gram kernel ("gram") or of its
    VJP ("gram_vjp") over `chains` chains, each with inputs of its own
    (scaled by its lengthscales) and the inputs' gradient."""
    if kernel == "gram":
        return _gram(n1, n2, cfg["d"], cfg["precision"], not cross, chains, chains > 1)
    return _gram_vjp(n1, n2, cfg["d"], cfg["precision"], not cross, True, chains, chains > 1)
