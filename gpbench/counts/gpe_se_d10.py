"""Operations and bytes of configuration gpe_se_d10 (the exact GP with an
isotropic SE kernel), from the mathematics and the shapes, whatever
computes them.

One evaluation of the negative log marginal likelihood and its gradient
at n points: the gram, K = L L^T (n^3/3), w = L^-1 y, and for the gradient
K^-1 (L^-1: n^3/3, L^-T L^-1: n^3/3), alpha = K^-1 y, the cotangent
K^-1 - alpha alpha^T, and the gram's VJP.
"""
from __future__ import annotations

from gpbench.roofline import gram_bound_s as _gram, gram_vjp_bound_s as _gram_vjp

__all__ = ["gram_flops", "evaluation_flops", "launch_bound_s"]


def gram_flops(n1, n2, d, sym):
    pairs = n1 * (n1 + 1) / 2 if sym else n1 * n2
    return pairs * (3 * d + 4)


def evaluation_flops(cfg: dict, n: int) -> float:
    d = cfg["d"]
    return (n ** 3 / 3 + 2 * n ** 3 / 3 + 4 * n ** 2 + 3 * n ** 2
            + gram_flops(n, n, d, True) + n * (n + 1) / 2 * (3 * d + 16))


def launch_bound_s(cfg: dict, kernel: str, n1: int, n2: int, cross: bool, chains: int) -> float:
    """Least seconds of one launch of the gram kernel ("gram") or of its
    VJP ("gram_vjp"): the inputs carry no gradient."""
    if kernel == "gram":
        return _gram(n1, n2, cfg["d"], cfg["precision"], not cross, chains)
    return _gram_vjp(n1, n2, cfg["d"], cfg["precision"], not cross, False, chains)
