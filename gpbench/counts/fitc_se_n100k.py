"""Operations and bytes of configuration fitc_se_n100k (FITC with an
isotropic SE kernel), from the mathematics and the shapes, whatever
computes them.

The reduced QR of the stacked N x m matrix (N = n + m rows): its forward
at least 2 N m^2 + m^3/3 operations (the Gram matrix's N m^2 multiply-adds,
its Cholesky factor, Q = A R^-1), its VJP 5 N m^2 (Q^T dQ, the triangular
solve against R and the two N x m products that form dA); bytes, each
N x m operand read or written once and each m x m one too: the forward
reads A and writes Q and R, the VJP reads Q and dQ and writes dA (R and dR
beside them). Read at the card's rates (`gpbench/roofline.py`), the larger
of the two times.

One evaluation of the negative log marginal likelihood and its gradient:
the grams K(Xu) and K(Xu, X), Kuu's factor (m^3/3), Luu^-1 Kuf (m^2 n) and
diag Qff (2 m n), the QR, its VJP, the solve's VJP (two more m^2 n: the
solve against Luu^T and the product that forms dLuu), the factor's VJP at
its least (2 m^3/3), the grams' VJPs (dp only), and the elementwise work on
the (m, n) matrices (10 m n).
"""
from __future__ import annotations

from gpbench.roofline import (F32_FLOPS, HBM_BYTES_PER_S, gram_bound_s as _gram,
                              gram_vjp_bound_s as _gram_vjp)

__all__ = ["qr_flops", "qr_bytes", "qr_bound_s", "gram_flops", "gram_vjp_flops",
           "evaluation_flops", "launch_bound_s"]


def qr_flops(kind: str, rows: int, cols: int) -> float:
    """Operations of one reduced QR ("fwd") or of its VJP ("vjp")."""
    if kind == "fwd":
        return 2 * rows * cols ** 2 + cols ** 3 / 3
    return 5 * rows * cols ** 2


def qr_bytes(kind: str, rows: int, cols: int, itemsize: int = 4) -> float:
    """Bytes of one reduced QR or of its VJP, each operand once."""
    if kind == "fwd":
        return itemsize * (2 * rows * cols + cols * cols)
    return itemsize * (3 * rows * cols + 2 * cols * cols)


def qr_bound_s(kind: str, rows: int, cols: int) -> float:
    """Least seconds of one float32 QR or VJP on the card."""
    return max(qr_flops(kind, rows, cols) / F32_FLOPS,
               qr_bytes(kind, rows, cols) / HBM_BYTES_PER_S)


def gram_flops(n1, n2, d, sym):
    pairs = n1 * (n1 + 1) / 2 if sym else n1 * n2
    return pairs * (3 * d + 4)


def gram_vjp_flops(n1, n2, d, sym):
    pairs = n1 * (n1 + 1) / 2 if sym else n1 * n2
    return pairs * (3 * d + 16)


def evaluation_flops(cfg: dict, n: int) -> float:
    d, m = cfg["d"], cfg["m"]
    rows = n + m
    forward = (gram_flops(m, m, d, True) + gram_flops(m, n, d, False) + m ** 3 / 3
               + m * m * n + 2 * m * n + qr_flops("fwd", rows, m))
    backward = (qr_flops("vjp", rows, m) + 2 * m * m * n + 2 * m ** 3 / 3
                + gram_vjp_flops(m, m, d, True) + gram_vjp_flops(m, n, d, False))
    return forward + backward + 10 * m * n


def launch_bound_s(cfg: dict, kernel: str, n1: int, n2: int, cross: bool, chains: int) -> float:
    """Least seconds of one launch of the gram kernel ("gram") or of its
    VJP ("gram_vjp"): K(Xu) and K(Xu, X); the inputs carry no gradient."""
    if kernel == "gram":
        return _gram(n1, n2, cfg["d"], cfg["precision"], not cross, chains)
    return _gram_vjp(n1, n2, cfg["d"], cfg["precision"], not cross, False, chains)
