"""The card's published peaks and the least time of the stationary gram
and its VJP, from their shapes.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores,
34 TFLOP/s in float64. The run prints the card's power limit beside every
share of these.

A gram's least time is the larger of its bytes (inputs read once, the
output written once) over the memory rate and its operations over the
arithmetic rate: ~3d + 4 operations an output for the forward; for the
VJP, over the pairs i >= j of a symmetric gram (all pairs of a cross one),
3d for the distance and 16 for the profile, its derivatives and the sums,
and 4d + 4 more with the inputs' gradient.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS", "F64_FLOPS", "peak_flops", "gram_bound_s",
           "gram_vjp_bound_s"]

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def peak_flops(precision: str) -> float:
    return {"float32": F32_FLOPS, "float64": F64_FLOPS}[precision]


def _itemsize(precision: str) -> int:
    return {"float32": 4, "float64": 8}[precision]


def gram_bound_s(n1, n2, d, precision, sym, chains=1, x_per_chain=False) -> float:
    """Least seconds of one launch of `chains` grams."""
    b = _itemsize(precision)
    xc = chains if x_per_chain else 1
    nbytes = b * (xc * (n1 * d + (0 if sym else n2 * d)) + chains * (3 + n1 * n2))
    ops = chains * n1 * n2 * (3 * d + 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_flops(precision))


def gram_vjp_bound_s(n1, n2, d, precision, sym, need_dx, chains=1, x_per_chain=False) -> float:
    """Least seconds of one launch of `chains` gram VJPs."""
    b = _itemsize(precision)
    xsize = n1 * d + (0 if sym else n2 * d)
    xc = chains if x_per_chain else 1
    nbytes = b * (chains * (n1 * n2 + 6 + (xsize if need_dx else 0)) + xc * xsize)
    pairs = n1 * (n1 + 1) // 2 if sym else n1 * n2
    ops = chains * pairs * (3 * d + 16 + (4 * d + 4 if need_dx else 0))
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_flops(precision))
