"""The reference's precisions.

"f64": float64 throughout. "f32": float32 throughout (`gpbench/scan.py`
sets it beside the accept band's estimate). "tf32": float32 throughout,
and every matrix product `mm` takes its operands rounded to TF32 (10
explicit mantissa bits, rounded to nearest), as a tensor core does with
TF32 switched on.
The rounding is done here, on any device, so the control reads the same
on the card and on the CPU; its gradient passes straight through.

`Float32Error` perturbs, in float64, each matrix the reference factors by
about what float32's rounding does to it: the size of the check's accept
band at a state.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MODES", "dtype_of", "tf32", "mm", "Float32Error"]

MODES = ("f64", "f32", "tf32")


def dtype_of(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}")
    return torch.float64 if mode == "f64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32: the low 13 of the 23 mantissa bits
    rounded away; the gradient is the identity."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b in the mode's precision."""
    if mode == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b


class Float32Error:
    """K -> K o (1 + gamma Xi): a symmetric matrix of every chain, K (..., n, n),
    perturbed entry by entry at about float32's rounding, gamma = GAMMA
    unless given, Xi symmetric standard normal (its diagonal N(0, 2)).
    Each call draws a fresh Xi from one generator, seeded from `key` (whole
    numbers: the run's seed, the outer iteration, the draw), on `device`:
    the same key gives the same perturbations."""

    # 16 roundings of float32's 2^-24, about sqrt(n) of them at n = 200: the size that
    # `gpbench/scan.py` settled (every flip of 10 000 followed outer iterations inside its band)
    GAMMA = 2.0 ** -20

    def __init__(self, key, device, gamma: float | None = None):
        seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
        self.gen = torch.Generator(device=device).manual_seed(seed >> 1)
        self.gamma = self.GAMMA if gamma is None else gamma

    def __call__(self, K: torch.Tensor) -> torch.Tensor:
        xi = torch.randn(K.shape, generator=self.gen, dtype=K.dtype, device=K.device)
        xi = (xi + xi.transpose(-1, -2)) * 0.5 ** 0.5
        return K * (1.0 + self.gamma * xi)
