"""The reference's two precisions.

"f64": float64 throughout. "tf32": float32 throughout, and every matrix
product `mm` takes its operands rounded to TF32 (10 explicit mantissa
bits, rounded to nearest), as a tensor core does with TF32 switched on.
The rounding is done here, on any device, so the control reads the same
on the card and on the CPU; its gradient passes straight through.
"""
from __future__ import annotations

import torch

__all__ = ["MODES", "dtype_of", "tf32", "mm"]

MODES = ("f64", "tf32")


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
