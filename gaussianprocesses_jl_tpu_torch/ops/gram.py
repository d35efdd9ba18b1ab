"""Stationary gram op: K(X1, X2) = profile(sqdist(X1, X2)).

Counterpart of `gaussianprocesses_jl_tpu/ops/pallas_gram.py`. On a CUDA
tensor the forward launches the hand-written kernel `csrc/gram.cu`; on a CPU
tensor it runs the plain version `gram_plain`, which is the same function in
plain PyTorch. The backward recomputes the plain version under autograd and
returns its vector-Jacobian product, as the JAX package's `_gram_cv_bwd`
does, for gradients in the hyperparameters and in the inputs.

A kernel module reaches the op through its profile family (an integer,
one per profile formula) and a 3-vector of hyperparameters
p = [lsigma, ll, extra], which take the place of the JAX package's `_pack`.
ARD modules pre-scale their inputs and pass ll = 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda
from .distance import safe_dist, sqdist

__all__ = ["SE", "MAT12", "MAT32", "MAT52", "RQ", "PERIODIC", "LAUNCHES",
           "profile", "gram_plain", "gram", "launch_gram"]

# profile families, numbered as in csrc/gram.cu
SE, MAT12, MAT32, MAT52, RQ, PERIODIC = range(6)

# kernel launches by name; each wrapper adds one where it launches
LAUNCHES = {"gram": 0}

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def profile(family: int, p: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """The profile of `family` at squared distance r2, in plain PyTorch."""
    lsigma, ll, extra = p[0], p[1], p[2]
    if family == SE:
        return torch.exp(2.0 * lsigma - 0.5 * r2 * torch.exp(-2.0 * ll))
    if family == RQ:
        alpha = torch.exp(extra)
        z = r2 * torch.exp(-2.0 * ll) / (2.0 * alpha)
        return torch.exp(2.0 * lsigma - alpha * torch.log1p(z))
    r = safe_dist(r2)
    if family == MAT12:
        return torch.exp(2.0 * lsigma - r * torch.exp(-ll))
    if family == MAT32:
        s = _SQRT3 * r * torch.exp(-ll)
        return torch.exp(2.0 * lsigma) * (1.0 + s) * torch.exp(-s)
    if family == MAT52:
        s = _SQRT5 * r * torch.exp(-ll)
        return torch.exp(2.0 * lsigma) * (1.0 + s + s * s / 3.0) * torch.exp(-s)
    if family == PERIODIC:
        s = torch.sin(math.pi * r * torch.exp(-extra))
        return torch.exp(2.0 * lsigma - 2.0 * s * s * torch.exp(-2.0 * ll))
    raise ValueError(f"unknown profile family {family}")


def gram_plain(family: int, p: torch.Tensor, X1: torch.Tensor,
               X2: torch.Tensor | None = None) -> torch.Tensor:
    """profile(sqdist(X1, X2)): the plain version of the kernel."""
    return profile(family, p, sqdist(X1, X2))


def _check(family, p, X1, X2):
    if not 0 <= family <= PERIODIC:
        raise ValueError(f"unknown profile family {family}")
    for name, t in (("X1", X1), ("X2", X2)):
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"gram: {name} must be float32 or float64, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"gram: {name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gram: {name} must be contiguous")
        if t.device != X1.device:
            raise ValueError(f"gram: {name} is on {t.device}, X1 on {X1.device}")
    if X2.dtype != X1.dtype or p.dtype != X1.dtype:
        raise TypeError(f"gram: dtypes differ: X1 {X1.dtype}, X2 {X2.dtype}, p {p.dtype}")
    if X2.shape[1] != X1.shape[1]:
        raise ValueError(f"gram: feature counts differ: {X1.shape[1]} and {X2.shape[1]}")
    if p.shape != (3,) or not p.is_contiguous() or p.device != X1.device:
        raise ValueError(f"gram: p must be a contiguous 3-vector on {X1.device}")
    if X1.shape[0] > 64 * 65535:
        raise ValueError(f"gram: at most {64 * 65535} rows, got {X1.shape[0]}")


def _entry(dtype):
    lib = cuda.load("gram.cu")
    fn = lib.gram_f32 if dtype == torch.float32 else lib.gram_f64
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def launch_gram(family: int, p: torch.Tensor, X1: torch.Tensor,
                X2: torch.Tensor | None = None) -> torch.Tensor:
    """Launch `csrc/gram.cu` on CUDA tensors: K = profile(|X1_i - X2_j|^2),
    with the diagonal pinned to profile(0) when X2 is None."""
    sym = X2 is None
    X2 = X1 if sym else X2
    _check(family, p, X1, X2)
    if X1.device.type != "cuda":
        raise ValueError(f"launch_gram needs CUDA tensors, got {X1.device}")
    n1, d = X1.shape
    n2 = X2.shape[0]
    out = torch.empty((n1, n2), dtype=X1.dtype, device=X1.device)
    if out.numel() == 0:
        return out
    fn = _entry(X1.dtype)
    with torch.cuda.device(X1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(X1.data_ptr(), X2.data_ptr(), p.data_ptr(), out.data_ptr(),
                 n1, n2, d, family, int(sym), stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: cudaError_t {err}")
    LAUNCHES["gram"] += 1
    return out


class _Gram(torch.autograd.Function):
    """Forward by the kernel (CUDA) or the plain version (CPU); backward by
    the plain version's VJP."""

    @staticmethod
    def forward(ctx, family, p, X1, X2):
        ctx.family = family
        ctx.save_for_backward(p, X1, X2)
        if X1.device.type == "cuda":
            return launch_gram(family, p, X1, X2)
        if X1.device.type == "cpu":
            return gram_plain(family, p, X1, X2)
        raise ValueError(f"gram: no kernel for device {X1.device}")

    @staticmethod
    def backward(ctx, g):
        p, X1, X2 = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip((p, X1, X2), ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            K = gram_plain(ctx.family, *inputs)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(K, wanted, g) if wanted else ())
        return (None, *(next(grads) if t is not None and t.requires_grad else None
                        for t in inputs))


def gram(family: int, p: torch.Tensor, X1: torch.Tensor,
         X2: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable stationary gram of `family` with hyperparameters p
    (cast to the inputs' dtype). X2=None is the symmetric gram."""
    return _Gram.apply(family, p.to(X1.dtype), X1, X2)
