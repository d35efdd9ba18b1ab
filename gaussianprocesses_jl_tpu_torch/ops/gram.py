"""Stationary gram op: K(X1, X2) = profile(sqdist(X1, X2)).

Counterpart of `gaussianprocesses_jl_tpu/ops/pallas_gram.py`, forward and
backward. On a CUDA tensor the forward launches `gram_kernel` of
`csrc/gram.cu` and the backward `gram_vjp_kernel` (with its reduction), the
JAX package's `_gram_cv_bwd` fused by hand: gradients in the
hyperparameters and in the inputs in one pass over the cotangent. On a CPU
tensor they run the plain versions `gram_plain` and `gram_vjp_plain`, the
same functions in plain PyTorch, with the profiles' derivatives written out
in closed form (`gram_derivs`) as the kernel computes them.

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

__all__ = ["SE", "MAT12", "MAT32", "MAT52", "RQ", "PERIODIC", "LAUNCHES", "TILE",
           "profile", "gram_derivs", "gram_plain", "gram_vjp_plain", "gram", "launch_gram",
           "launch_gram_vjp", "tile_count", "vjp_scratch_elems"]

# profile families, numbered as in csrc/gram.cu
SE, MAT12, MAT32, MAT52, RQ, PERIODIC = range(6)

# kernel launches by name; each wrapper adds one where it launches
LAUNCHES = {"gram": 0, "gram_vjp": 0}

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


def gram_derivs(family: int, p: torch.Tensor, r2: torch.Tensor) -> tuple:
    """(K, dK/dll, dK/dextra, dK/dr2) of `family` at squared distance r2,
    in closed form (dK/dlsigma is 2K). dK/dr2 is 0 at r = 0 for the
    families of r, whose safe_dist has a zero gradient there."""
    lsigma, ll, extra = p[0], p[1], p[2]
    zero = torch.zeros_like(r2)
    il2 = torch.exp(-2.0 * ll)
    if family == SE:
        K = torch.exp(2.0 * lsigma - 0.5 * r2 * il2)
        return K, K * r2 * il2, zero, -0.5 * il2 * K
    if family == RQ:
        alpha = torch.exp(extra)
        z = r2 * il2 / (2.0 * alpha)
        lz = torch.log1p(z)
        K = torch.exp(2.0 * lsigma - alpha * lz)
        q = 1.0 / (1.0 + z)
        return K, 2.0 * K * alpha * z * q, K * alpha * (z * q - lz), -0.5 * K * il2 * q
    if not 0 <= family <= PERIODIC:
        raise ValueError(f"unknown profile family {family}")
    pos = r2 > 0
    r = safe_dist(r2)
    half_ir = torch.where(pos, 0.5 / torch.where(pos, r, torch.ones_like(r)), zero)
    il = torch.exp(-ll)
    if family == MAT12:
        K = torch.exp(2.0 * lsigma - r * il)
        return K, K * r * il, zero, -il * K * half_ir
    if family in (MAT32, MAT52):
        s = (_SQRT3 if family == MAT32 else _SQRT5) * r * il
        e = torch.exp(2.0 * lsigma) * torch.exp(-s)
        if family == MAT32:
            return (1.0 + s) * e, s * s * e, zero, torch.where(pos, -1.5 * il2 * e, zero)
        return ((1.0 + s + s * s / 3.0) * e, s * s * (1.0 + s) * e / 3.0, zero,
                torch.where(pos, -(5.0 / 6.0) * il2 * (1.0 + s) * e, zero))
    u = math.pi * r * torch.exp(-extra)
    sn, cs = torch.sin(u), torch.cos(u)
    K = torch.exp(2.0 * lsigma - 2.0 * sn * sn * il2)
    return (K, 4.0 * K * sn * sn * il2, 4.0 * K * sn * cs * il2 * u,
            -4.0 * K * sn * cs * il2 * math.pi * torch.exp(-extra) * half_ir)


def gram_plain(family: int, p: torch.Tensor, X1: torch.Tensor,
               X2: torch.Tensor | None = None) -> torch.Tensor:
    """profile(sqdist(X1, X2)): the plain version of the kernel."""
    return profile(family, p, sqdist(X1, X2))


def gram_vjp_plain(family: int, p: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor | None,
                   G: torch.Tensor, needs=(True, True, True)) -> tuple:
    """(dp, dX1, dX2): the vector-Jacobian product of `gram_plain` with the
    cotangent G, each None where `needs` (p, X1, X2) does not ask for it;
    the plain version of `gram_vjp_kernel`.

    dp = sum_ij G_ij dK_ij/dp; dX1_i = sum_j W_ij (x1_i - x2_j) and
    dX2_j = sum_i W_ij (x2_j - x1_i) with W = 2 G dK/dr2. On a symmetric gram
    (X2 None) X1's gradient takes both sides, W becomes W + W^T, and the
    pinned diagonal gives no distance gradient."""
    sym = X2 is None
    K, dll, dex, dr2 = gram_derivs(family, p, sqdist(X1, X2))
    dp = (torch.stack([2.0 * torch.sum(G * K), torch.sum(G * dll), torch.sum(G * dex)])
          if needs[0] else None)
    dX1 = dX2 = None
    if needs[1] or (not sym and needs[2]):
        W = 2.0 * G * dr2
        if sym:
            W = W + W.T
            W.diagonal().zero_()
            X2 = X1
        if needs[1]:
            dX1 = W.sum(1, keepdim=True) * X1 - W @ X2
        if not sym and needs[2]:
            dX2 = W.sum(0)[:, None] * X2 - W.T @ X1
    return dp, dX1, dX2


# the kernels' output tile edge, and the most blocks of 256 threads an SM
# holds (the VJP's scratch holds a partial for each)
TILE = 64
_MAX_BLOCKS_PER_SM = 8


def tile_count(n1: int, n2: int, sym: bool) -> int:
    """Tiles of the kernels' walk: the lower triangle of a symmetric gram,
    every tile of a cross gram."""
    nb1, nb2 = -(-n1 // TILE), -(-n2 // TILE)
    return nb1 * (nb1 + 1) // 2 if sym else nb1 * nb2


def vjp_scratch_elems(n1: int, n2: int, d: int, sym: bool, need_dx1: bool, need_dx2: bool,
                      sms: int) -> int:
    """Elements of the VJP kernel's scratch: 3 partials for each block that
    can be resident, then 64 x d partials a tile for each side asked for
    (rows for dX1, columns for dX2, both for a symmetric dX1)."""
    sides = 2 * need_dx1 if sym else need_dx1 + need_dx2
    return 3 * _MAX_BLOCKS_PER_SM * sms + sides * tile_count(n1, n2, sym) * d * TILE


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
    if max(X1.shape[0], X2.shape[0]) >= 2**31 - TILE:
        raise ValueError(f"gram: at most {2**31 - TILE - 1} rows")


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of csrc/gram.cu and their argument types
_ARGTYPES = {
    "gram_f32": [_P] * 4 + [_I] * 6 + [_P],
    "gram_f64": [_P] * 4 + [_I] * 6 + [_P],
    "gram_vjp_f32": [_P] * 8 + [_I] * 9 + [_P],
    "gram_vjp_f64": [_P] * 8 + [_I] * 9 + [_P],
}
_ENTRIES: dict = {}
_SMS: dict = {}


def _entry(name: str):
    """The bound C function `name`, its types set once, the library built
    at first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(cuda.load("gram.cu"), name)
        fn.restype = _I
        fn.argtypes = _ARGTYPES[name]
        _ENTRIES[name] = fn
    return fn


def _call(name: str, device: torch.device, *args) -> None:
    """Call the C entry `name` on `device`'s current stream, switching the
    current device only when it is another, and raise on a nonzero
    cudaError_t."""
    fn = _entry(name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def launch_gram(family: int, p: torch.Tensor, X1: torch.Tensor,
                X2: torch.Tensor | None = None, grid: int = 0) -> torch.Tensor:
    """Launch `gram_kernel` of `csrc/gram.cu` on CUDA tensors:
    K = profile(|X1_i - X2_j|^2), with the diagonal pinned to profile(0)
    when X2 is None. Its blocks walk the output's tiles: `grid` of them, or
    as many as fit on the card at once when grid <= 0."""
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
    _call(f"gram_{_suffix(X1.dtype)}", X1.device, X1.data_ptr(), X2.data_ptr(), p.data_ptr(),
          out.data_ptr(), n1, n2, d, family, int(sym), int(grid))
    LAUNCHES["gram"] += 1
    return out


def launch_gram_vjp(family: int, p: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor | None,
                    G: torch.Tensor, needs=(True, True, True), grid: int = 0) -> tuple:
    """Launch `gram_vjp_kernel` and its reduction on CUDA tensors: (dp, dX1,
    dX2) as `gram_vjp_plain` computes them, each None where `needs` does not
    ask for it. G is the (n1, n2) contiguous cotangent. `grid` as for
    `launch_gram`; the sums' order, and so their last bits, follow it."""
    sym = X2 is None
    X2c = X1 if sym else X2
    _check(family, p, X1, X2c)
    n1, d = X1.shape
    n2 = X2c.shape[0]
    if G.shape != (n1, n2) or G.dtype != X1.dtype or G.device != X1.device:
        raise ValueError(f"gram_vjp: the cotangent must be ({n1}, {n2}) {X1.dtype} on "
                         f"{X1.device}, got {tuple(G.shape)} {G.dtype} on {G.device}")
    if not G.is_contiguous():
        raise ValueError("gram_vjp: the cotangent must be contiguous")
    if X1.device.type != "cuda":
        raise ValueError(f"launch_gram_vjp needs CUDA tensors, got {X1.device}")
    need_dp, need_dx1, need_dx2 = bool(needs[0]), bool(needs[1]), bool(needs[2]) and not sym
    if n1 == 0 or n2 == 0:
        return (X1.new_zeros(3) if need_dp else None, torch.zeros_like(X1) if need_dx1 else None,
                torch.zeros_like(X2c) if need_dx2 else None)
    # the kernels write every element asked for
    dp = X1.new_empty(3) if need_dp else None
    dX1 = torch.empty_like(X1) if need_dx1 else None
    dX2 = torch.empty_like(X2c) if need_dx2 else None
    if not (need_dp or need_dx1 or need_dx2):
        return dp, dX1, dX2
    sms = _SMS.get(X1.device.index)
    if sms is None:
        sms = _SMS[X1.device.index] = torch.cuda.get_device_properties(X1.device).multi_processor_count
    scratch = torch.empty(vjp_scratch_elems(n1, n2, d, sym, need_dx1, need_dx2, sms),
                          dtype=X1.dtype, device=X1.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _call(f"gram_vjp_{_suffix(X1.dtype)}", X1.device, X1.data_ptr(), X2c.data_ptr(),
          p.data_ptr(), G.data_ptr(), ptr(dp), ptr(dX1), ptr(dX2), scratch.data_ptr(),
          n1, n2, d, family, int(sym), int(need_dp), int(need_dx1), int(need_dx2), int(grid))
    LAUNCHES["gram_vjp"] += 1
    return dp, dX1, dX2


class _Gram(torch.autograd.Function):
    """Forward and backward by the kernels (CUDA) or the plain versions
    (CPU)."""

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
        needs = ctx.needs_input_grad[1:]
        if X1.device.type == "cuda":
            grads = launch_gram_vjp(ctx.family, p, X1, X2, g.contiguous(), needs)
        else:
            grads = gram_vjp_plain(ctx.family, p, X1, X2, g, needs)
        return (None, *grads)


def gram(family: int, p: torch.Tensor, X1: torch.Tensor,
         X2: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable stationary gram of `family` with hyperparameters p
    (cast to the inputs' dtype). X2=None is the symmetric gram."""
    return _Gram.apply(family, p.to(X1.dtype), X1, X2)
