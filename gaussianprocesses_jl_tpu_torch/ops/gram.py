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

A batch of chains: any of p (C, 3), X1 (C, n1, d) and X2 (C, n2, d) may
carry a leading chain dimension (an operand without one is shared by the
chains), and one launch computes the C grams (C, n1, n2), or their VJP. A
sampler writes its target for one chain and batches it with
`torch.func.vmap`; the op's vmap rules (`_Gram.vmap`, `_GramVJP.vmap`) move
the batch to the front and call the batched op, so `vmap(grad(target))` over
C chains launches each kernel once. The backward is an autograd.Function of
its own, so that its vmap rule sees plain tensors too.
"""
from __future__ import annotations

import collections
import math

import torch

from ..utils.graphs import counted
from . import cuda
from .distance import safe_dist, sqdist

__all__ = ["SE", "MAT12", "MAT32", "MAT52", "RQ", "PERIODIC", "LAUNCHES", "LAUNCH_SHAPES", "TILE",
           "profile", "gram_derivs", "gram_plain", "gram_vjp_plain", "gram", "launch_gram",
           "launch_gram_vjp", "tile_count", "vjp_scratch_elems", "chain_count"]

# profile families, numbered as in csrc/gram.cu
SE, MAT12, MAT32, MAT52, RQ, PERIODIC = range(6)

# kernel launches by name; each wrapper adds one where it launches, here and
# under the key (name, n1, n2, cross) of the gram's shape and walk (cross:
# X2 given) in LAUNCH_SHAPES
LAUNCHES = counted({"gram": 0, "gram_vjp": 0})
LAUNCH_SHAPES = counted(collections.Counter())

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


def _rq_dlalpha(u: torch.Tensor, lz: torch.Tensor) -> torch.Tensor:
    """u - lz = z/(1+z) - log1p(z), as the kernel computes it: below u =
    0.05 the two terms cancel to ~-u^2/2 and their difference keeps only
    ~eps/u of its relative accuracy, so there it is summed as
    -u^2 sum_{k=2..17} u^(k-2)/k, whose terms share one sign."""
    s = torch.full_like(u, 1.0 / 17.0)
    for k in range(16, 1, -1):
        s = s * u + 1.0 / k
    return torch.where(u < 0.05, -u * u * s, u - lz)


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
        return (K, 2.0 * K * alpha * z * q, K * alpha * _rq_dlalpha(z * q, lz),
                -0.5 * K * il2 * q)
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


def chain_count(p: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor | None = None,
                G: torch.Tensor | None = None):
    """The chain count C of the operands that carry a chain dimension (p
    (C, 3), X1 (C, n1, d), X2 (C, n2, d), G (C, n1, n2)), or None when none
    does; raises when they disagree."""
    counts = {t.shape[0] for t, nd in ((p, 2), (X1, 3), (X2, 3), (G, 3))
              if t is not None and t.ndim == nd}
    if len(counts) > 1:
        raise ValueError(f"gram: chain counts differ: {sorted(counts)}")
    return counts.pop() if counts else None


def _dims(*ts):
    """vmap's in_dims for the op's operands: 0 where one carries the chain
    dimension (p 2-D, an input or cotangent 3-D), None otherwise."""
    return tuple(None if t is None or t.ndim == (1 if i == 0 else 2) else 0
                 for i, t in enumerate(ts))


def gram_plain(family: int, p: torch.Tensor, X1: torch.Tensor,
               X2: torch.Tensor | None = None) -> torch.Tensor:
    """profile(sqdist(X1, X2)): the plain version of the kernel; over a batch
    of chains, the same vmapped."""
    if chain_count(p, X1, X2) is not None:
        return torch.func.vmap(lambda q, A, B: gram_plain(family, q, A, B),
                               in_dims=_dims(p, X1, X2))(p, X1, X2)
    return profile(family, p, sqdist(X1, X2))


def gram_vjp_plain(family: int, p: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor | None,
                   G: torch.Tensor, needs=(True, True, True)) -> tuple:
    """(dp, dX1, dX2): the vector-Jacobian product of `gram_plain` with the
    cotangent G, each None where `needs` (p, X1, X2) does not ask for it;
    the plain version of `gram_vjp_kernel`. Over a batch of chains (G
    (C, n1, n2)), the same vmapped: one gradient a chain, (C, ...).

    dp = sum_ij G_ij dK_ij/dp; dX1_i = sum_j W_ij (x1_i - x2_j) and
    dX2_j = sum_i W_ij (x2_j - x1_i) with W = 2 G dK/dr2. On a symmetric gram
    (X2 None) X1's gradient takes both sides, W becomes W + W^T, and the
    pinned diagonal gives no distance gradient."""
    sym = X2 is None
    if chain_count(p, X1, X2, G) is not None:
        outs = tuple(0 if n else None for n in (needs[0], needs[1], needs[2] and not sym))
        return torch.func.vmap(lambda q, A, B, H: gram_vjp_plain(family, q, A, B, H, needs),
                               in_dims=_dims(p, X1, X2, G), out_dims=outs)(p, X1, X2, G)
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
                      sms: int, chains: int = 1) -> int:
    """Elements of the VJP kernel's scratch, for each chain: 3 partials for
    each block that can be resident, then 64 x d partials a tile for each
    side asked for (rows for dX1, columns for dX2, both for a symmetric
    dX1)."""
    sides = 2 * need_dx1 if sym else need_dx1 + need_dx2
    return chains * (3 * _MAX_BLOCKS_PER_SM * sms + sides * tile_count(n1, n2, sym) * d * TILE)


def _check(family, p, X1, X2, G=None):
    """The chain count (None: one gram) of operands the kernels take."""
    if not 0 <= family <= PERIODIC:
        raise ValueError(f"unknown profile family {family}")
    for name, t in (("X1", X1), ("X2", X2)):
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"gram: {name} must be float32 or float64, got {t.dtype}")
        if t.ndim not in (2, 3):
            raise ValueError(f"gram: {name} must be (n, d) or (chains, n, d), "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gram: {name} must be contiguous")
        if t.device != X1.device:
            raise ValueError(f"gram: {name} is on {t.device}, X1 on {X1.device}")
    if X2.dtype != X1.dtype or p.dtype != X1.dtype:
        raise TypeError(f"gram: dtypes differ: X1 {X1.dtype}, X2 {X2.dtype}, p {p.dtype}")
    if X2.shape[-1] != X1.shape[-1]:
        raise ValueError(f"gram: feature counts differ: {X1.shape[-1]} and {X2.shape[-1]}")
    if (p.ndim not in (1, 2) or p.shape[-1] != 3 or not p.is_contiguous()
            or p.device != X1.device):
        raise ValueError(f"gram: p must be a contiguous (3,) or (chains, 3) tensor on "
                         f"{X1.device}")
    if max(X1.shape[-2], X2.shape[-2]) >= 2**31 - TILE:
        raise ValueError(f"gram: at most {2**31 - TILE - 1} rows")
    return chain_count(p, X1, X2, G)


def _strides(p, X1, X2, sym):
    """Elements between chains of X1, X2 and p: 0 where the chains share it."""
    sx1 = X1.shape[-2] * X1.shape[-1] if X1.ndim == 3 else 0
    sx2 = sx1 if sym else (X2.shape[-2] * X2.shape[-1] if X2.ndim == 3 else 0)
    return sx1, sx2, 3 if p.ndim == 2 else 0


_SMS: dict = {}  # device index -> its SM count


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def launch_gram(family: int, p: torch.Tensor, X1: torch.Tensor,
                X2: torch.Tensor | None = None, grid: int = 0) -> torch.Tensor:
    """Launch `gram_kernel` of `csrc/gram.cu` on CUDA tensors:
    K = profile(|X1_i - X2_j|^2), with the diagonal pinned to profile(0)
    when X2 is None; (C, n1, n2) for a batch of C chains, all in one launch.
    Its blocks walk the (chain, tile) pairs: `grid` of them, or as many as
    fit on the card at once when grid <= 0."""
    sym = X2 is None
    X2 = X1 if sym else X2
    chains = _check(family, p, X1, X2)
    if X1.device.type != "cuda":
        raise ValueError(f"launch_gram needs CUDA tensors, got {X1.device}")
    n1, d = X1.shape[-2:]
    n2 = X2.shape[-2]
    shape = (n1, n2) if chains is None else (chains, n1, n2)
    out = torch.empty(shape, dtype=X1.dtype, device=X1.device)
    if out.numel() == 0:
        return out
    cuda.call("gram.cu", f"gram_{_suffix(X1.dtype)}", X1.data_ptr(), X2.data_ptr(), p.data_ptr(),
              out.data_ptr(), n1, n2, d, family, int(sym), chains or 1,
              *_strides(p, X1, X2, sym), int(grid), device=X1.device)
    LAUNCHES["gram"] += 1
    LAUNCH_SHAPES["gram", n1, n2, not sym] += 1
    return out


def launch_gram_vjp(family: int, p: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor | None,
                    G: torch.Tensor, needs=(True, True, True), grid: int = 0) -> tuple:
    """Launch `gram_vjp_kernel` and its reduction on CUDA tensors: (dp, dX1,
    dX2) as `gram_vjp_plain` computes them, each None where `needs` does not
    ask for it. G is the (n1, n2) contiguous cotangent, or (C, n1, n2) for a
    batch of chains, whose gradients are then (C, 3), (C, n1, d) and
    (C, n2, d), one a chain even where the chains share an operand. `grid`
    as for `launch_gram`; the sums' order, and so their last bits, follow
    it."""
    sym = X2 is None
    X2c = X1 if sym else X2
    chains = _check(family, p, X1, X2c, G)
    n1, d = X1.shape[-2:]
    n2 = X2c.shape[-2]
    lead = () if chains is None else (chains,)
    if G.shape != (*lead, n1, n2) or G.dtype != X1.dtype or G.device != X1.device:
        raise ValueError(f"gram_vjp: the cotangent must be {(*lead, n1, n2)} {X1.dtype} on "
                         f"{X1.device}, got {tuple(G.shape)} {G.dtype} on {G.device}")
    if not G.is_contiguous():
        raise ValueError("gram_vjp: the cotangent must be contiguous")
    if X1.device.type != "cuda":
        raise ValueError(f"launch_gram_vjp needs CUDA tensors, got {X1.device}")
    need_dp, need_dx1, need_dx2 = bool(needs[0]), bool(needs[1]), bool(needs[2]) and not sym
    # the kernels write every element asked for
    dp = X1.new_empty((*lead, 3)) if need_dp else None
    dX1 = X1.new_empty((*lead, n1, d)) if need_dx1 else None
    dX2 = X1.new_empty((*lead, n2, d)) if need_dx2 else None
    if n1 == 0 or n2 == 0 or chains == 0:
        return tuple(None if t is None else t.zero_() for t in (dp, dX1, dX2))
    if not (need_dp or need_dx1 or need_dx2):
        return dp, dX1, dX2
    sms = _SMS.get(X1.device.index)
    if sms is None:
        sms = _SMS[X1.device.index] = torch.cuda.get_device_properties(X1.device).multi_processor_count
    scratch = torch.empty(vjp_scratch_elems(n1, n2, d, sym, need_dx1, need_dx2, sms, chains or 1),
                          dtype=X1.dtype, device=X1.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    cuda.call("gram.cu", f"gram_vjp_{_suffix(X1.dtype)}", X1.data_ptr(), X2c.data_ptr(),
              p.data_ptr(), G.data_ptr(), ptr(dp), ptr(dX1), ptr(dX2), scratch.data_ptr(),
              n1, n2, d, family, int(sym), int(need_dp), int(need_dx1), int(need_dx2),
              chains or 1, *_strides(p, X1, X2c, sym), int(grid), device=X1.device)
    LAUNCHES["gram_vjp"] += 1
    LAUNCH_SHAPES["gram_vjp", n1, n2, not sym] += 1
    return dp, dX1, dX2


def _front(t, dim, size=None):
    """`t` with its vmap batch dimension `dim` moved to the front,
    contiguous; `t` itself where it has none, or broadcast to `size` chains
    when a size is given."""
    if t is None:
        return None
    if dim is None:
        return t if size is None else t.expand(size, *t.shape).contiguous()
    return t.movedim(dim, 0).contiguous()


class _GramVJP(torch.autograd.Function):
    """The gram's backward: the VJP kernel (CUDA) or `gram_vjp_plain` (CPU).
    An autograd.Function of its own, so that under `torch.func.vmap` its
    rule batches the chains into one launch."""

    @staticmethod
    def forward(family, needs, p, X1, X2, G):
        if X1.device.type == "cuda":
            return launch_gram_vjp(family, p, X1, X2, G.contiguous(), needs)
        if X1.device.type == "cpu":
            return gram_vjp_plain(family, p, X1, X2, G, needs)
        raise ValueError(f"gram: no kernel for device {X1.device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the gram op has no second derivative")

    @staticmethod
    def vmap(info, in_dims, family, needs, p, X1, X2, G):
        _, _, dp_, d1, d2, dg = in_dims
        out = _GramVJP.apply(family, needs, _front(p, dp_), _front(X1, d1), _front(X2, d2),
                             _front(G, dg, info.batch_size))
        return out, tuple(None if t is None else 0 for t in out)


class _Gram(torch.autograd.Function):
    """Forward by the kernel (CUDA) or the plain version (CPU), backward by
    `_GramVJP`; under `torch.func.vmap` one batched call for every chain."""

    @staticmethod
    def forward(family, p, X1, X2):
        if X1.device.type == "cuda":
            return launch_gram(family, p, X1, X2)
        if X1.device.type == "cpu":
            return gram_plain(family, p, X1, X2)
        raise ValueError(f"gram: no kernel for device {X1.device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        family, p, X1, X2 = inputs
        ctx.family = family
        ctx.save_for_backward(p, X1, X2)

    @staticmethod
    def backward(ctx, g):
        p, X1, X2 = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[1:])
        return (None, *_GramVJP.apply(ctx.family, needs, p, X1, X2, g))

    @staticmethod
    def vmap(info, in_dims, family, p, X1, X2):
        _, dp_, d1, d2 = in_dims
        return _Gram.apply(family, _front(p, dp_), _front(X1, d1), _front(X2, d2)), 0


def gram(family: int, p: torch.Tensor, X1: torch.Tensor,
         X2: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable stationary gram of `family` with hyperparameters p
    (cast to the inputs' dtype). X2=None is the symmetric gram."""
    return _Gram.apply(family, p.to(X1.dtype), X1, X2)
