"""Sparse inducing-point approximations: SoR, DTC, FITC and FSA
(counterpart of `gaussianprocesses_jl_tpu/models/sparse.py`).

All four share the low-rank-plus-residual structure

    Sigma ~= Kfu Kuu^-1 Kuf + Lambda

with Lambda = sigma^2 I (SoR, DTC), sigma^2 I + diag(Kff - Qff) (FITC), or
block-diagonal residuals over a partition of the observations (FSA). The
factorization is the JAX package's: a reduced QR of the stacked matrix
[Lambda^-1/2 Kfu; Luu^T], whose R gives R^T R = Kuu + Kuf Lambda^-1 Kfu and
whose data rows Qw give Sigma^-1 = Lambda^-1/2 (I - Qw Qw^T) Lambda^-1/2.
Gradients come from autograd through the QR and the gram op, whose cross
gram K(Xu, X) launches the gram kernels on a CUDA tensor. FSA's ragged
partition is padded to one block width with masks; its per-block grams run
as one batched gram (`torch.func.vmap` over the blocks, the kernel's
parameters shared).

The QR takes one of two routes by the stacked matrix's dtype (`_qr`):

  * float32: a mixed-precision shifted Cholesky QR in three passes
    (`_CholQR3`; Fukaya et al., SIAM J. Sci. Comput. 42(1), 2020). The
    Gram matrix of the float32 matrix is formed in float64, where each
    product of two float32 numbers is exact, and every later n-side step
    stays in float64; Q and R are rounded to float32 at the end. An
    unshifted Cholesky QR squares cond(A) against float64's unit roundoff
    and failed from cond(A) ~ 4e7 on, inside what the float32 model's floors
    allow (Lambda >= 1e-5, Kuu's jitter 1e-4 of its scale); the first
    pass's Gram is therefore shifted so that its factor succeeds, and two
    unshifted passes restore Q's orthogonality. The route holds Q to
    float32's rounding on float32 matrices up to cond(A) 1e10
    (tests/test_torch_cholqr.py), where Householder's float32 R has long
    lost the small singular values. Its work is six large GEMMs
    (three Grams, three products by an m x m inverse), where a blocked
    Householder QR runs two latency-bound panel launches a column block.
    Its VJP is the closed-form reduced-QR VJP, in float32.
  * float64: `torch.linalg.qr` (Householder). Its Kuu jitter is 1e-10, so
    cond(A)^2 can pass float64's range, and a float64 Gram matrix has no
    wider type behind it.

The QR is the strategies' largest piece of device work, and it runs inside
the CUDA graph that replays an evaluation. So its forward runs between the
device markers of `gp.qr.fwd` and its VJP between those of `gp.qr.vjp`
(`utils/profiling.bracket`: kernels on the stream, which the graph captures
and a device trace names), and `QR_SHAPES` counts the factorizations and
their VJPs by shape, as `ops/gram.LAUNCH_SHAPES` counts the gram's launches,
and `QR_ROUTES` the factorizations by route and shape (a graph's replay adds
what its capture counted, `utils/graphs.py`).

The strategies plug into GPE through the covariance-strategy interface
(build / predict_mvn); the constructors `SoR`, `DTC`, `FITC` and `FSA` build
a GPE on `device` (the CUDA device unless the caller names another).
"""
from __future__ import annotations

import collections
from typing import Any

import torch

from ..ops.linalg import (add_diag, chol_logdet, default_jitter, safe_cholesky,
                          solve_lower, solve_upper)
from ..utils import profiling
from ..utils.graphs import counted
from ..utils.modules import Module, module

__all__ = [
    "SubsetOfRegsStrategy",
    "DeterminTrainCondStrat",
    "FullyIndepStrat",
    "FullScaleApproxStrat",
    "SoR",
    "DTC",
    "FITC",
    "FSA",
    "LowRankPD",
    "pad_pred_blocks",
    "QR_SHAPES",
    "QR_ROUTES",
]

# reduced QRs of the stacked matrix by ("qr", rows, columns), and their VJPs
# by ("qr_vjp", rows, columns)
QR_SHAPES = counted(collections.Counter())
# the reduced QRs by (route, rows, columns): "cholqr3" for a float32 matrix,
# "householder" for any other
QR_ROUTES = counted(collections.Counter())


# ---------------------------------------------------------------------------
# Residual (Lambda) representations
# ---------------------------------------------------------------------------


@module(static=())
class _DiagLambda(Module):
    """Lambda = diag(d) (the SoR/DTC scalar case has d = sigma^2 1)."""

    d: Any  # (n,)

    def solve(self, B):
        """Lambda^-1 B, B (n,) or (n, k)."""
        return B / self.d if B.ndim == 1 else B / self.d[:, None]

    def matvec(self, B):
        """Lambda B, B (n,) or (n, k)."""
        return B * self.d if B.ndim == 1 else B * self.d[:, None]

    def logdet(self):
        return torch.sum(torch.log(self.d))

    def whiten_rows(self, B):
        """Lambda^-1/2 B. Consumers treat the row layout as opaque and pair
        whiten_rows only with whiten_rows_T."""
        return B / torch.sqrt(self.d)[:, None]

    def whiten_rows_T(self, Z):
        """Adjoint of whiten_rows: the whitened-row layout back to (n, k)."""
        return Z / torch.sqrt(self.d)[:, None]

    def trace(self):
        return torch.sum(self.d)


def _gather_blocks(B, idx, mask):
    """Rows of B (n, k) in the padded block layout (nb, bmax, k), padded
    lanes zero."""
    return B[idx.reshape(-1)].reshape(*idx.shape, B.shape[1]) * mask[..., None]


def _scatter_blocks(Zb, idx, mask, n):
    """Adjoint of _gather_blocks: (nb, bmax, k) back to (n, k); each index
    appears once among the unmasked lanes."""
    k = Zb.shape[-1]
    out = Zb.new_zeros((n, k))
    return out.index_add(0, idx.reshape(-1), (Zb * mask[..., None]).reshape(-1, k))


@module(static=("block_idx", "block_mask", "n"))
class _BlockDiagLambda(Module):
    """Block-diagonal Lambda over a padded uniform partition.

    chols: (nb, bmax, bmax) lower Cholesky factors of the padded blocks,
    identity rows and columns on padding, so padded lanes add nothing to the
    log-determinant and solve exactly. block_idx (nb, bmax) int64 and
    block_mask (nb, bmax) 0/1 in the data's dtype encode the partition of
    range(n)."""

    chols: Any
    ok: Any
    block_idx: Any = None
    block_mask: Any = None
    n: int = 0

    def solve(self, B):
        """Lambda^-1 B, B (n,) or (n, k): a solve against each block's
        factor, the padded lanes masked."""
        vec = B.ndim == 1
        B2 = B[:, None] if vec else B
        idx, mask = self.block_idx, self.block_mask
        Xb = solve_upper(self.chols, solve_lower(self.chols, _gather_blocks(B2, idx, mask)))
        out = _scatter_blocks(Xb, idx, mask, B2.shape[0])
        return out[:, 0] if vec else out

    def logdet(self):
        # padded diagonal entries are 1: log contribution 0
        return 2.0 * torch.sum(torch.log(self.chols.diagonal(dim1=-2, dim2=-1)))

    def whiten_rows(self, B):
        """Blockwise L_b^-1 B in the padded (nb * bmax, k) layout, padded
        lanes zero; paired only with whiten_rows_T (their composition is
        Lambda^-1)."""
        Wb = solve_lower(self.chols, _gather_blocks(B, self.block_idx, self.block_mask))
        return (Wb * self.block_mask[..., None]).reshape(-1, B.shape[1])

    def whiten_rows_T(self, Z):
        """Adjoint: blockwise L_b^-T on the padded rows, scattered back to
        (n, k)."""
        idx, mask = self.block_idx, self.block_mask
        Zb = Z.reshape(*idx.shape, Z.shape[1]) * mask[..., None]
        return _scatter_blocks(solve_upper(self.chols, Zb), idx, mask, self.n)

    def trace(self):
        """tr(Lambda): the squared entries of the block factors' unmasked
        rows."""
        return torch.sum((self.chols ** 2) * self.block_mask[:, :, None])


# ---------------------------------------------------------------------------
# Shared low-rank PD matrix
# ---------------------------------------------------------------------------


@module(static=())
class LowRankPD(Module):
    """Sigma = Kfu Kuu^-1 Kuf + Lambda, factorized for O(n m^2) algebra.

    R (m, m) upper with R^T R = Kuu + Kuf Lambda^-1 Kfu, and Qw the data rows
    of Q from the reduced QR of [Lambda^-1/2 Kfu; Luu^T]. The normal
    equations' Cholesky in the working precision is not used: in f32 its
    error is eps cond(R^T R), which for smooth kernels gave negative
    quadratic forms; the projector form needs no n-side triangular solve.
    In f32 the QR itself is a shifted Cholesky QR whose Grams are float64
    (`_qr`): their error is float64's, the shift keeps the first factor
    from failing, and two more passes restore Q's orthogonality; in f64 it
    is Householder's."""

    Luu: Any  # (m, m) Cholesky factor of Kuu + jitter
    Kuf: Any  # (m, n)
    Qw: Any  # (n', m)
    R: Any  # (m, m) upper
    lam: Any  # _DiagLambda or _BlockDiagLambda
    ok: Any  # () bool

    @property
    def Lqr(self):
        """Lower Cholesky factor of R^T R (for m-side solves)."""
        return self.R.T

    def solve(self, B):
        """Sigma^-1 B = Lambda^-1/2 (I - Qw Qw^T) Lambda^-1/2 B."""
        vec = B.ndim == 1
        Bm = B[:, None] if vec else B
        w = self.lam.whiten_rows(Bm)
        out = self.lam.whiten_rows_T(w - self.Qw @ (self.Qw.T @ w))
        return out[:, 0] if vec else out

    def logdet(self):
        """The determinant lemma."""
        return (2.0 * torch.sum(torch.log(self.R.diagonal()))
                - chol_logdet(self.Luu) + self.lam.logdet())

    def quad(self, y):
        """y^T Sigma^-1 y = ||w||^2 - ||Qw^T w||^2, w = Lambda^-1/2 y."""
        w = self.lam.whiten_rows(y[:, None])
        t = self.Qw.T @ w
        return torch.sum(w * w) - torch.sum(t * t)

    def trace(self):
        """tr(Sigma) = ||Luu^-1 Kuf||_F^2 + tr(Lambda)."""
        Lk = solve_lower(self.Luu, self.Kuf)
        return torch.sum(Lk * Lk) + self.lam.trace()

    def dense(self):
        """The n x n matrix (tests only)."""
        Lk = solve_lower(self.Luu, self.Kuf)
        Q = Lk.T @ Lk
        if isinstance(self.lam, _DiagLambda):
            return add_diag(Q, self.lam.d)
        idx, mask = self.lam.block_idx, self.lam.block_mask
        blocks = self.lam.chols @ self.lam.chols.transpose(-1, -2)
        blocks = blocks * (mask[:, :, None] * mask[:, None, :])
        Lam = Q.new_zeros(Q.shape)
        Lam.index_put_((idx[:, :, None].expand_as(blocks), idx[:, None, :].expand_as(blocks)),
                       blocks, accumulate=True)
        return Q + Lam

    def alpha_u(self, r):
        """(R^T R)^-1 Kuf Lambda^-1 r = R^-1 Qw^T Lambda^-1/2 r."""
        t = self.Qw.T @ self.lam.whiten_rows(r[:, None])
        return torch.linalg.solve_triangular(self.R, t, upper=True)[:, 0]


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------


def _common_pieces(kernel, Xu, X):
    Kuu = kernel.gram(Xu)
    # Kuu of a smooth kernel is badly conditioned: in f32 the whitening
    # needs cond(Luu) <~ 1e4 for the FITC/FSA residuals to stay accurate, so
    # the jitter is relative to the diagonal's scale (f64 keeps 1e-10)
    rel = 1e-10 if X.dtype == torch.float64 else 1e-4
    scale = torch.clamp(torch.max(Kuu.diagonal()), min=1.0)
    Luu, ok_uu = safe_cholesky(add_diag(Kuu, rel * scale))
    Kuf = kernel.gram(Xu, X)
    return Kuu, Luu, ok_uu, Kuf


class _VjpMark(torch.autograd.Function):
    """The identity on its tensors. Its backward launches a marker of the
    QR's VJP (`gp.qr.vjp`): after the QR (end False) the VJP's begin, with
    the VJP counted in `QR_SHAPES`; before it (end True) the VJP's end."""

    generate_vmap_rule = True

    @staticmethod
    def forward(end, shape, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.end, ctx.shape = inputs[0], inputs[1]

    @staticmethod
    def backward(ctx, *grads):
        if not ctx.end:
            QR_SHAPES[("qr_vjp", *ctx.shape)] += 1
        profiling.mark("gp.qr.vjp", ctx.end, grads[0])
        return (None, None, *grads)


def _chol_inv_t(G):
    """(R^-1, R, ok) for R the upper Cholesky factor of the symmetric G:
    R^-1 from one m x m triangular solve against the identity, so the
    n-side product by it is a GEMM, not a triangular solve. A failed factor
    is the identity, so what follows stays finite; `ok` says so on the
    device."""
    L, ok = safe_cholesky(G)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False).mT, L.mT, ok


# float64's unit roundoff
_U64 = 2.0 ** -53


class _CholQR3(torch.autograd.Function):
    """The reduced QR of A (rows >= columns) as a mixed-precision shifted
    Cholesky QR in three passes: (Q, R, ok), Q and R in A's dtype, R's
    diagonal positive, ok a device bool (all three Cholesky factors
    succeeded).

    Pass 1: G1 = A^T A in float64, shifted by s = 11 (rows cols + cols
    (cols + 1)) u64 ||A||_F^2 (||A||_F^2 = tr G1), Fukaya et al.'s shift,
    under which the factor of G1 + s I succeeds for any finite A; R1 = chol(G1 +
    s I)^T, Q1 = A R1^-1, whose condition number is about sqrt(s) / sigma_min
    (A). Passes 2 and 3: G = Q^T Q unshifted, R_k = chol(G)^T, Q <- Q R_k^-1;
    R = R3 R2 R1. Every n-side step is a float64 GEMM: cuBLAS runs them on
    the tensor cores. The backward is the closed-form VJP of the reduced QR,
    as `torch.linalg.qr`'s backward computes it for rows >= columns:
    dA = (dQ + Q sym(triu(dR R^T - Q^T dQ))) R^-T, sym(X) = X + X^T with the
    diagonal once. Both are vmappable (`generate_vmap_rule`): the samplers
    vmap a sparse model's target over chains."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A):
        rows, cols = A.shape
        Q = A.to(torch.float64)
        G = Q.mT @ Q
        shift = 11 * (rows * cols + cols * (cols + 1)) * _U64 * G.diagonal().sum()
        X, R, ok = _chol_inv_t(add_diag(G, shift))
        Q = Q @ X  # A's float64 copy is freed here
        for _ in range(2):
            X, Rk, okk = _chol_inv_t(Q.mT @ Q)
            Q, R, ok = Q @ X, Rk @ R, ok & okk  # R upper: a product of upper factors
        return Q.to(A.dtype), R.to(A.dtype), ok

    @staticmethod
    def setup_context(ctx, inputs, output):
        Q, R, ok = output
        ctx.mark_non_differentiable(ok)
        ctx.save_for_backward(Q, R)

    @staticmethod
    def backward(ctx, dQ, dR, _):
        Q, R = ctx.saved_tensors
        M = torch.triu(dR @ R.mT - Q.mT @ dQ)
        dA = Q @ (M + torch.triu(M, 1).mT) + dQ
        return torch.linalg.solve_triangular(R.mT, dA, upper=False, left=False)


def _qr(A):
    """The reduced QR of A (rows >= columns) between the markers of
    `gp.qr.fwd`, its VJP between those of `gp.qr.vjp`: (Q, R, ok), ok a
    device bool. A float32 A takes the mixed-precision shifted Cholesky QR
    (`_CholQR3`, ok its factors'; Q orthogonal to float32's rounding up to
    cond(A) 1e10 at least), any other `torch.linalg.qr` (ok True).
    Counted by shape in `QR_SHAPES` and by route in `QR_ROUTES`."""
    shape = tuple(A.shape)
    (A,) = _VjpMark.apply(True, shape, A)
    with profiling.bracket("gp.qr.fwd", A):
        if A.dtype == torch.float32:
            route = "cholqr3"
            Q, R, ok = _CholQR3.apply(A)
        else:
            route = "householder"
            Q, R = torch.linalg.qr(A, mode="reduced")
            ok = torch.ones((), dtype=torch.bool, device=A.device)
    QR_SHAPES[("qr", *shape)] += 1
    QR_ROUTES[(route, *shape)] += 1
    return (*_VjpMark.apply(False, shape, Q, R), ok)


def _finish(Luu, ok_uu, Kuf, lam):
    """R^T R = Kuu + Kuf Lambda^-1 Kfu from the reduced QR of
    [Lambda^-1/2 Kfu; Luu^T] (rows >= columns), R's diagonal made positive
    (the float32 route's already is; `_qr` says which dtype takes which
    route)."""
    W = lam.whiten_rows(Kuf.T)  # (n', m)
    Q, R, ok_qr = _qr(torch.cat([W, Luu.T]))
    s = torch.sign(R.diagonal())
    s = torch.where(s == 0, torch.ones_like(s), s)
    R = s[:, None] * R
    Qw = Q[: W.shape[0]] * s[None, :]
    ok = ok_uu & ok_qr & torch.isfinite(R).all() & (R.diagonal() > 0).all()
    lam_ok = getattr(lam, "ok", None)
    if lam_ok is not None:
        ok = ok & lam_ok
    return LowRankPD(Luu=Luu, Kuf=Kuf, Qw=Qw, R=R, lam=lam, ok=ok)


@module(static=())
class SubsetOfRegsStrategy(Module):
    """SoR: Lambda = sigma^2 I."""

    inducing: Any  # (m, d)

    def build(self, kernel, noise_var, X) -> LowRankPD:
        _, Luu, ok_uu, Kuf = _common_pieces(kernel, self.inducing, X)
        d = noise_var.expand(X.shape[0])
        return _finish(Luu, ok_uu, Kuf, _DiagLambda(d=d))

    def predict_mvn(self, pd: LowRankPD, kernel, X, r, alpha, Xs, full_cov: bool,
                    blockindpred=None):
        """mu = Kxu alpha_u, Sigma = Kxu (R^T R)^-1 Kux. `blockindpred` is
        FSA's; every other strategy takes and ignores it."""
        Kux = kernel.gram(self.inducing, Xs)
        mu_cross = Kux.T @ pd.alpha_u(r)
        Lck = solve_lower(pd.Lqr, Kux)
        if full_cov:
            return mu_cross, Lck.T @ Lck
        return mu_cross, torch.clamp(torch.sum(Lck * Lck, dim=0), min=0.0)


@module(static=())
class DeterminTrainCondStrat(Module):
    """DTC: SoR's train covariance; predictive variance Sigma_xx - Q_xx +
    Sigma_SoR."""

    inducing: Any

    def build(self, kernel, noise_var, X) -> LowRankPD:
        return SubsetOfRegsStrategy(inducing=self.inducing).build(kernel, noise_var, X)

    def predict_mvn(self, pd, kernel, X, r, alpha, Xs, full_cov, blockindpred=None):
        Kux = kernel.gram(self.inducing, Xs)
        mu_cross = Kux.T @ pd.alpha_u(r)
        Lck = solve_lower(pd.Lqr, Kux)  # (R^T R)^-1/2 Kux
        Lq = solve_lower(pd.Luu, Kux)  # Kuu^-1/2 Kux, for Qxx
        if full_cov:
            return mu_cross, kernel.gram(Xs) - Lq.T @ Lq + Lck.T @ Lck
        var = kernel.diag(Xs) - torch.sum(Lq * Lq, dim=0) + torch.sum(Lck * Lck, dim=0)
        return mu_cross, torch.clamp(var, min=0.0)


@module(static=())
class FullyIndepStrat(Module):
    """FITC: Lambda = sigma^2 I + diag(Kff - Qff); DTC's predictive."""

    inducing: Any

    def build(self, kernel, noise_var, X) -> LowRankPD:
        _, Luu, ok_uu, Kuf = _common_pieces(kernel, self.inducing, X)
        Lk = solve_lower(Luu, Kuf)
        qdiag = torch.sum(Lk * Lk, dim=0)
        # clamp the residual (>= 0 in exact arithmetic) BEFORE adding the
        # noise, so an f32 overshoot of qdiag past kdiag cannot take Lambda
        # below the noise floor
        d = noise_var + torch.clamp(kernel.diag(X) - qdiag, min=0.0)
        d = torch.clamp(d, min=default_jitter(X.dtype))
        return _finish(Luu, ok_uu, Kuf, _DiagLambda(d=d))

    def predict_mvn(self, pd, kernel, X, r, alpha, Xs, full_cov, blockindpred=None):
        return DeterminTrainCondStrat(inducing=self.inducing).predict_mvn(
            pd, kernel, X, r, alpha, Xs, full_cov)


def _pad(blocks):
    """Padded (idx, mask) tuples of a list of index lists."""
    bmax = max((len(b) for b in blocks), default=0)
    idx = tuple(tuple(b) + (0,) * (bmax - len(b)) for b in blocks)
    mask = tuple((1.0,) * len(b) + (0.0,) * (bmax - len(b)) for b in blocks)
    return idx, mask


def _pad_blocks(blocks, n):
    """Validate a partition of range(n) and pad it to one width."""
    seen = sorted(i for b in blocks for i in b)
    if seen != list(range(n)):
        raise ValueError("blockindices must partition all observation indices")
    return _pad(blocks)


def pad_pred_blocks(blockindpred, ns, nb):
    """Normalize per-training-block prediction-point assignments into padded
    (idx, mask) tuples for the FSA predictive.

    blockindpred: one sequence of prediction-point indices per training
    block (len == nb); indices disjoint and in range(ns). Test points not
    assigned anywhere get no cross-Lambda correction."""
    blocks = [list(b) for b in blockindpred]
    if len(blocks) != nb:
        raise ValueError(
            f"blockindpred must have one entry per training block "
            f"({nb}), got {len(blocks)}")
    flat = [i for b in blocks for i in b]
    if len(set(flat)) != len(flat):
        raise ValueError("blockindpred assigns a test point twice")
    if flat and (min(flat) < 0 or max(flat) >= ns):
        raise ValueError("blockindpred index out of range")
    if not flat:
        raise ValueError("blockindpred assigns no test points")
    return _pad(blocks)


def _block_gram(kernel, A, B=None):
    """The gram of every block at once: (nb, p, q) from (nb, p, d) and
    (nb, q, d), the kernel's parameters shared; one launch of the gram
    kernel for a stationary kernel."""
    if B is None:
        return torch.func.vmap(kernel.gram)(A)
    return torch.func.vmap(kernel.gram)(A, B)


@module(static=("block_idx", "block_mask"))
class FullScaleApproxStrat(Module):
    """FSA: Lambda block-diagonal with blocks K(Xb, Xb) - Q(Xb, Xb) +
    sigma^2 I over a partition of the observations, padded to one block
    width. block_idx (nb, bmax) int64 and block_mask (nb, bmax) 0/1 live on
    the model's device."""

    inducing: Any
    block_idx: Any = None
    block_mask: Any = None

    def build(self, kernel, noise_var, X) -> LowRankPD:
        _, Luu, ok_uu, Kuf = _common_pieces(kernel, self.inducing, X)
        idx = self.block_idx
        mask = self.block_mask.to(X.dtype)
        Xb = X[idx.reshape(-1)].reshape(*idx.shape, X.shape[1])
        Lk_b = _gather_blocks(solve_lower(Luu, Kuf).T, idx, mask)  # (nb, bmax, m)
        R = _block_gram(kernel, Xb) - Lk_b @ Lk_b.transpose(-1, -2)
        R = R * (mask[:, :, None] * mask[:, None, :])
        # padded rows and columns collapse to the identity
        R = add_diag(R, mask * noise_var + (1.0 - mask))
        L, info = torch.linalg.cholesky_ex(add_diag(R, mask * default_jitter(X.dtype)))
        ok_lam = (info == 0).all() & torch.isfinite(L).all()
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        chols = torch.where(ok_lam, L, eye)
        lam = _BlockDiagLambda(chols=chols, ok=ok_lam, block_idx=idx, block_mask=mask,
                               n=X.shape[0])
        return _finish(Luu, ok_uu, Kuf, lam)

    def predict_mvn(self, pd, kernel, X, r, alpha, Xs, full_cov, blockindpred=None):
        """mu = Kxu alpha_u + Lam_xf alpha, Sigma = Sigma_xx - (Qxf + Lam_xf)
        Sigma^-1 (Qxf + Lam_xf)^T. Without prediction blocks Lam_xf = 0: test
        points are their own blocks. blockindpred: padded (idx, mask) tuples
        from pad_pred_blocks; Lam_xf[i, j] = K(x*_i, x_j) - Q(x*_i, x_j) where
        test point i shares a block with training point j, built by one
        batched cross gram over the blocks and a masked scatter-add."""
        Kux = kernel.gram(self.inducing, Xs)
        mu_cross = Kux.T @ pd.alpha_u(r)
        Qxf = solve_lower(pd.Luu, Kux).T @ solve_lower(pd.Luu, pd.Kuf)  # (ns, n)
        if blockindpred is not None:
            pidx = torch.as_tensor(blockindpred[0], dtype=torch.int64, device=X.device)
            pmask = torch.as_tensor(blockindpred[1], dtype=X.dtype, device=X.device)
            fidx, fmask = self.block_idx, self.block_mask.to(X.dtype)
            Xs_b = Xs[pidx.reshape(-1)].reshape(*pidx.shape, Xs.shape[1])
            X_b = X[fidx.reshape(-1)].reshape(*fidx.shape, X.shape[1])
            Kb = _block_gram(kernel, Xs_b, X_b)  # (nb, pmax, fmax)
            rows = pidx[:, :, None].expand_as(Kb)
            cols = fidx[:, None, :].expand_as(Kb)
            w = pmask[:, :, None] * fmask[:, None, :]
            Lam_xf = torch.zeros_like(Qxf).index_put(
                (rows, cols), (Kb - Qxf[rows, cols]) * w, accumulate=True)
            mu_cross = mu_cross + Lam_xf @ alpha
            Qxf = Qxf + Lam_xf
        SinvQL = pd.solve(Qxf.T)  # (n, ns)
        if full_cov:
            return mu_cross, kernel.gram(Xs) - Qxf @ SinvQL
        var = kernel.diag(Xs) - torch.sum(Qxf.T * SinvQL, dim=0)
        return mu_cross, torch.clamp(var, min=0.0)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def _sparse_gpe(x, y, mean, kernel, lognoise, device, make_strategy):
    from .gpe import GPE

    m = GPE(x, y, mean, kernel, lognoise, device=device)
    m.covstrat = make_strategy(m)
    return m


def _inducing(m, inducing):
    from .gpe import _as_X

    return _as_X(inducing, dtype=m.dtype, device=m.device)


def SoR(x, inducing, y, mean=None, kernel=None, lognoise=-2.0, device=None):
    return _sparse_gpe(x, y, mean, kernel, lognoise, device, lambda m: SubsetOfRegsStrategy(
        inducing=_inducing(m, inducing)))


def DTC(x, inducing, y, mean=None, kernel=None, lognoise=-2.0, device=None):
    return _sparse_gpe(x, y, mean, kernel, lognoise, device, lambda m: DeterminTrainCondStrat(
        inducing=_inducing(m, inducing)))


def FITC(x, inducing, y, mean=None, kernel=None, lognoise=-2.0, device=None):
    return _sparse_gpe(x, y, mean, kernel, lognoise, device, lambda m: FullyIndepStrat(
        inducing=_inducing(m, inducing)))


def FSA(x, inducing, blockindices, y, mean=None, kernel=None, lognoise=-2.0, device=None):
    def make(m):
        idx, mask = _pad_blocks([list(b) for b in blockindices], m.nobs)
        return FullScaleApproxStrat(
            inducing=_inducing(m, inducing),
            block_idx=torch.as_tensor(idx, dtype=torch.int64, device=m.device),
            block_mask=torch.as_tensor(mask, dtype=m.dtype, device=m.device))

    return _sparse_gpe(x, y, mean, kernel, lognoise, device, make)
