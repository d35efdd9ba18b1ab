"""Dense linear algebra for GP inference (counterpart of
`gaussianprocesses_jl_tpu/ops/linalg.py`).

The factorization, solves and products are library calls (cuSOLVER and
cuBLAS through `torch.linalg` and `torch.matmul` on the card), the work the
JAX package leaves to XLA. Float32 products run in full float32: the package
never turns on TF32, which failed to factorize GP grams at a noise variance
of 1e-2 or below.

`dense_quad_logdet` keeps the JAX package's gradient: its backward forms
K^-1 explicitly from the triangular inverse (`explicit_kinv`:
`tri_inv_lower`, `tri_syrk_lower`) instead of differentiating through the
Cholesky.
"""
from __future__ import annotations

import torch

__all__ = [
    "add_diag",
    "safe_cholesky",
    "require_pd",
    "solve_lower",
    "solve_upper",
    "chol_solve",
    "chol_logdet",
    "symmetrize",
    "default_jitter",
    "tri_inv_lower",
    "tri_syrk_lower",
    "blocked_cholesky",
    "dense_quad_logdet",
    "set_grad_gemm_precision",
]


def default_jitter(dtype) -> float:
    """Stabilizing nugget matched to the working precision: 1e-10 in f64,
    1e-5 in f32."""
    return 1e-10 if dtype == torch.float64 else 1e-5


def add_diag(K: torch.Tensor, v) -> torch.Tensor:
    """K + diag(v) (v scalar or vector) without materializing a diagonal
    matrix."""
    diag = K.diagonal(dim1=-2, dim2=-1)
    return K.diagonal_scatter(diag + v, dim1=-2, dim2=-1)


def symmetrize(K: torch.Tensor) -> torch.Tensor:
    return 0.5 * (K + K.transpose(-1, -2))


def _chol(K: torch.Tensor):
    """(L, ok): the Cholesky factor and whether it succeeded. cholesky_ex
    never raises; ok is a device tensor, so nothing waits for the card."""
    L, info = torch.linalg.cholesky_ex(K)
    ok = (info == 0) & torch.isfinite(L).all()
    return L, ok


def safe_cholesky(K: torch.Tensor):
    """Lower Cholesky factor plus a success flag. On failure L is the
    identity, so downstream solves stay finite; callers gate on `ok`."""
    L, ok = _chol(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return torch.where(ok, L, eye), ok


def require_pd(ok, what: str) -> None:
    """Raise ValueError unless `ok` (a factorization's flag) holds: for
    callers whose result would otherwise belong to safe_cholesky's
    identity, K = I. Reads the flag on the host."""
    if not bool(ok):
        raise ValueError(f"{what}: the covariance is not positive definite at "
                         "the working precision (its Cholesky factorization failed)")


def _as_matrix(B):
    return (B[:, None], True) if B.ndim == 1 else (B, False)


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^-1 B."""
    B2, vec = _as_matrix(B)
    X = torch.linalg.solve_triangular(L, B2, upper=False)
    return X[:, 0] if vec else X


def solve_upper(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^-T B."""
    B2, vec = _as_matrix(B)
    X = torch.linalg.solve_triangular(L.transpose(-1, -2), B2, upper=True)
    return X[:, 0] if vec else X


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 B via two triangular solves."""
    return solve_upper(L, solve_lower(L, B))


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """log det(L L^T) = 2 sum log diag(L)."""
    return 2.0 * torch.sum(torch.log(L.diagonal(dim1=-2, dim2=-1)), dim=-1)


def blocked_cholesky(K: torch.Tensor, block: int = 512) -> tuple:
    """Left-looking blocked Cholesky with fused log-det: (L, logdet).

    Panels are factorized by `torch.linalg.cholesky_ex` and solved through
    their triangular inverse, one triangular solve against the identity
    (on an H100 faster than `tri_inv_lower`'s recursion at blocks 512 and
    1000, `perf/kinv_study.py`); every cross-panel update is one GEMM. The
    trailing panel is factorized at its true size. NaNs propagate on an
    indefinite input (gate with safe_cholesky). Not routed by the package:
    `torch.linalg.cholesky_ex` is faster on the card (`perf/bench_study.py
    cholesky`)."""
    n = K.shape[-1]
    B = block
    if n <= B:
        L = torch.linalg.cholesky_ex(K)[0]
        return L, chol_logdet(L)
    nb = -(-n // B)
    sizes = [B] * (nb - 1) + [n - (nb - 1) * B]
    cols = []
    for k in range(nb):
        bk = sizes[k]
        off = k * B
        Acol = K[off:, off:off + bk]
        if k > 0:
            # subtract every finished panel's contribution in ONE GEMM
            P = torch.cat([cols[j][(k - j) * B:, :] for j in range(k)], dim=1)
            Acol = Acol - P @ P[:bk, :].T
        lkk = torch.linalg.cholesky_ex(Acol[:bk, :bk])[0]
        if k + 1 < nb:
            eye = torch.eye(bk, dtype=K.dtype, device=K.device)
            Lpan = Acol[bk:, :] @ torch.linalg.solve_triangular(lkk, eye, upper=False).T
            cols.append(torch.cat([torch.tril(lkk), Lpan], dim=0))
        else:
            cols.append(torch.tril(lkk))
    rows = []
    for i in range(nb):
        bi = sizes[i]
        parts = [cols[j][(i - j) * B:(i - j) * B + bi, :] for j in range(i + 1)]
        pad = n - (i * B + bi)
        if pad:
            parts.append(K.new_zeros((bi, pad)))
        rows.append(torch.cat(parts, dim=1))
    L = torch.cat(rows, dim=0)
    return L, chol_logdet(L)


def tri_inv_lower(L: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Inverse of a lower-triangular matrix by blocked recursive doubling:
    inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]].
    The diagonal blocks are inverted in one batched triangular solve; the
    rest is GEMMs."""
    n = L.shape[-1]
    if n <= block:
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        return torch.linalg.solve_triangular(L, eye, upper=False)
    nb = -(-n // block)
    npad = nb * block
    Lp = L
    if npad != n:
        # pad with an identity tail: its inverse is itself and the padded
        # rows/cols never couple back into the leading n x n block
        Lp = L.new_zeros((npad, npad))
        Lp[:n, :n] = L
        Lp.diagonal()[n:] = 1.0
    diag_blocks = torch.stack(
        [Lp[i * block:(i + 1) * block, i * block:(i + 1) * block] for i in range(nb)])
    eye_b = torch.eye(block, dtype=L.dtype, device=L.device)
    Dinv = torch.linalg.solve_triangular(diag_blocks, eye_b.expand(nb, block, block),
                                         upper=False)

    return _tri_inv_rec(Dinv, Lp, block, 0, npad)[:n, :n]


def _tri_inv_rec(Dinv: torch.Tensor, Lp: torch.Tensor, block: int, i0: int,
                 m: int) -> torch.Tensor:
    """The inverse of Lp's diagonal block [i0, i0 + m), its diagonal blocks'
    inverses in Dinv. A module function, not a closure: a closure that
    calls itself is a reference cycle, and its tensors (Lp, Dinv) would
    wait for the garbage collector after every call."""
    if m == block:
        return Dinv[i0 // block]
    k = max(block, ((m // 2) // block) * block)
    iA = _tri_inv_rec(Dinv, Lp, block, i0, k)
    iC = _tri_inv_rec(Dinv, Lp, block, i0 + k, m - k)
    B = Lp[i0 + k:i0 + m, i0:i0 + k]
    X = -(iC @ (B @ iA))
    top = torch.cat([iA, Lp.new_zeros((k, m - k))], dim=1)
    return torch.cat([top, torch.cat([X, iC], dim=1)], dim=0)


def tri_syrk_lower(Linv: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Linv^T @ Linv for LOWER-TRIANGULAR Linv: block (i, j) needs only rows
    >= i*block of Linv, and the upper block triangle mirrors the lower, so
    about a third of the full GEMM's flops. Block 1024: on an H100 the
    fastest of 512-4096 at n = 3000 and in f32 at 16384 (`perf/kinv_study.py`;
    the JAX package's 2048 was chosen on a TPU)."""
    n = Linv.shape[-1]
    if n <= block:
        return Linv.T @ Linv
    nb = -(-n // block)
    blocks = {}
    for i in range(nb):
        i0, i1 = i * block, min((i + 1) * block, n)
        Li = Linv[i0:, i0:i1]  # nonzero rows of block-column i
        for j in range(i + 1):
            j0, j1 = j * block, min((j + 1) * block, n)
            blocks[(i, j)] = Li.T @ Linv[i0:, j0:j1]
    rows = []
    for i in range(nb):
        row = [blocks[(i, j)] if j <= i else blocks[(j, i)].T for j in range(nb)]
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0)


def explicit_kinv(L: torch.Tensor, w: torch.Tensor) -> tuple:
    """(K^-1, alpha = K^-1 r) from the lower factor L of K and w = L^-1 r:
    the explicit inverse of `dense_quad_logdet`'s backward, as the JAX
    package forms it. The route is the card's fastest of those
    `perf/kinv_study.py` measures inside the graphed headline: L^-1 by the
    recursive doubling (block 256), which beat one cuBLAS triangular solve
    by 1.7-2.1x at n = 3000 and 16384 on an H100, and the whole K^-1 beat
    `torch.cholesky_inverse` by 2.1-2.8x; then the triangular product at
    block 1024."""
    Linv = tri_inv_lower(L)
    return tri_syrk_lower(Linv), Linv.T @ w


_GRAD_GEMM_PRECISIONS = ("highest",)


def set_grad_gemm_precision(precision) -> None:
    """Precision of the gradient-only K^-1 GEMM. Only "highest" (full
    precision of the working dtype) exists here: the JAX package's cheaper
    setting (3-pass bf16 on the TPU) would be TF32 on the card, which the
    package does not use."""
    if str(precision).lower() not in _GRAD_GEMM_PRECISIONS:
        raise ValueError(
            f"grad GEMM precision {precision!r} is not supported; only 'highest'")


class _DenseQuadLogdet(torch.autograd.Function):
    """Forward and backward in plain PyTorch operations, so `torch.func.vmap`
    batches both by itself (`generate_vmap_rule`): a vmapped GPE target
    factors every chain's K in one batched call. The factor L and the
    whitened w come out as extra, non-differentiable outputs, the form in
    which `setup_context` can keep them for the backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(K, r):
        L, ok = _chol(K)
        w = solve_lower(L, r)
        return torch.sum(w * w), chol_logdet(L), ok, L, w

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, ok, L, w = output
        ctx.save_for_backward(L, w)
        ctx.mark_non_differentiable(ok, L, w)

    @staticmethod
    def backward(ctx, quad_bar, logdet_bar, _ok, _L, _w):
        L, w = ctx.saved_tensors
        Kinv, alpha = explicit_kinv(L, w)
        # d quad / dK = -αα^T ; d logdet / dK = K^-1  (both symmetric)
        K_bar = logdet_bar * Kinv - quad_bar * torch.outer(alpha, alpha)
        r_bar = (2.0 * quad_bar) * alpha
        return K_bar, r_bar


def dense_quad_logdet(K: torch.Tensor, r: torch.Tensor):
    """(r^T K^-1 r, logdet K, ok) for a dense PSD K. The backward replaces
    the Cholesky VJP's triangular solves with an explicit K^-1 built from
    the triangular inverse. On a failed factorization the values are
    meaningless and ok is False."""
    return _DenseQuadLogdet.apply(K, r)[:3]
