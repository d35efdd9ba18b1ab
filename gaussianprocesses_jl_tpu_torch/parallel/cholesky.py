"""Distributed dense-GP linear algebra over a process mesh (counterpart of
`gaussianprocesses_jl_tpu/parallel/cholesky.py`).

A right-looking blocked Cholesky with a block-cyclic column layout:

  * K is tiled into an (nb, nb) grid of B x B tiles; tile-column j lives on
    the process at axis coordinate j mod P, whose local column lj is global
    column j = p + P lj. A process holds its tiles as (nb, nb/P, B, B)
    (row tile, local column), the JAX package's layout. Most such tensors
    here are views of the (n, nb/P * B) matrix of the process's columns,
    the layout of the cross gram K(X, X_cols) that `build_tiles` makes;
    the functions work on that matrix and take and give the tile view;
  * each process builds only its own columns of K = k(X, X) + D from the
    replicated (n, d) inputs (one n x n/P gram);
  * at step k the owner factors the diagonal tile (`cholesky_ex`), solves
    the rows below it, and broadcasts the panel; every process subtracts
    the panel's rank-B update from its own columns j > k, rows i >= j (the
    tiles that are not yet final; no masked work);
  * the log-determinant accumulates from the broadcast diagonal tiles, and
    `ok` is the AND over the axis of every diagonal tile's `info == 0`,
    with a finite log-determinant. (The JAX package reads a failure from a
    NaN; `cholesky_ex` leaves a finite partial factor with info > 0.)

`distributed_quad_logdet` and `distributed_unwhiten_build` are
autograd.Functions with the JAX package's backward passes: W = L^-1 on the
process's columns by a right-looking substitution against the identity
(only the blocks that are not zero), then ring GEMMs in which W's column
shards travel around the axis (`shift_`), and the K-cotangent on the
process's columns. Their inputs come from `build_tiles`, whose `copy` of
the replicated kernel and noise sums each process's share of their
gradient. Each has a vmap rule that runs the factorization once for a batch
of chains (every function below takes leading batch dimensions).

The factor and the solves are not differentiable: the differentiable paths
are the two Functions. All contractions run in full float32 (the package
never enables TF32), as the JAX package's `Precision.HIGHEST`.

Every function runs inside the job, on this process's columns, and
resolves `axis` against the caller's `Mesh`; the JAX package's `ambient_*`
variants (for use inside an enclosing shard_map) are therefore the same
code here, kept as aliases that take the mesh.
"""
from __future__ import annotations

import math

import torch

from .collectives import all_ok, allreduce_, broadcast_, copy, copy_module, gather_, shift_

__all__ = [
    "build_tiles",
    "distributed_cholesky",
    "distributed_solve_lower",
    "distributed_solve_upper",
    "distributed_chol_solve",
    "distributed_unwhiten",
    "distributed_unwhiten_build",
    "distributed_quad_logdet",
    "distributed_mll",
    "identity_tiles",
    "tile_and_shard",
    "untile",
    "choose_tile_size",
    "ambient_gram",
    "ambient_cholesky",
    "ambient_identity_tiles",
    "ambient_solve_lower",
    "ambient_solve_upper",
    "ambient_unwhiten",
    "ambient_quad_logdet",
    "ambient_unwhiten_build",
    "ambient_mll",
]

_LOG_2PI = math.log(2.0 * math.pi)


def choose_tile_size(n: int, P_: int, max_B: int = 512) -> int:
    """Largest tile size B <= max_B with n % (B * P_) == 0 (the layout
    needs n a multiple of B and the tile count a multiple of P_)."""
    for B in range(min(max_B, n // P_), 0, -1):
        if n % (B * P_) == 0:
            return B
    raise ValueError(f"no valid tile size for n={n}, P={P_}")


def _layout(mesh, axis: str, n: int, B: int):
    """(P, me, nb, nbl) after checking that n tiles by B over P processes."""
    P_ = mesh.shape[axis]
    if n % B:
        raise ValueError(f"n={n} is not a multiple of the tile size {B}")
    nb = n // B
    if nb % P_:
        raise ValueError(f"{nb} tiles do not divide over {P_} processes on axis {axis!r}")
    return P_, mesh.coords[axis], nb, nb // P_


def _js(me: int, P_: int, nbl: int) -> list:
    """Global tile-columns of this process's local columns."""
    return [me + P_ * lj for lj in range(nbl)]


def _cols(me: int, P_: int, nbl: int) -> slice:
    """`_js` as a slice, to index tiles by: no index tensor to copy to the
    card, so a CUDA graph can capture it."""
    return slice(me, me + P_ * nbl, P_)


def _js_tensor(me: int, P_: int, nbl: int, device) -> torch.Tensor:
    """`_js` as a tensor made on `device`."""
    return me + P_ * torch.arange(nbl, device=device)


def _to_mat(tiles: torch.Tensor) -> torch.Tensor:
    """(..., nb, nbl, B, B) -> (..., nb B, nbl B): a view of the matrix a
    tile view was made from."""
    nb, nbl, B = tiles.shape[-4], tiles.shape[-3], tiles.shape[-1]
    return tiles.transpose(-3, -2).reshape(*tiles.shape[:-4], nb * B, nbl * B)


def _to_tiles(M: torch.Tensor, B: int) -> torch.Tensor:
    """(..., nb B, nbl B) -> the (..., nb, nbl, B, B) tile view."""
    n, c = M.shape[-2:]
    return M.reshape(*M.shape[:-2], n // B, B, c // B, B).transpose(-3, -2)


def _rows_of(y: torch.Tensor, cols: slice, B: int) -> torch.Tensor:
    """Rows of y (..., n, m) in the blocks `cols` (a slice of blocks),
    stacked: (..., blocks B, m)."""
    nb = y.shape[-2] // B
    yb = y.reshape(*y.shape[:-2], nb, B, y.shape[-1])[..., cols, :, :]
    return yb.reshape(*y.shape[:-2], -1, y.shape[-1])


def _cyclic_to_global(g: torch.Tensor, P_: int, dim: int) -> torch.Tensor:
    """Blocks gathered along `dim` in the axis's order (process p's blocks
    p, p + P, ... together) put in global order: block lj P + p is the lj-th
    of process p, so the order is a transpose of the (P, nbl) split, with no
    index tensor to copy to the card."""
    dim %= g.ndim
    nbl = g.shape[dim] // P_
    split = g.reshape(*g.shape[:dim], P_, nbl, *g.shape[dim + 1:])
    return split.transpose(dim, dim + 1).reshape(g.shape)


def _gather_blocks(x_loc: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(..., nbl, B) per process -> (..., nb, B) in global block order."""
    P_ = mesh.shape[axis]
    g = gather_(x_loc, mesh, axis, dim=-2)
    if P_ == 1:
        return g
    return _cyclic_to_global(g, P_, -2)


def tile_and_shard(K: torch.Tensor, B: int, mesh, axis: str = "j") -> torch.Tensor:
    """This process's tile-columns (nb, nbl, B, B) of K (n, n) in the
    block-cyclic order."""
    P_, me, nb, nbl = _layout(mesh, axis, K.shape[-1], B)
    tiles = K.reshape(nb, B, nb, B).transpose(1, 2)
    return tiles[:, _cols(me, P_, nbl)].contiguous()


def untile(tiles_loc: torch.Tensor, B: int, mesh, axis: str = "j") -> torch.Tensor:
    """Inverse of tile_and_shard: every process's columns gathered back to
    the (n, n) matrix."""
    nb = tiles_loc.shape[0]
    P_ = mesh.shape[axis]
    g = _cyclic_to_global(gather_(tiles_loc, mesh, axis, dim=1), P_, 1)
    return g.transpose(1, 2).reshape(nb * B, nb * B)


# ---------------------------------------------------------------------------
# The local gram build
# ---------------------------------------------------------------------------


def build_tiles(kernel, noise_var, X: torch.Tensor, B: int, mesh, axis: str = "j"):
    """This process's tile-columns of K = k(X, X) + diag(noise_var) (noise
    scalar or (n,)), differentiable: one (n x n/P) cross gram
    k(X, X_cols), so the n x n matrix never exists on one process. The
    kernel, the noise and X are replicated and enter shard-local work
    through `copy`. The result is a tile view of the (n, n/P) matrix."""
    n, d = X.shape
    P_, me, nb, nbl = _layout(mesh, axis, n, B)
    kern = copy_module(kernel, mesh, axis)
    nv = (noise_var.to(dtype=X.dtype, device=X.device) if isinstance(noise_var, torch.Tensor)
          else X.new_full((), noise_var))
    nv = copy(nv, mesh, axis)
    Xc = copy(X, mesh, axis)
    Kc = kern.gram(Xc, _rows_of(Xc, _cols(me, P_, nbl), B))  # (n, nbl B)
    rows = (_js_tensor(me, P_, nbl, X.device)[:, None] * B
            + torch.arange(B, device=X.device)).reshape(-1)
    noise = nv.expand(n)[rows] if nv.ndim == 0 else nv[rows]
    Kc = Kc.index_put((rows, torch.arange(nbl * B, device=X.device)), noise, accumulate=True)
    return _to_tiles(Kc, B)


def identity_tiles(nb: int, B: int, mesh, axis: str = "j", dtype=torch.float64, device=None):
    """The identity in the tile-column layout (the fallback factor when a
    factorization fails)."""
    return _to_tiles(_eye_mat(nb, B, mesh, axis, dtype, device), B)


def _eye_mat(nb, B, mesh, axis, dtype, device):
    P_, me = mesh.shape[axis], mesh.coords[axis]
    nbl = nb // P_
    E = torch.zeros((nb * B, nbl * B), dtype=dtype, device=device)
    for lj, j in enumerate(_js(me, P_, nbl)):
        E[j * B:(j + 1) * B, lj * B:(lj + 1) * B] = torch.eye(B, dtype=dtype, device=device)
    return E


# ---------------------------------------------------------------------------
# Factorization and solves on the process's columns (no gradient)
# ---------------------------------------------------------------------------


def _factor(M: torch.Tensor, B: int, mesh, axis: str):
    """(L, logdet, ok) of the columns M (..., n, nbl B). L in the same
    layout (zeros above the diagonal tiles); logdet and ok replicated."""
    A = M.detach().clone()
    n, c = A.shape[-2:]
    batch = A.shape[:-2]
    P_, me, nb, nbl = _layout(mesh, axis, n, B)
    logdet = A.new_zeros(batch)
    bad = torch.zeros(batch, dtype=torch.bool, device=A.device)
    for k in range(nb):
        owner, lk, r0 = k % P_, k // P_, k * B
        if me == owner:
            cols = slice(lk * B, (lk + 1) * B)
            col = A[..., r0:, cols]
            Lkk, info = torch.linalg.cholesky_ex(col[..., :B, :])
            bad |= info != 0
            panel = torch.empty_like(col)
            panel[..., :B, :] = Lkk
            if r0 + B < n:
                # L[i, k] = A[i, k] Lkk^-T for the rows below
                panel[..., B:, :] = torch.linalg.solve_triangular(
                    Lkk.mT, col[..., B:, :], upper=True, left=False)
            A[..., :r0, cols] = 0.0
            A[..., r0:, cols] = panel
        else:
            panel = A.new_empty((*batch, n - r0, B))
        panel = broadcast_(panel, mesh, axis, owner)
        logdet = logdet + 2.0 * torch.log(
            torch.diagonal(panel[..., :B, :], dim1=-2, dim2=-1)).sum(-1)
        # trailing update: local columns j > k, rows i >= j
        for lj in range(max(0, (k - me) // P_ + 1), nbl):
            j = me + P_ * lj
            top = (j - k) * B
            A[..., j * B:, lj * B:(lj + 1) * B] -= (panel[..., top:, :]
                                                    @ panel[..., top:top + B, :].mT)
    ok = all_ok(~bad, mesh, axis) & torch.isfinite(logdet)
    return A, logdet, ok


def _solve_lower(L: torch.Tensor, b: torch.Tensor, B: int, mesh, axis: str) -> torch.Tensor:
    """L^-1 b, b (..., n, m) replicated: forward substitution, one psum of
    the local columns' contributions and one broadcast of the diagonal
    tile a step."""
    n = L.shape[-2]
    P_, me, nb, nbl = _layout(mesh, axis, n, B)
    y = torch.zeros_like(b)
    for k in range(nb):
        owner, lk, r0 = k % P_, k // P_, k * B
        a = max(0, -(-(k - me) // P_))  # local columns j < k
        if a:
            s = L[..., r0:r0 + B, :a * B] @ _rows_of(y, _cols(me, P_, a), B)
        else:
            s = b.new_zeros((*b.shape[:-2], B, b.shape[-1]))
        s = allreduce_(s, mesh, axis)
        Lkk = (L[..., r0:r0 + B, lk * B:(lk + 1) * B] if me == owner
               else L.new_empty((*L.shape[:-2], B, B)))
        Lkk = broadcast_(Lkk, mesh, axis, owner)
        y[..., r0:r0 + B, :] = torch.linalg.solve_triangular(Lkk, b[..., r0:r0 + B, :] - s,
                                                             upper=False)
    return y


def _solve_upper(L: torch.Tensor, b: torch.Tensor, B: int, mesh, axis: str) -> torch.Tensor:
    """L^-T b: backward substitution; tile-column k lives on its owner,
    which solves and broadcasts block k."""
    n = L.shape[-2]
    P_, me, nb, _ = _layout(mesh, axis, n, B)
    y = torch.zeros_like(b)
    for k in range(nb - 1, -1, -1):
        owner, lk, r0 = k % P_, k // P_, k * B
        if me == owner:
            cols = slice(lk * B, (lk + 1) * B)
            rhs = b[..., r0:r0 + B, :] - L[..., r0 + B:, cols].mT @ y[..., r0 + B:, :]
            yk = torch.linalg.solve_triangular(L[..., r0:r0 + B, cols].mT, rhs, upper=True)
        else:
            yk = b.new_empty((*b.shape[:-2], B, b.shape[-1]))
        y[..., r0:r0 + B, :] = broadcast_(yk, mesh, axis, owner)
    return y


def _unwhiten(L: torch.Tensor, v: torch.Tensor, B: int, mesh, axis: str) -> torch.Tensor:
    """L v, v (..., n, m) replicated: the local columns against their rows
    of v, one psum."""
    P_, me, nb, nbl = _layout(mesh, axis, L.shape[-2], B)
    return allreduce_(L @ _rows_of(v, _cols(me, P_, nbl), B), mesh, axis)


def _winv(L: torch.Tensor, B: int, mesh, axis: str) -> torch.Tensor:
    """W = L^-1 on this process's columns, (..., n, nbl B), by a
    right-looking substitution against the identity: at step k the owner
    broadcasts column k of L (rows k..), every process solves row block k
    of its columns j <= k and subtracts the update from the rows below.
    The blocks of W above the diagonal stay zero and are never touched."""
    n = L.shape[-2]
    P_, me, nb, nbl = _layout(mesh, axis, n, B)
    W = _eye_mat(nb, B, mesh, axis, L.dtype, L.device).expand(*L.shape).clone()
    for k in range(nb):
        owner, lk, r0 = k % P_, k // P_, k * B
        col = (L[..., r0:, lk * B:(lk + 1) * B] if me == owner
               else L.new_empty((*L.shape[:-2], n - r0, B)))
        col = broadcast_(col, mesh, axis, owner)
        a = (k - me) // P_ + 1 if k >= me else 0  # local columns j <= k
        if not a:
            continue
        Wk = torch.linalg.solve_triangular(col[..., :B, :], W[..., r0:r0 + B, :a * B],
                                           upper=False)
        W[..., r0:r0 + B, :a * B] = Wk
        if r0 + B < n:
            W[..., r0 + B:, :a * B] -= col[..., B:, :] @ Wk
    return W


def _bwd_quad(L, w, quad_bar, logdet_bar, B, mesh, axis):
    """The K-cotangent on this process's columns, G = logdet_bar K^-1 -
    quad_bar a a^T (a = K^-1 r), and r_bar = 2 quad_bar a, from the
    factor L and w = L^-1 r. K^-1's columns come from a ring GEMM: W's
    column shards travel around the axis and each hop fills one process's
    rows, K^-1[:, l] = W[j_l:, :]^T W[j_l:, l] (the rows above j_l of
    column l are zero)."""
    n = L.shape[-2]
    P_, me, nb, nbl = _layout(mesh, axis, n, B)
    W = _winv(L, B, mesh, axis)
    a_loc = (W.mT @ w.unsqueeze(-1)).squeeze(-1)  # (..., nbl B)
    alpha = _gather_blocks(a_loc.reshape(*a_loc.shape[:-1], nbl, B), mesh, axis)
    alpha = alpha.reshape(*alpha.shape[:-2], n)
    G = torch.empty_like(W)
    Gb = G.reshape(*G.shape[:-2], nb, B, nbl * B)
    V = W
    for s in range(P_):
        q = (me - s) % P_
        cols = [V[..., j * B:, :].mT @ W[..., j * B:, lj * B:(lj + 1) * B]
                for lj, j in enumerate(_js(me, P_, nbl))]  # each (..., nbl B, B)
        blocks = torch.cat(cols, dim=-1).reshape(*G.shape[:-2], nbl, B, nbl * B)
        Gb[..., _cols(q, P_, nbl), :, :] = blocks
        if s + 1 < P_:
            V = shift_(V, mesh, axis)
    a_cols = _rows_of(alpha.unsqueeze(-1), _cols(me, P_, nbl), B).squeeze(-1)
    qb = quad_bar[..., None, None]
    G.mul_(logdet_bar[..., None, None]).sub_(qb * alpha.unsqueeze(-1) * a_cols.unsqueeze(-2))
    return G, 2.0 * quad_bar[..., None] * alpha


def _bwd_unwhiten(L, f_bar, v, B, mesh, axis):
    """Reverse mode of f = L(K) v through the factorization (Murray 2016,
    arXiv:1602.07527): v_bar = L^T f_bar and K_bar = L^-T phi(L^T L_bar)
    L^-1 with L_bar = tril(f_bar v^T), phi = tril with halved diagonal, on
    the shards as the JAX package runs it: M = L^T tril(f_bar v^T) from
    the masked rank-one structure, then two ring GEMMs with W = L^-1. The
    result comes out row-sharded; a local tile transpose gives K_bar^T on
    the columns (the same hyperparameter cotangents: dK is symmetric)."""
    n = L.shape[-2]
    P_, me, nb, nbl = _layout(mesh, axis, n, B)
    batch = L.shape[:-2]
    Lt = _to_tiles(L, B)  # (..., nb, nbl, B, B)
    gb = f_bar.reshape(*batch, nb, B)
    vb = v.reshape(*batch, nb, B)
    vbar = _gather_blocks(torch.einsum("...ilab,...ia->...lb", Lt, gb), mesh, axis)
    W = _to_tiles(_winv(L, B, mesh, axis), B)

    # M = L^T tril(f_bar v^T), rows k local:
    # M[(kb,a),(jb,b)] = v[jb,b] (sum_{ib>jb} T[kb][ib,a] + sum_{c>=b} L[jb,kb][c,a] f_bar[jb,c])
    T = torch.einsum("...ilca,...ic->...lia", Lt, gb)  # (..., nbl, nb, B)
    suf = torch.flip(torch.cumsum(torch.flip(T, (-2,)), -2), (-2,)) - T
    ar = torch.arange(B, device=L.device)
    mask_cb = (ar[:, None] >= ar[None, :]).to(L.dtype)
    Ppart = torch.einsum("...jlca,...jc,cb->...ljab", Lt, gb, mask_cb)  # (..., nbl, nb, B, B)
    M = (suf[..., None] + Ppart) * vb[..., None, :, None, :]
    # phi over global (k, j), rows k local: tril with halved diagonal
    jt = _js_tensor(me, P_, nbl, L.device)[:, None]
    coltile = torch.arange(nb, device=L.device)[None, :]
    full = (jt > coltile).to(L.dtype)
    eqt = (jt == coltile).to(L.dtype)
    tri = torch.where(ar[:, None] > ar[None, :], 1.0,
                      torch.where(ar[:, None] == ar[None, :], 0.5, 0.0)).to(L.dtype)
    P2 = M * (full[:, :, None, None] + eqt[:, :, None, None] * tri)

    # ring GEMM 1: A1 = phi(M) W, rows k local, all columns
    A1 = L.new_zeros((*batch, nbl, nb, B, B))
    V = W
    for s in range(P_):
        q = (me - s) % P_
        A1[..., _cols(q, P_, nbl), :, :] = torch.einsum("...lmac,...mqcb->...lqab", P2, V)
        if s + 1 < P_:
            V = shift_(V, mesh, axis)
    # ring GEMM 2: K_bar = W^T A1, rows k local, all columns
    Kb = L.new_zeros((*batch, nbl, nb, B, B))
    Aq = A1
    for s in range(P_):
        q = (me - s) % P_
        Wq = W[..., _cols(q, P_, nbl), :, :, :]
        Kb = Kb + torch.einsum("...qlca,...qjcb->...ljab", Wq, Aq)
        if s + 1 < P_:
            Aq = shift_(Aq, mesh, axis)
    # local tile transpose: row-sharded K_bar -> column-sharded K_bar^T
    nd = len(batch)
    return Kb.permute(*range(nd), nd + 1, nd, nd + 3, nd + 2), vbar.reshape(*batch, n)


# ---------------------------------------------------------------------------
# Public factor and solves (tile layout, replicated right-hand sides)
# ---------------------------------------------------------------------------


def distributed_cholesky(tiles, mesh, axis: str = "j", return_ok: bool = False):
    """Factor this process's tile-columns (from build_tiles or
    tile_and_shard). Returns (L_tiles, logdet), L in the same layout with
    zeros above the diagonal tiles; with return_ok also `ok` (every
    diagonal tile factored, on every process, and a finite logdet).
    Not differentiable."""
    B = tiles.shape[-1]
    with torch.no_grad():
        L, logdet, ok = _factor(_to_mat(tiles), B, mesh, axis)
    L = _to_tiles(L, B)
    return (L, logdet, ok) if return_ok else (L, logdet)


def _apply(fn, L_tiles, b, B, mesh, axis):
    L = _to_mat(L_tiles)
    vec = b.ndim == 1
    bm = b[:, None] if vec else b
    with torch.no_grad():
        y = fn(L, bm.detach(), B, mesh, axis)
    return y[:, 0] if vec else y


def distributed_solve_lower(L_tiles, b, B: int, mesh, axis: str = "j"):
    """L^-1 b with L in the tile layout; b (n,) or (n, m) replicated."""
    return _apply(_solve_lower, L_tiles, b, B, mesh, axis)


def distributed_solve_upper(L_tiles, b, B: int, mesh, axis: str = "j"):
    """L^-T b (backward substitution)."""
    return _apply(_solve_upper, L_tiles, b, B, mesh, axis)


def distributed_chol_solve(L_tiles, b, B: int, mesh, axis: str = "j"):
    """(L L^T)^-1 b via forward and backward substitution."""
    w = distributed_solve_lower(L_tiles, b, B, mesh, axis)
    return distributed_solve_upper(L_tiles, w, B, mesh, axis)


def distributed_unwhiten(L_tiles, v, B: int, mesh, axis: str = "j"):
    """L v for replicated v (n,) or (n, m): the whitened-latent map."""
    return _apply(_unwhiten, L_tiles, v, B, mesh, axis)


# ---------------------------------------------------------------------------
# Differentiable quad + logdet and the whitened-latent map
# ---------------------------------------------------------------------------


def _batched(t, dim, size):
    """`t` with its vmap batch dimension at the front, expanded to `size`
    where it has none."""
    if dim is None:
        return t.expand(size, *t.shape)
    return t.movedim(dim, 0)


class _QuadLogdetBwd(torch.autograd.Function):
    @staticmethod
    def forward(L, w, quad_bar, logdet_bar, B, mesh, axis):
        G, r_bar = _bwd_quad(L, w, quad_bar, logdet_bar, B, mesh, axis)
        return _to_tiles(G, B), r_bar

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("distributed_quad_logdet has no second derivative")

    @staticmethod
    def vmap(info, in_dims, L, w, quad_bar, logdet_bar, B, mesh, axis):
        args = [_batched(t, d, info.batch_size) for t, d in zip((L, w, quad_bar, logdet_bar),
                                                              in_dims)]
        return _QuadLogdetBwd.apply(*args, B, mesh, axis), (0, 0)


class _QuadLogdet(torch.autograd.Function):
    @staticmethod
    def forward(tiles, r, mesh, axis):
        B = tiles.shape[-1]
        L, logdet, ok = _factor(_to_mat(tiles), B, mesh, axis)
        w = _solve_lower(L, r.detach().unsqueeze(-1), B, mesh, axis).squeeze(-1)
        quad = (w * w).sum(-1)
        return quad, logdet, ok & torch.isfinite(quad), L, w

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, ok, L, w = output
        ctx.mesh, ctx.axis, ctx.B = inputs[2], inputs[3], inputs[0].shape[-1]
        ctx.save_for_backward(L, w)
        ctx.mark_non_differentiable(ok, L, w)

    @staticmethod
    def backward(ctx, quad_bar, logdet_bar, _ok, _L, _w):
        L, w = ctx.saved_tensors
        tiles_bar, r_bar = _QuadLogdetBwd.apply(L, w, quad_bar, logdet_bar, ctx.B, ctx.mesh,
                                                ctx.axis)
        return tiles_bar, r_bar, None, None

    @staticmethod
    def vmap(info, in_dims, tiles, r, mesh, axis):
        out = _QuadLogdet.apply(_batched(tiles, in_dims[0], info.batch_size),
                                _batched(r, in_dims[1], info.batch_size), mesh, axis)
        return out, (0,) * 5


def distributed_quad_logdet(tiles, r, B: int, mesh, axis: str = "j"):
    """(r^T K^-1 r, logdet K, ok) for K given as this process's
    tile-columns, r replicated. Differentiable in the tiles and r: the
    backward builds K^-1's columns on the shards (W = L^-1 and a ring
    GEMM), as the JAX package's custom VJP does, and returns r's gradient
    whole on every process."""
    if tiles.shape[-1] != B:
        raise ValueError(f"tiles of size {tiles.shape[-1]}, B={B}")
    return _QuadLogdet.apply(tiles, r, mesh, axis)[:3]


class _UnwhitenBwd(torch.autograd.Function):
    @staticmethod
    def forward(L, f_bar, v, B, mesh, axis):
        return _bwd_unwhiten(L, f_bar, v, B, mesh, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("distributed_unwhiten_build has no second derivative")

    @staticmethod
    def vmap(info, in_dims, L, f_bar, v, B, mesh, axis):
        args = [_batched(t, d, info.batch_size) for t, d in zip((L, f_bar, v), in_dims)]
        return _UnwhitenBwd.apply(*args, B, mesh, axis), (0, 0)


class _UnwhitenBuild(torch.autograd.Function):
    @staticmethod
    def forward(tiles, v, mesh, axis):
        B = tiles.shape[-1]
        L, _, ok = _factor(_to_mat(tiles), B, mesh, axis)
        eye = _eye_mat(L.shape[-2] // B, B, mesh, axis, L.dtype, L.device)
        L = torch.where(ok[..., None, None], L, eye)
        f = _unwhiten(L, v.detach().unsqueeze(-1), B, mesh, axis).squeeze(-1)
        return f, ok, L

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ok, L = output
        ctx.mesh, ctx.axis, ctx.B = inputs[2], inputs[3], inputs[0].shape[-1]
        ctx.save_for_backward(L, inputs[1])
        ctx.mark_non_differentiable(ok, L)

    @staticmethod
    def backward(ctx, f_bar, _ok, _L):
        L, v = ctx.saved_tensors
        tiles_bar, v_bar = _UnwhitenBwd.apply(L, f_bar, v, ctx.B, ctx.mesh, ctx.axis)
        return tiles_bar, v_bar, None, None

    @staticmethod
    def vmap(info, in_dims, tiles, v, mesh, axis):
        out = _UnwhitenBuild.apply(_batched(tiles, in_dims[0], info.batch_size),
                                   _batched(v, in_dims[1], info.batch_size), mesh, axis)
        return out, (0, 0, 0)


def distributed_unwhiten_build(tiles, v, B: int, mesh, axis: str = "j"):
    """(f, ok) with f = L v where L L^T = K is given as this process's
    tile-columns: the whitened-latent map, differentiated through the
    distributed factorization (Murray's reverse mode on the shards). On a
    failed factorization f falls back to v (identity factor) and ok is
    False; callers gate on ok."""
    if tiles.shape[-1] != B:
        raise ValueError(f"tiles of size {tiles.shape[-1]}, B={B}")
    return _UnwhitenBuild.apply(tiles, v, mesh, axis)[:2]


def distributed_mll(kernel, noise_var, X, y_centered, B: int, mesh, axis: str = "j"):
    """Dense-GP marginal likelihood with K sharded over the mesh axis,
    differentiable in the kernel's parameters, the noise and y_centered;
    -inf when the factorization failed."""
    n = X.shape[0]
    tiles = build_tiles(kernel, noise_var, X, B, mesh, axis)
    quad, logdet, ok = distributed_quad_logdet(tiles, y_centered, B, mesh, axis)
    mll = -0.5 * (quad + logdet + n * _LOG_2PI)
    return torch.where(ok, mll, torch.full_like(mll, -math.inf))


# ---------------------------------------------------------------------------
# The JAX package's ambient-axis names
# ---------------------------------------------------------------------------
#
# The JAX package's `ambient_*` functions run inside an enclosing shard_map
# (the chains x j composition), where the functions above, each of which
# opens its own shard_map, cannot. Here every function already runs inside
# the job on this process's columns, so the ambient names are the same
# functions; they take the mesh where the JAX package takes the axis size.


def ambient_gram(kernel, noise_var, X, B: int, mesh, axis: str = "j"):
    """`build_tiles` (the mesh in place of the JAX package's axis size)."""
    return build_tiles(kernel, noise_var, X, B, mesh, axis)


def ambient_cholesky(tiles_loc, mesh, axis: str = "j"):
    """`distributed_cholesky`."""
    return distributed_cholesky(tiles_loc, mesh, axis)


def ambient_identity_tiles(nb: int, B: int, mesh, axis: str = "j", dtype=torch.float64,
                           device=None):
    """`identity_tiles`."""
    return identity_tiles(nb, B, mesh, axis, dtype, device)


def ambient_solve_lower(L_loc, b, B: int, mesh, axis: str = "j"):
    """`distributed_solve_lower`."""
    return distributed_solve_lower(L_loc, b, B, mesh, axis)


def ambient_solve_upper(L_loc, b, B: int, mesh, axis: str = "j"):
    """`distributed_solve_upper`."""
    return distributed_solve_upper(L_loc, b, B, mesh, axis)


def ambient_unwhiten(L_loc, v, B: int, mesh, axis: str = "j"):
    """`distributed_unwhiten`."""
    return distributed_unwhiten(L_loc, v, B, mesh, axis)


def ambient_quad_logdet(tiles_loc, r, B: int, mesh, axis: str = "j"):
    """`distributed_quad_logdet`."""
    return distributed_quad_logdet(tiles_loc, r, B, mesh, axis)


def ambient_unwhiten_build(tiles_loc, v, B: int, mesh, axis: str = "j"):
    """`distributed_unwhiten_build`."""
    return distributed_unwhiten_build(tiles_loc, v, B, mesh, axis)


def ambient_mll(kernel, noise_var, X, y_centered, B: int, mesh, axis: str = "j"):
    """`distributed_mll`."""
    return distributed_mll(kernel, noise_var, X, y_centered, B, mesh, axis)
