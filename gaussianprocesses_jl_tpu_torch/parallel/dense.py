"""Distributed exact-GP covariance strategies (counterpart of
`gaussianprocesses_jl_tpu/parallel/dense.py`).

`DistributedFullCovariance` is a drop-in `covstrat` for `GPE` and `GPA`:
the train covariance K = k(X, X) + noise I is built, factorized, solved and
differentiated in block-cyclic tile-column shards over a mesh axis
(`parallel/cholesky.py`), so K never exists on one process. The model's
target and gradient go through the fused `quad_logdet` (GPE) and
`latent_f` (GPA) hooks, which `gpe_mll` and `gpa_ll` call when a strategy
declares them; prediction goes through `build` and the dense strategy's
predictive on the distributed solves.
"""
from __future__ import annotations

from typing import Any

import torch

from ..models.covariance import FullCovariance
from ..utils.modules import Module, module
from .cholesky import (
    build_tiles,
    choose_tile_size,
    distributed_chol_solve,
    distributed_cholesky,
    distributed_quad_logdet,
    distributed_solve_lower,
    distributed_unwhiten,
    distributed_unwhiten_build,
    identity_tiles,
)

__all__ = ["DistributedPD", "DistributedFullCovariance", "AmbientFullCovariance"]


@module(static=("mesh", "axis", "B"))
class DistributedPD(Module):
    """A PD matrix held as this process's tile-columns of its lower Cholesky
    factor, with the protocol of `models.covariance.DensePD` (solve, whiten,
    unwhiten, logdet, quad and the `ok` flag). On a failed factorization the
    factor is the identity and `ok` is False. Its solves are not
    differentiable (the differentiable paths are the strategy's fused
    hooks)."""

    L_tiles: Any  # (nb, nbl, B, B)
    logdet_value: Any  # ()
    ok: Any  # () bool
    mesh: Any
    axis: str
    B: int

    def solve(self, Bmat):
        return distributed_chol_solve(self.L_tiles, Bmat, self.B, self.mesh, self.axis)

    def whiten(self, Bmat):
        return distributed_solve_lower(self.L_tiles, Bmat, self.B, self.mesh, self.axis)

    def unwhiten(self, v):
        return distributed_unwhiten(self.L_tiles, v, self.B, self.mesh, self.axis)

    def logdet(self):
        return self.logdet_value

    def quad(self, y):
        w = self.whiten(y)
        return torch.sum(w * w)


@module(static=("mesh", "axis", "B"))
class DistributedFullCovariance(Module):
    """Exact dense covariance sharded over `mesh` axis `axis` with tile size
    B (None: the largest valid size, `choose_tile_size`, at build time).
    Needs n % (B * mesh.shape[axis]) == 0: pad the data or pass B.

    Serves GPE (the fused quad_logdet, whose backward builds K^-1's columns
    with a ring GEMM) and GPA (the whitened-latent map f = L v,
    differentiated through the distributed factorization), under
    `torch.func.vmap` too, so the samplers' chains batch over it."""

    mesh: Any
    axis: str = "j"
    B: int | None = None

    supports_whitened_latents = True
    # explicit protocol flag: gpa_ll routes through latent_f() only when a
    # strategy declares it
    supports_fused_latent_f = True

    def _tile(self, n: int) -> int:
        if self.B is not None:
            return self.B
        return choose_tile_size(n, self.mesh.shape[self.axis])

    def build(self, kernel, noise_var, X) -> DistributedPD:
        B = self._tile(X.shape[0])
        with torch.no_grad():
            tiles = build_tiles(kernel, noise_var, X, B, self.mesh, self.axis)
        L_tiles, logdet, ok = distributed_cholesky(tiles, self.mesh, self.axis, return_ok=True)
        # the identity keeps downstream solves finite; callers gate on ok
        eye = identity_tiles(X.shape[0] // B, B, self.mesh, self.axis, L_tiles.dtype,
                             L_tiles.device)
        return DistributedPD(L_tiles=torch.where(ok, L_tiles, eye),
                             logdet_value=torch.where(ok, logdet, torch.zeros_like(logdet)),
                             ok=ok, mesh=self.mesh, axis=self.axis, B=B)

    def quad_logdet(self, kernel, noise_var, X, r):
        """Fused (r^T K^-1 r, logdet K, ok): the differentiable mll path."""
        B = self._tile(X.shape[0])
        tiles = build_tiles(kernel, noise_var, X, B, self.mesh, self.axis)
        return distributed_quad_logdet(tiles, r, B, self.mesh, self.axis)

    def latent_f(self, kernel, noise_var, X, v):
        """(f, ok) with f = L v: the whitened-latent map of a GPA target,
        differentiable in the kernel's parameters, the noise and v."""
        B = self._tile(X.shape[0])
        tiles = build_tiles(kernel, noise_var, X, B, self.mesh, self.axis)
        return distributed_unwhiten_build(tiles, v, B, self.mesh, self.axis)

    def predict_mvn(self, pd: DistributedPD, kernel, X, r, alpha, Xs, full_cov: bool,
                    blockindpred=None):
        """The dense strategy's predictive, its whiten a distributed forward
        substitution."""
        return FullCovariance.predict_mvn(self, pd, kernel, X, r, alpha, Xs, full_cov)


@module(static=("mesh", "axis", "B"))
class AmbientFullCovariance(DistributedFullCovariance):
    """The JAX package's covariance strategy over an ambient mesh axis, for
    chains x j (`sharded_hmc` over `make_pod_mesh({'j': P})`). In the port
    every process runs inside the job and the strategy resolves `axis`
    against the mesh it is given, so it is `DistributedFullCovariance` with
    the JAX class's default tile size, B = 64; it takes the mesh where the
    JAX class takes the axis size. n must satisfy n % (B * P) == 0."""

    mesh: Any
    axis: str = "j"
    B: int = 64
