"""ElasticGPE: an exact GP that grows by appends, extending its Cholesky
factor (counterpart of `gaussianprocesses_jl_tpu/models/elastic.py`).

The data and the factor live in buffers of `capacity` rows, grown by
`stepsize` rows when an append crosses the capacity: the JAX package's
growth policy, which is the reference's buffer growth. An append of k
points to n extends the factor of K + noise I by its new rows,

    L_new = [[L, 0], [B^T, chol(D - B^T B)]],  B = L^-1 C,

with C = K(X, x_new) through the kernel's gram (on the card, the gram
kernel's cross walk) and D = K(x_new) + noise I: O(capacity^2 k) for each
append in place of an O(n^3) refit. As in the JAX package the append works
on the whole padded buffer: the factor is the identity on the rows and
columns past n, C is the gram over every row of X with the rows past n
masked to 0, B = L^-1 C is solved against the whole factor, and the new
rows are written at the offset n, a tensor on the data's device. So its
shapes depend on (capacity, k) alone, and on the card an append replays
one CUDA graph (`utils/graphs.py`) kept for the model at each (capacity,
k), the counterpart of the JAX package's jitted `extend_cholesky`.

The factor is rebuilt lazily: `set_params` only marks it stale, and the
next `chol`, `mll`, `alpha` or `append` rebuilds it in full, as does the
append that crosses the capacity. A factor that fails holds NaN, as the
JAX package's does.
"""
from __future__ import annotations

import math

import torch

from ..ops.kernels import Kernel, SEIso
from ..ops.linalg import _chol, chol_solve, solve_lower
from ..ops.means import Mean, MeanZero
from ..utils import graphs
from ..utils.params import wrap_param
from .covariance import FullCovariance
from .gpe import GPE, GPEParams, _as_X, _device

__all__ = ["ElasticGPE", "extend_cholesky"]

_LOG_2PI = math.log(2.0 * math.pi)


def _factor(K: torch.Tensor) -> torch.Tensor:
    """The Cholesky factor of K, NaN where it fails (no host read)."""
    L, ok = _chol(K)
    return torch.where(ok, L, torch.full_like(L, math.nan))


def extend_cholesky(L: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    n: torch.Tensor) -> torch.Tensor:
    """The padded factor extended by k = D.shape[0] rows at the offset n (a
    0-d int64 tensor on L's device; nothing is read back to the host).

    L: (cap, cap), the factor on [:n, :n] and the identity past n.
    C: (cap, k) = K(X, x_new), its rows from n on zero.
    D: (k, k) = K(x_new) + noise I.
    Returns L with rows [n, n + k) replaced by [B^T, chol(D - B^T B), 0],
    B = L^-1 C (its rows from n on are zero)."""
    k = D.shape[0]
    B = solve_lower(L, C)
    at = n + torch.arange(k, device=L.device)
    rows = B.T.index_copy(1, at, _factor(D - B.T @ B))
    return L.index_copy(0, at, rows)


def _append(L, X, x_new, n, lognoise, kernel):
    """The factor of the model's first n points (a tensor) extended by
    x_new, over the whole capacity of X."""
    mask = torch.arange(X.shape[0], device=X.device) < n
    C = kernel.gram(X, x_new) * mask[:, None].to(X.dtype)
    k = x_new.shape[0]
    D = kernel.gram(x_new) + torch.exp(2.0 * lognoise) * torch.eye(
        k, dtype=X.dtype, device=X.device)
    return extend_cholesky(L, C, D, n)


class ElasticGPE(GPE):
    """A GPE with O(n^2 k) `append` (ref ElasticGPE, src/GPEelastic.jl).
    `device` defaults to the CUDA device and raises when there is none;
    `dtype` to torch's default float dtype."""

    def __init__(self, dim: int, mean: Mean | None = None, kernel: Kernel | None = None,
                 lognoise=-2.0, capacity: int = 1024, stepsize: int = 1024, device=None,
                 dtype=None):
        dev = _device(device, "ElasticGPE")
        dtype = dtype if dtype is not None else torch.get_default_dtype()
        kernel = kernel if kernel is not None else SEIso(ll=0.0, lsigma=0.0)
        mean = mean if mean is not None else MeanZero()
        params = GPEParams(lognoise=wrap_param(lognoise), mean=mean, kernel=kernel)
        self.params = params.to(dtype=dtype, device=dev)
        self.covstrat = FullCovariance()
        self.capacity = int(capacity)
        self.stepsize = int(stepsize)
        self._dim = int(dim)
        self._n = 0
        self._X = torch.zeros((self.capacity, self._dim), dtype=dtype, device=dev)
        self._y = torch.zeros(self.capacity, dtype=dtype, device=dev)
        self._L = torch.eye(self.capacity, dtype=dtype, device=dev)
        self._fresh = True  # L is the factor of the current data and parameters

    # -- GPE views ---------------------------------------------------------
    @property
    def x(self):
        return self._X[: self._n]

    @x.setter
    def x(self, value):
        raise AttributeError("use append() to add data to an ElasticGPE")

    @property
    def y(self):
        return self._y[: self._n]

    @y.setter
    def y(self, value):
        raise AttributeError("use append() to add data to an ElasticGPE")

    @property
    def nobs(self):
        return self._n

    @property
    def dim(self):
        return self._dim

    @property
    def device(self):
        return self._X.device

    @property
    def dtype(self):
        return self._X.dtype

    # -- growth ------------------------------------------------------------
    def _grow(self, needed: int) -> None:
        while self.capacity < needed:
            self.capacity += self.stepsize
        n = self._n
        X = self._X.new_zeros((self.capacity, self._dim))
        y = self._y.new_zeros(self.capacity)
        X[:n], y[:n] = self._X[:n], self._y[:n]
        self._X, self._y = X, y
        self._fresh = False

    def _noise_var(self):
        return torch.exp(2.0 * self.params.lognoise.value)

    def append(self, x_new, y_new):
        """Append k observations, extending the factor (ref append!,
        GPEelastic.jl:13-22)."""
        x_new = _as_X(x_new, dtype=self.dtype, device=self.device)
        y_new = torch.as_tensor(y_new).to(dtype=self.dtype, device=self.device).reshape(-1)
        k = x_new.shape[0]
        if x_new.shape[1] != self._dim:
            raise ValueError("inconsistent input dimension")
        if y_new.shape[0] != k:
            raise ValueError("x and y hold different numbers of observations")
        if self._n + k > self.capacity:
            self._grow(self._n + k)
        n = self._n
        self._X[n:n + k] = x_new
        self._y[n:n + k] = y_new
        self._n = n + k
        if self._fresh and n > 0:
            n_t = torch.full((), n, dtype=torch.int64, device=self.device)
            with torch.no_grad():
                self._L = graphs.run(self, _append, self._L, self._X, x_new, n_t,
                                     self.params.lognoise.value, self.params.kernel,
                                     static="append")
        else:
            self._rebuild()
        return self

    def _rebuild(self) -> None:
        n = self._n
        with torch.no_grad():
            K = self.params.kernel.gram(self._X[:n])
            # the identity past n, as the padded append needs it
            L = torch.eye(self.capacity, dtype=self.dtype, device=self.device)
            L[:n, :n] = _factor(K + self._noise_var() * torch.eye(
                n, dtype=self.dtype, device=self.device))
        self._L, self._fresh = L, True

    def set_params(self, hyp, **flags):
        # only marks the factor stale: a sweep of set_params costs no refit,
        # the next use of the factor pays one
        out = super().set_params(hyp, **flags)
        self._fresh = False
        return out

    # -- from the maintained factor -----------------------------------------
    def _active_factor(self):
        """A view of the factor's active block, rebuilt first if stale."""
        if not self._fresh:
            self._rebuild()
        return self._L[: self._n, : self._n]

    @property
    def chol(self):
        """The factor of K + noise I over the active data (a copy)."""
        return self._active_factor().clone()

    @property
    def alpha(self):
        """(K + noise I)^-1 (y - m(x))."""
        L = self._active_factor()
        with torch.no_grad():
            return chol_solve(L, self.y - self.params.mean.mean(self.x))

    @property
    def mll(self):
        """The marginal log likelihood from the maintained factor, O(n^2)."""
        L = self._active_factor()
        with torch.no_grad():
            w = solve_lower(L, self.y - self.params.mean.mean(self.x))
            return -0.5 * (torch.sum(w * w) + 2.0 * torch.sum(torch.log(torch.diagonal(L)))
                           + self._n * _LOG_2PI)

    def __repr__(self):
        return (f"ElasticGPE(nobs={self.nobs}, dim={self.dim}, capacity={self.capacity}, "
                f"kernel={self.params.kernel!r}, lognoise={self.lognoise}, "
                f"device={self.device})")
