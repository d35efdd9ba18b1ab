"""Covariance kernels (counterpart of `gaussianprocesses_jl_tpu/ops/kernels.py`).

SE / Matern(1/2, 3/2, 5/2) / RQ / Periodic / Linear / Poly / Const / Noise,
iso and ARD where the JAX package has them, plus Sum / Prod / Masked / Fixed
composition. Hyperparameters are log-scale tensor fields, in the JAX
package's flat order (e.g. SEIso -> [ll, lsigma]).

Every stationary gram (SE, Matern, RQ iso and ARD, Periodic) goes through the
gram op of `ops/gram.py`, which launches the CUDA kernel on a CUDA tensor.
Each stationary class names its profile family and hands the op its
hyperparameters as [lsigma, ll, extra]; its own `_r2profile` stays as the
module's formula, used by `diag` and held equal to the op's profile by the
tests.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..utils.modules import Module, module, replace
from . import gram as gram_op
from .distance import safe_dist, sqdist

__all__ = [
    "Kernel",
    "SEIso",
    "SEArd",
    "SE",
    "Mat12Iso",
    "Mat32Iso",
    "Mat52Iso",
    "Mat12Ard",
    "Mat32Ard",
    "Mat52Ard",
    "Matern",
    "RQIso",
    "RQArd",
    "RQ",
    "Periodic",
    "LinIso",
    "LinArd",
    "Lin",
    "Poly",
    "Noise",
    "Const",
    "SumKernel",
    "ProdKernel",
    "Masked",
    "FixedKernel",
    "fix",
    "free",
]


def _as(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x
    return torch.as_tensor(x, dtype=torch.float64)


class Kernel(Module):
    """Base covariance kernel.

      gram(X1, X2=None) -> (n1, n2) covariance matrix (X2=None: symmetric)
      diag(X)           -> (n,) diagonal of gram(X, X)
      k(x1, x2)         -> scalar covariance of one pair
    """

    def gram(self, X1, X2=None):
        raise NotImplementedError

    def diag(self, X):
        raise NotImplementedError

    def __call__(self, x1, x2):
        x1 = torch.atleast_1d(x1)
        x2 = torch.atleast_1d(x2)
        return self.gram(x1[None, :], x2[None, :])[0, 0]

    def __add__(self, other):
        return SumKernel(self, other)

    def __mul__(self, other):
        return ProdKernel(self, other)


# ---------------------------------------------------------------------------
# Stationary bases
# ---------------------------------------------------------------------------


class _Stationary(Kernel):
    """k = profile(r2) over a squared distance, built by the gram op.

    Subclasses set `_family` (ops/gram.py) and, for RQ and Periodic,
    `_extra`, the name of the third hyperparameter. ARD subclasses set
    `_ard`: they scale their inputs by exp(-ll) and pass ll = 0."""

    _family = None
    _extra = None
    _ard = False

    def _r2profile(self, r2):
        raise NotImplementedError

    def _gram_params(self):
        """[lsigma, ll, extra]: the op's hyperparameter vector."""
        zero = torch.zeros_like(self.lsigma)
        ll = zero if self._ard else self.ll
        extra = getattr(self, self._extra) if self._extra else zero
        return torch.stack([t.reshape(()) for t in (self.lsigma, ll, extra)])

    def _scale(self, X):
        return X * torch.exp(-self.ll)[None, :] if self._ard else X

    def gram(self, X1, X2=None):
        return gram_op.gram(self._family, self._gram_params(), self._scale(X1),
                            None if X2 is None else self._scale(X2))

    def diag(self, X):
        return self._r2profile(X.new_zeros(X.shape[0]))


class _StationaryR(_Stationary):
    """Stationary kernel over the Euclidean distance r."""

    def _rprofile(self, r):
        raise NotImplementedError

    def _r2profile(self, r2):
        return self._rprofile(safe_dist(r2))


# ---------------------------------------------------------------------------
# Squared exponential
# ---------------------------------------------------------------------------


@module(static=("priors",))
class SEIso(_Stationary):
    """k(x,x') = sigma^2 exp(-r2 / (2 l^2))."""

    ll: Any  # log length scale
    lsigma: Any  # log signal std
    priors: tuple = ()
    _family = gram_op.SE

    def _r2profile(self, r2):
        return torch.exp(2.0 * self.lsigma - 0.5 * r2 * torch.exp(-2.0 * self.ll))

    def param_names(self):
        return ["ll", "lsigma"]


@module(static=("priors",))
class SEArd(_Stationary):
    """ARD squared exponential; params [ll_1..ll_d, lsigma]."""

    ll: Any  # (d,) log length scales
    lsigma: Any
    priors: tuple = ()
    _family = gram_op.SE
    _ard = True

    def _r2profile(self, r2):
        return torch.exp(2.0 * self.lsigma - 0.5 * r2)


def SE(ll, lsigma):
    """`SE(ll, lσ)`: iso when ll is a scalar, ARD when it is a vector."""
    ll = _as(ll)
    if ll.ndim == 0:
        return SEIso(ll=ll, lsigma=lsigma)
    return SEArd(ll=ll, lsigma=lsigma)


# ---------------------------------------------------------------------------
# Matern family
# ---------------------------------------------------------------------------


@module(static=("priors",))
class Mat12Iso(_StationaryR):
    """k = sigma^2 exp(-r / l)."""

    ll: Any
    lsigma: Any
    priors: tuple = ()
    _family = gram_op.MAT12

    def _rprofile(self, r):
        return torch.exp(2.0 * self.lsigma - r * torch.exp(-self.ll))


@module(static=("priors",))
class Mat32Iso(_StationaryR):
    """k = sigma^2 (1+s) exp(-s), s = sqrt(3) r / l."""

    ll: Any
    lsigma: Any
    priors: tuple = ()
    _family = gram_op.MAT32

    def _rprofile(self, r):
        s = math.sqrt(3.0) * r * torch.exp(-self.ll)
        return torch.exp(2.0 * self.lsigma) * (1.0 + s) * torch.exp(-s)


@module(static=("priors",))
class Mat52Iso(_StationaryR):
    """k = sigma^2 (1+s+s^2/3) exp(-s), s = sqrt(5) r / l."""

    ll: Any
    lsigma: Any
    priors: tuple = ()
    _family = gram_op.MAT52

    def _rprofile(self, r):
        s = math.sqrt(5.0) * r * torch.exp(-self.ll)
        return torch.exp(2.0 * self.lsigma) * (1.0 + s + s * s / 3.0) * torch.exp(-s)


@module(static=("priors",))
class Mat12Ard(_StationaryR):
    """ARD exponential kernel."""

    ll: Any  # (d,)
    lsigma: Any
    priors: tuple = ()
    _family = gram_op.MAT12
    _ard = True

    def _rprofile(self, r):
        return torch.exp(2.0 * self.lsigma - r)


@module(static=("priors",))
class Mat32Ard(_StationaryR):
    """ARD Matern 3/2."""

    ll: Any
    lsigma: Any
    priors: tuple = ()
    _family = gram_op.MAT32
    _ard = True

    def _rprofile(self, r):
        s = math.sqrt(3.0) * r
        return torch.exp(2.0 * self.lsigma) * (1.0 + s) * torch.exp(-s)


@module(static=("priors",))
class Mat52Ard(_StationaryR):
    """ARD Matern 5/2."""

    ll: Any
    lsigma: Any
    priors: tuple = ()
    _family = gram_op.MAT52
    _ard = True

    def _rprofile(self, r):
        s = math.sqrt(5.0) * r
        return torch.exp(2.0 * self.lsigma) * (1.0 + s + s * s / 3.0) * torch.exp(-s)


def Matern(nu, ll, lsigma):
    """Matern by order nu in {1/2, 3/2, 5/2}; iso for scalar ll, ARD for
    vector ll."""
    ll = _as(ll)
    table = {
        0.5: (Mat12Iso, Mat12Ard),
        1.5: (Mat32Iso, Mat32Ard),
        2.5: (Mat52Iso, Mat52Ard),
    }
    if float(nu) not in table:
        raise ValueError("Only Matern 1/2, 3/2 and 5/2 are implemented")
    iso_cls, ard_cls = table[float(nu)]
    cls = iso_cls if ll.ndim == 0 else ard_cls
    return cls(ll=ll, lsigma=lsigma)


# ---------------------------------------------------------------------------
# Rational quadratic
# ---------------------------------------------------------------------------


@module(static=("priors",))
class RQIso(_Stationary):
    """k = sigma^2 (1 + r2/(2 alpha l^2))^-alpha; params [ll, lsigma, lalpha]."""

    ll: Any
    lsigma: Any
    lalpha: Any
    priors: tuple = ()
    _family = gram_op.RQ
    _extra = "lalpha"

    def _r2profile(self, r2):
        alpha = torch.exp(self.lalpha)
        z = r2 * torch.exp(-2.0 * self.ll) / (2.0 * alpha)
        return torch.exp(2.0 * self.lsigma - alpha * torch.log1p(z))


@module(static=("priors",))
class RQArd(_Stationary):
    """ARD rational quadratic; params [ll_1..ll_d, lsigma, lalpha]."""

    ll: Any
    lsigma: Any
    lalpha: Any
    priors: tuple = ()
    _family = gram_op.RQ
    _extra = "lalpha"
    _ard = True

    def _r2profile(self, r2):
        alpha = torch.exp(self.lalpha)
        return torch.exp(2.0 * self.lsigma - alpha * torch.log1p(r2 / (2.0 * alpha)))


def RQ(ll, lsigma, lalpha):
    """RQ, iso or ARD by the shape of ll."""
    ll = _as(ll)
    if ll.ndim == 0:
        return RQIso(ll=ll, lsigma=lsigma, lalpha=lalpha)
    return RQArd(ll=ll, lsigma=lsigma, lalpha=lalpha)


# ---------------------------------------------------------------------------
# Periodic
# ---------------------------------------------------------------------------


@module(static=("priors",))
class Periodic(_StationaryR):
    """k = sigma^2 exp(-2 sin^2(pi r / p) / l^2); params [ll, lsigma, lp]."""

    ll: Any
    lsigma: Any
    lp: Any
    priors: tuple = ()
    _family = gram_op.PERIODIC
    _extra = "lp"

    def _rprofile(self, r):
        s = torch.sin(math.pi * r * torch.exp(-self.lp))
        return torch.exp(2.0 * self.lsigma - 2.0 * s * s * torch.exp(-2.0 * self.ll))


# ---------------------------------------------------------------------------
# Dot-product family
# ---------------------------------------------------------------------------


@module(static=("priors",))
class LinIso(Kernel):
    """k = x.y / l^2; params [ll]."""

    ll: Any
    priors: tuple = ()

    def gram(self, X1, X2=None):
        X2 = X1 if X2 is None else X2
        return torch.exp(-2.0 * self.ll) * (X1 @ X2.T)

    def diag(self, X):
        return torch.exp(-2.0 * self.ll) * torch.sum(X * X, dim=1)


@module(static=("priors",))
class LinArd(Kernel):
    """k = (x/l).(y/l); params [ll_1..ll_d]."""

    ll: Any  # (d,)
    priors: tuple = ()

    def gram(self, X1, X2=None):
        w = torch.exp(-self.ll)[None, :]
        X1w = X1 * w
        X2w = X1w if X2 is None else X2 * w
        return X1w @ X2w.T

    def diag(self, X):
        Xw = X * torch.exp(-self.ll)[None, :]
        return torch.sum(Xw * Xw, dim=1)


def Lin(ll):
    """Linear kernel, iso or ARD by the shape of ll."""
    ll = _as(ll)
    return LinIso(ll=ll) if ll.ndim == 0 else LinArd(ll=ll)


@module(static=("deg", "priors"))
class Poly(Kernel):
    """k = sigma^2 (c + x.y)^deg with a fixed integer degree; params
    [lc, lsigma]."""

    lc: Any
    lsigma: Any
    deg: int = 2
    priors: tuple = ()

    def gram(self, X1, X2=None):
        X2 = X1 if X2 is None else X2
        return torch.exp(2.0 * self.lsigma) * (torch.exp(self.lc) + X1 @ X2.T) ** self.deg

    def diag(self, X):
        xx = torch.sum(X * X, dim=1)
        return torch.exp(2.0 * self.lsigma) * (torch.exp(self.lc) + xx) ** self.deg


# ---------------------------------------------------------------------------
# Noise / Const
# ---------------------------------------------------------------------------


@module(static=("priors",))
class Noise(Kernel):
    """White noise: sigma^2 * delta(x ~= x').

    Points coincide when d2(x, x') <= eps * max(|x|^2, |x'|^2, 1): a relative
    test with an absolute floor near the origin, as in the JAX package."""

    lsigma: Any
    priors: tuple = ()

    def gram(self, X1, X2=None):
        d2 = sqdist(X1, X2)
        eps = torch.finfo(X1.dtype).eps
        s1 = torch.sum(X1 * X1, dim=-1)
        s2 = s1 if X2 is None else torch.sum(X2 * X2, dim=-1)
        scale = torch.clamp(torch.maximum(s1[:, None], s2[None, :]), min=1.0)
        sig2 = torch.exp(2.0 * self.lsigma)
        return torch.where(d2 <= eps * scale, sig2, torch.zeros_like(sig2))

    def diag(self, X):
        return torch.exp(2.0 * self.lsigma) * X.new_ones(X.shape[0])


@module(static=("priors",))
class Const(Kernel):
    """Constant covariance sigma^2."""

    lsigma: Any
    priors: tuple = ()

    def gram(self, X1, X2=None):
        n2 = X1.shape[0] if X2 is None else X2.shape[0]
        return torch.exp(2.0 * self.lsigma) * X1.new_ones((X1.shape[0], n2))

    def diag(self, X):
        return torch.exp(2.0 * self.lsigma) * X.new_ones(X.shape[0])


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


@module(static=())
class SumKernel(Kernel):
    """k1 + k2; params [k1; k2]."""

    k1: Kernel
    k2: Kernel

    def gram(self, X1, X2=None):
        return self.k1.gram(X1, X2) + self.k2.gram(X1, X2)

    def diag(self, X):
        return self.k1.diag(X) + self.k2.diag(X)


@module(static=())
class ProdKernel(Kernel):
    """k1 * k2; params [k1; k2]."""

    k1: Kernel
    k2: Kernel

    def gram(self, X1, X2=None):
        return self.k1.gram(X1, X2) * self.k2.gram(X1, X2)

    def diag(self, X):
        return self.k1.diag(X) * self.k2.diag(X)


def _runs(idx):
    """[(a, b)]: the runs of consecutive values of idx, in order, as
    half-open ranges."""
    runs = []
    for i in idx:
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return [tuple(r) for r in runs]


@module(static=("active_dims",))
class Masked(Kernel):
    """Apply `kern` to a subset of input dimensions."""

    kern: Kernel
    active_dims: tuple = ()

    def _sel(self, X):
        # column slices, one a run of consecutive dims: no index tensor to
        # copy to the card, so a CUDA graph can capture it
        return torch.cat([X[:, a:b] for a, b in _runs(self.active_dims)], dim=1)

    def gram(self, X1, X2=None):
        return self.kern.gram(self._sel(X1), None if X2 is None else self._sel(X2))

    def diag(self, X):
        return self.kern.diag(self._sel(X))


@module(static=("free_idx",))
class FixedKernel(Kernel):
    """Freeze a subset of hyperparameters: only `free_idx` (0-based, into the
    wrapped kernel's flat params) are exposed. A FixedKernel adds nothing to
    the prior."""

    kern: Kernel
    free_idx: tuple = ()

    def gram(self, X1, X2=None):
        return self.kern.gram(X1, X2)

    def diag(self, X):
        return self.kern.diag(X)

    def flat_params(self):
        inner = self.kern.flat_params()
        # one-element slices, not an index list copied to the card
        return torch.cat([inner[:0]] + [inner[i:i + 1] for i in self.free_idx])

    def with_flat_params(self, vec):
        inner = self.kern.flat_params()
        if self.free_idx:
            # the inner vector rebuilt from one-element slices of it and of
            # vec: no index tensor to copy to the card
            vec = vec.to(inner.dtype)
            pos = {i: k for k, i in enumerate(self.free_idx)}
            inner = torch.cat([vec[pos[i]:pos[i] + 1] if i in pos else inner[i:i + 1]
                               for i in range(inner.shape[0])])
        return replace(self, kern=self.kern.with_flat_params(inner))

    @property
    def n_params(self):
        return len(self.free_idx)

    def param_names(self):
        names = self.kern.param_names()
        return [names[i] for i in self.free_idx]

    def priors_flat(self):
        inner = self.kern.priors_flat()
        return [inner[i] for i in self.free_idx]

    def prior_logpdf(self):
        return self.kern.flat_params().new_zeros(())


def fix(kern: Kernel, par: str | None = None) -> FixedKernel:
    """fix(k) freezes all params; fix(k, 'lsigma') freezes one by name."""
    if isinstance(kern, FixedKernel):
        if par is None:
            return replace(kern, free_idx=())
        names = kern.kern.param_names()
        return replace(
            kern, free_idx=tuple(i for i in kern.free_idx if names[i] != par)
        )
    if par is None:
        return FixedKernel(kern=kern, free_idx=())
    names = kern.param_names()
    free_i = tuple(i for i, n in enumerate(names) if n != par)
    return FixedKernel(kern=kern, free_idx=free_i)


def free(kern: FixedKernel, par: str | None = None):
    """Unfreeze all params, or one by name."""
    if par is None:
        return kern.kern
    names = kern.kern.param_names()
    try:
        ipar = names.index(par)
    except ValueError:
        return kern
    if ipar in kern.free_idx:
        return kern
    return replace(kern, free_idx=tuple(sorted(set(kern.free_idx) | {ipar})))
