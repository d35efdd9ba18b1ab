"""A scikit-learn style estimator over GPE (counterpart of
`gaussianprocesses_jl_tpu/sklearn.py`; ref src/ScikitLearn.jl).

Duck-typed to the estimator protocol (`fit`, `predict`, `score`,
`get_params`, `set_params`, `clone`) without importing scikit-learn. Numpy
goes in and numpy comes out; the model lives on the CUDA device unless the
estimator is built with `device="cpu"`.
"""
from __future__ import annotations

import copy

import numpy as np

from .models.gpe import GPE
from .ops.kernels import SEIso
from .ops.means import MeanZero

__all__ = ["GPRegressor"]


class GPRegressor:
    """Exact-GP regressor with the scikit-learn estimator protocol. The
    parameters mirror the GPE constructor; `fit` maximizes the marginal
    likelihood (type-II ML) unless optimize=False."""

    def __init__(self, kernel=None, mean=None, lognoise=-2.0, optimize=True, maxiter=200,
                 device=None):
        self.kernel = kernel
        self.mean = mean
        self.lognoise = lognoise
        self.optimize = optimize
        self.maxiter = maxiter
        self.device = device

    def get_params(self, deep=True):
        return {"kernel": self.kernel, "mean": self.mean, "lognoise": self.lognoise,
                "optimize": self.optimize, "maxiter": self.maxiter, "device": self.device}

    def set_params(self, **params):
        for k, v in params.items():
            if k not in self.get_params():
                raise ValueError(f"invalid parameter {k!r}")
            setattr(self, k, v)
        return self

    def clone(self):
        return GPRegressor(**copy.deepcopy(self.get_params()))

    def fit(self, X, y):
        kernel = self.kernel if self.kernel is not None else SEIso(ll=0.0, lsigma=0.0)
        mean = self.mean if self.mean is not None else MeanZero()
        X = np.asarray(X)
        dtype = X.dtype if X.dtype in (np.float32, np.float64) else np.float64
        self.gp_ = GPE(X.astype(dtype), np.asarray(y, dtype=dtype), mean, kernel,
                       lognoise=self.lognoise, device=self.device)
        if self.optimize:
            self.gp_.optimize(maxiter=self.maxiter)
        return self

    def _check_fitted(self):
        if not hasattr(self, "gp_"):
            raise RuntimeError("fit() must be called before predict()")

    def predict(self, X, return_std=False):
        self._check_fitted()
        mu, var = self.gp_.predict_y(np.asarray(X, dtype=np.float64))
        mu, var = mu.cpu().numpy(), var.cpu().numpy()
        if return_std:
            return mu, np.sqrt(var)
        return mu

    def score(self, X, y):
        """R^2, the coefficient of determination (scikit-learn's convention)."""
        y = np.asarray(y, dtype=float)
        pred = self.predict(X)
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - np.mean(y)) ** 2))
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0

    def log_marginal_likelihood(self):
        self._check_fitted()
        return float(self.gp_.mll)
