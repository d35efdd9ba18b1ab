"""Prior distributions for hyperparameters (counterpart of
`gaussianprocesses_jl_tpu/utils/priors.py`).

Priors are small frozen dataclasses, so they can sit in a module's static
`priors` field. `logpdf(x)` works on tensors and is differentiable by
autograd; `sample(generator)` draws one float64 value with a
`torch.Generator` (the draws differ from `jax.random`'s for the same seed).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = [
    "Prior",
    "Normal",
    "LogNormal",
    "Uniform",
    "Gamma",
    "Exponential",
    "Beta",
    "StudentT",
]

_F64 = torch.float64


def _normal(generator):
    return torch.randn((), generator=generator, dtype=_F64)


def _uniform(generator):
    return torch.rand((), generator=generator, dtype=_F64)


def _gamma(shape, generator):
    """Gamma(shape, 1) by Marsaglia and Tsang's rejection method."""
    if shape < 1.0:
        u = _uniform(generator)
        return _gamma(shape + 1.0, generator) * u ** (1.0 / shape)
    d = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        z = _normal(generator)
        v = (1.0 + c * z) ** 3
        if v <= 0:
            continue
        u = _uniform(generator)
        if torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v):
            return d * v


def _where(cond, value, other):
    return torch.where(cond, value, torch.full_like(value, other))


@dataclass(frozen=True)
class Prior:
    def logpdf(self, x):
        raise NotImplementedError

    def sample(self, generator=None):
        raise NotImplementedError

    def gradlogpdf(self, x):
        x = torch.as_tensor(x, dtype=_F64).detach().requires_grad_()
        lp = self.logpdf(x)
        if not lp.requires_grad:  # constant on this branch (e.g. Uniform)
            return torch.zeros_like(x)
        return torch.autograd.grad(lp, x)[0]


@dataclass(frozen=True)
class Normal(Prior):
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, x):
        z = (x - self.mu) / self.sigma
        return -0.5 * z * z - math.log(self.sigma) - 0.5 * math.log(2 * math.pi)

    def sample(self, generator=None):
        return self.mu + self.sigma * _normal(generator)


@dataclass(frozen=True)
class LogNormal(Prior):
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, x):
        safe = torch.where(x > 0, x, torch.ones_like(x))
        lp = (
            -torch.log(safe)
            - math.log(self.sigma)
            - 0.5 * math.log(2 * math.pi)
            - 0.5 * ((torch.log(safe) - self.mu) / self.sigma) ** 2
        )
        return _where(x > 0, lp, -math.inf)

    def sample(self, generator=None):
        return torch.exp(self.mu + self.sigma * _normal(generator))


@dataclass(frozen=True)
class Uniform(Prior):
    a: float = 0.0
    b: float = 1.0

    def logpdf(self, x):
        inside = (x >= self.a) & (x <= self.b)
        return _where(inside, torch.full_like(x, -math.log(self.b - self.a)),
                      -math.inf)

    def sample(self, generator=None):
        return self.a + (self.b - self.a) * _uniform(generator)


@dataclass(frozen=True)
class Gamma(Prior):
    """Shape/rate parameterization: p(x) = rate^shape x^{shape-1} e^{-rate x} / Γ(shape)."""

    shape: float = 1.0
    rate: float = 1.0

    def logpdf(self, x):
        safe = torch.where(x > 0, x, torch.ones_like(x))
        lp = (
            self.shape * math.log(self.rate)
            - math.lgamma(self.shape)
            + (self.shape - 1) * torch.log(safe)
            - self.rate * safe
        )
        return _where(x > 0, lp, -math.inf)

    def sample(self, generator=None):
        return _gamma(self.shape, generator) / self.rate


@dataclass(frozen=True)
class Exponential(Prior):
    rate: float = 1.0

    def logpdf(self, x):
        return _where(x >= 0, math.log(self.rate) - self.rate * x, -math.inf)

    def sample(self, generator=None):
        return -torch.log1p(-_uniform(generator)) / self.rate


@dataclass(frozen=True)
class Beta(Prior):
    a: float = 1.0
    b: float = 1.0

    def logpdf(self, x):
        betaln = math.lgamma(self.a) + math.lgamma(self.b) - math.lgamma(self.a + self.b)
        lp = (torch.xlogy(x.new_tensor(self.a - 1.0), x)
              + torch.special.xlog1py(x.new_tensor(self.b - 1.0), -x) - betaln)
        return _where((x >= 0) & (x <= 1), lp, -math.inf)

    def sample(self, generator=None):
        ga = _gamma(self.a, generator)
        gb = _gamma(self.b, generator)
        return ga / (ga + gb)


@dataclass(frozen=True)
class StudentT(Prior):
    """Non-standardized Student-t prior with df nu, location mu, scale sigma."""

    nu: float = 3.0
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, x):
        z = (x - self.mu) / self.sigma
        nu = self.nu
        return (
            math.lgamma((nu + 1) / 2)
            - math.lgamma(nu / 2)
            - 0.5 * math.log(math.pi * nu)
            - math.log(self.sigma)
            - (nu + 1) / 2 * torch.log1p(z * z / nu)
        )

    def sample(self, generator=None):
        chi2 = 2.0 * _gamma(self.nu / 2.0, generator)
        return self.mu + self.sigma * _normal(generator) / torch.sqrt(chi2 / self.nu)
