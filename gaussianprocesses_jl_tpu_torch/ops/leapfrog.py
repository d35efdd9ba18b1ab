"""The fused HMC transition of a GPA's block A: every chain, all Lmax
leapfrog steps, in one launch of `leapfrog_kernel` (`csrc/leapfrog.cu`).

Block A is the whitened latents v alone (the likelihood and the mean carry
no parameters) against each chain's cached lower factor L:
target(v) = sum_i log p(y_i | mu_i + (L v)_i) - (|v|^2 + n log 2 pi) / 2 +
prior(b), -inf where the factorization failed. `transition` runs
`inference.hmc.hmc_transition` on that target with the same semantics and
the same draws: on a CUDA tensor it launches the kernel, on a CPU tensor it
runs `transition_plain`, the kernel's arithmetic in plain PyTorch. The
split sampler takes it when the target carries a `ProbitA` (attached by
`GPA.make_split_logprob`); only the probit likelihood (`BernLik`) has a
kernel so far.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..utils.graphs import counted
from . import cuda

__all__ = ["LAUNCHES", "ProbitA", "fits", "smem_bytes", "transition", "transition_plain",
           "launch"]

# kernel launches; the wrapper adds one where it launches
LAUNCHES = counted({"leapfrog": 0})

# threads a block; the kernel gives one element of each vector to a thread
THREADS = 256
# dynamic shared memory a block may have on an H100 (227 KB)
SMEM_LIMIT = 232448

_LOG_2PI = math.log(2.0 * math.pi)
_HALF_LOG_2PI = 0.5 * _LOG_2PI
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@dataclass(frozen=True)
class ProbitA:
    """Block A of a probit GPA whose block is v alone: y (n,) the
    observations, mu (n,) the mean (constant given b), and prior, b (C, Db)
    -> (C,), the hyperprior at each chain's b (0 without priors)."""

    y: torch.Tensor
    mu: torch.Tensor
    prior: Callable


def smem_bytes(n: int, dtype) -> int:
    """The kernel's dynamic shared memory at n: the factor at an odd row
    stride, two vectors and the reduction's partials."""
    size = torch.empty((), dtype=dtype).element_size()
    return size * (n * (n | 1) + 2 * n + 2 * (THREADS // 32))


def fits(n: int, dtype) -> bool:
    """Whether one block holds a chain's factor at n: n <= 239 in float32,
    169 in float64."""
    return 1 <= n <= THREADS and smem_bytes(n, dtype) <= SMEM_LIMIT


def _log_ndtr_ratio(x):
    """(log Phi(x), phi(x) / Phi(x)) with the kernel's branches: the ratio
    below -1 is sqrt(2 / pi) / erfcx(-x / sqrt 2)."""
    lnd = torch.special.log_ndtr(x)
    low = x < -1.0
    e = torch.special.erfcx(-x * math.sqrt(0.5))
    ratio = torch.where(low, _SQRT_2_OVER_PI / e, torch.exp(-0.5 * x * x - _HALF_LOG_2PI - lnd))
    return lnd, ratio


def probit_log_dens(f, y):
    """(y log Phi(f) + (1 - y) log Phi(-f), its derivative in f), elementwise."""
    l1, r1 = _log_ndtr_ratio(f)
    l0, r0 = _log_ndtr_ratio(-f)
    return y * l1 + (1.0 - y) * l0, y * r1 - (1.0 - y) * r0


def _finite0(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def transition_plain(L, ok, mu, y, const, theta, tgt, grad, nu0, steps, log_u, eps, Lmax: int):
    """The kernel's transition in plain PyTorch, with the identity mass.
    L (C, n, n) the lower factors, ok (C,) their flags, mu and y (n,),
    const (C,) the hyperprior; theta, grad, nu0 (C, n), tgt, log_u, eps
    (C,), steps (C,) the path lengths. Returns (theta', tgt', grad',
    accept_prob, accepted)."""
    n = theta.shape[-1]
    eps = eps[:, None]
    nu = nu0 + 0.5 * eps * grad
    th, g, t = theta, grad, tgt
    bad = torch.isnan(theta.sum(-1))
    Lt = L.transpose(-1, -2)
    for step in range(Lmax):
        active = (step < steps) & ~bad
        th_n = th + eps * nu
        fin = torch.isfinite(th_n).all(-1)
        ld, dld = probit_log_dens(torch.matmul(L, th_n[..., None])[..., 0] + mu, y)
        t_n = torch.where(ok, ld.sum(-1) - 0.5 * ((th_n * th_n).sum(-1) + n * _LOG_2PI) + const,
                          torch.full_like(tgt, -math.inf))
        g_n = torch.matmul(Lt, dld[..., None])[..., 0] - th_n
        g_eff = torch.where(ok[:, None], _finite0(g_n), torch.zeros_like(g_n))
        bad = torch.where(active, ~fin, bad)
        use = active & fin
        th = torch.where(use[:, None], th_n, th)
        g = torch.where(use[:, None], g_eff, g)
        t = torch.where(use, t_n, t)
        nu = torch.where(use[:, None], nu + eps * g_eff, nu)
    nu = nu - 0.5 * eps * g
    kin = 0.5 * torch.sum(nu * nu, dim=-1)
    kin0 = 0.5 * torch.sum(nu0 * nu0, dim=-1)
    log_alpha = t - kin - tgt + kin0
    ok_end = torch.isfinite(t) & ~bad
    zero = torch.zeros_like(log_alpha)
    ap = torch.where(ok_end, torch.exp(torch.clamp(log_alpha, max=0.0)), zero)
    ap = torch.where(torch.isnan(ap), zero, ap)
    acc = (log_u < log_alpha) & ok_end
    return (torch.where(acc[:, None], th, theta), torch.where(acc, t, tgt),
            torch.where(acc[:, None], g, grad), ap, acc)


def launch(L, ok, mu, y, const, theta, tgt, grad, nu0, steps, log_u, eps, Lmax: int):
    """`transition_plain`'s transition as one launch of the kernel on the
    current stream, on CUDA tensors; raises on operands it does not take
    and on a refused launch. Nothing is read back."""
    C, n = theta.shape
    dt, dev = theta.dtype, theta.device
    if dev.type != "cuda":
        raise ValueError(f"leapfrog: launch needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"leapfrog: float32 or float64, got {dt}")
    shapes = {"L": (L, (C, n, n), dt), "ok": (ok, (C,), torch.bool), "mu": (mu, (n,), dt),
              "y": (y, (n,), dt), "const": (const, (C,), dt), "theta": (theta, (C, n), dt),
              "tgt": (tgt, (C,), dt), "grad": (grad, (C, n), dt), "nu0": (nu0, (C, n), dt),
              "steps": (steps, (C,), torch.int64), "log_u": (log_u, (C,), dt),
              "eps": (eps, (C,), dt)}
    for name, (t, shape, want) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != want or t.device != dev:
            raise ValueError(f"leapfrog: {name} must be {shape} {want} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"leapfrog: {name} must be contiguous")
    out = (torch.empty_like(theta), torch.empty_like(tgt), torch.empty_like(grad),
           torch.empty_like(tgt), torch.empty((C,), dtype=torch.bool, device=dev))
    cuda.call("leapfrog.cu",
              "leapfrog_probit_f32" if dt == torch.float32 else "leapfrog_probit_f64",
              L.data_ptr(), ok.data_ptr(), mu.data_ptr(), y.data_ptr(), const.data_ptr(),
              theta.data_ptr(), tgt.data_ptr(), grad.data_ptr(), nu0.data_ptr(), steps.data_ptr(),
              log_u.data_ptr(), eps.data_ptr(), C, n, Lmax, *(t.data_ptr() for t in out),
              device=dev)
    LAUNCHES["leapfrog"] += 1
    return out


def transition(block: ProbitA, aux, const, theta, tgt, grad, nu0, steps, log_u, eps,
               Lmax: int):
    """One HMC transition of block A of every chain, from given draws, as
    `hmc_transition(block_a(logprob_a), ...)` makes it: aux the cached
    factor (a `DensePD` batched over the chains), const (C,) the hyperprior
    `block.prior(b)`; eps a scalar or (C,). The kernel on CUDA tensors, its
    plain version on CPU tensors."""
    C = theta.shape[0]
    eps = torch.as_tensor(eps, dtype=theta.dtype, device=theta.device).expand(C).contiguous()
    args = (aux.L, aux.ok, block.mu, block.y, const, theta, tgt, grad, nu0, steps, log_u, eps,
            Lmax)
    if theta.is_cuda:
        return launch(*(a.contiguous() if torch.is_tensor(a) else a for a in args))
    return transition_plain(*args)
