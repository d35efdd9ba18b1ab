"""Split-block HMC with factor caching over a batch of chains (counterpart
of `gaussianprocesses_jl_tpu/inference/split.py`).

The joint GPA target over theta = [v; lik; mean; kern] couples two blocks of
very different cost:

  * A = [v; lik; mean]: given the kernel the factor L is constant, so a
    leapfrog step is one batched matvec f = mu + L v and elementwise
    likelihood work, no gram and no factorization;
  * B = [kern]: every leapfrog step rebuilds the chains' grams (one launch of
    the gram kernel for every chain), refactorizes (one batched Cholesky) and
    differentiates through both (one launch of the VJP kernel).

`split_hmc` alternates `a_iters` HMC updates of A against a factor cached
once per outer iteration (`precompute(b)`, batched over the chains, without
gradients) with one HMC update of B. Each is standard HMC on an exact
conditional, so the alternation leaves the joint invariant; each block has
its own step size. With n_warmup > 0, per-block (and per-chain) dual
averaging adapts both step sizes over the additive warmup iterations.

Per outer iteration the gram kernel launches 1 + 1 + Lmax_b times (the
factor, the B update's start and its leapfrog steps) and its VJP kernel
1 + Lmax_b times, whatever the number of chains.

On the card the factor, each block's start and each block's transition
replay CUDA graphs (`utils/graphs.py`), the counterparts of the JAX
package's compiled sweep: kept for `precompute`, `logprob_a` and
`logprob_b`, so a second run of the same target captures nothing. The A
graphs take the cached factor's tensors as inputs. The draws and the dual
averaging stay outside every graph.

Block A's transition has a second route, the fused one: one launch of the
leapfrog kernel (`ops/leapfrog.py`) runs every chain's whole A transition,
from the same draws, in place of the transition's graph. It is taken where
`logprob_a` carries the kernel's description of its target (`.fused`, set
by `GPA.make_split_logprob` for a float32 probit GPA whose block A is v
alone, on a dense factor), the chains are on the card and a block holds a
chain's factor. `ROUTES` counts the A transitions each route ran.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..ops import leapfrog
from ..utils import graphs
from ..utils.profiling import span
from .hmc import as_stream, batched_value_and_grad, hmc_iteration, start

__all__ = ["split_hmc", "SplitHMCResult", "da_init", "da_update", "block_a", "ROUTES"]

# block A's transitions by route: the fused leapfrog kernel or the graphed
# `hmc_transition`
ROUTES = {"fused": 0, "graphed": 0}


@dataclass
class SplitHMCResult:
    samples: torch.Tensor  # (n_iter * a_iters, Da + Db) post-warmup, or (C, ...)
    warmup_samples: torch.Tensor  # (n_warmup * a_iters, Da + Db), or (C, ...)
    accept_rate_a: torch.Tensor  # post-warmup acceptance, () or (C,)
    accept_rate_b: torch.Tensor
    final: torch.Tensor  # (Da + Db,) or (C, Da + Db)
    final_target: torch.Tensor  # the joint target at the final state, () or (C,)
    eps_a_final: torch.Tensor  # the adapted (or given) step sizes, () or (C,)
    eps_b_final: torch.Tensor


# dual averaging's constants (Hoffman & Gelman 2014, Alg. 5), as in the JAX
# package
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75


def da_init(eps0):
    """Dual-averaging state (eps, mu, log_eps_bar, hbar, t) from the start
    step sizes eps0 (a tensor, one a chain)."""
    zero = torch.zeros_like(eps0)
    return (eps0, torch.log(10.0 * eps0), torch.log(eps0), zero, zero)


def da_update(a_mean, st, target_accept: float = 0.8):
    """One dual-averaging step on the mean accept probability a_mean;
    st = (eps, mu, log_eps_bar, hbar, t)."""
    eps, mu, leb, hbar, t = st
    t = t + 1.0
    hbar = (1.0 - 1.0 / (t + _T0)) * hbar + (target_accept - a_mean) / (t + _T0)
    log_eps = mu - torch.sqrt(t) / _GAMMA * hbar
    w = t ** (-_KAPPA)
    leb = w * log_eps + (1.0 - w) * leb
    return (torch.exp(log_eps), mu, leb, hbar, t)


def _cached(precompute: Callable, b):
    """precompute over the chains, without gradients: the factor module
    with its tensors batched (C, ...); on the card one CUDA graph kept for
    `precompute`."""

    def fn(b_):
        held = {}

        def leaves(b1):
            held["aux"] = precompute(b1)
            return held["aux"].tensors()

        out = torch.func.vmap(leaves)(b_)
        return held["aux"].with_tensors(out)

    with torch.no_grad():
        return graphs.run(precompute, fn, b, static="precompute")


def block_a(logprob_a: Callable) -> Callable:
    """vg(a (C, Da), aux, b (C, Db)) -> (target, gradient in a): block A's
    value and gradient over the chains, against `aux`, the factor module
    `_cached` batched."""
    def vg(a, aux, b):
        lp = lambda a1, lv, b1: logprob_a(a1, aux.with_tensors(lv), b1)  # noqa: E731
        return batched_value_and_grad(lp, 0, 0)(a, aux.tensors(), b)

    vg.__wrapped__ = logprob_a
    return vg


def _on_card(a) -> bool:
    return a.is_cuda


def _fused(logprob_a: Callable, a):
    """Block A's `ops.leapfrog.ProbitA` when the fused route takes it, else
    None."""
    block = getattr(logprob_a, "fused", None)
    if block is None or not (_on_card(a) and leapfrog.fits(a.shape[1], a.dtype)):
        return None
    return block


def _fused_iteration(block, aux, const, a, t, g, stream, eps, Lmin: int, Lmax: int):
    """One A transition of every chain on the fused route: `hmc_iteration`'s
    draws from `stream` in its order (z, L, u), then one launch."""
    C, D = a.shape
    z, L, u = stream.hmc(C, D, Lmin, Lmax, a)
    return leapfrog.transition(block, aux, const, a, t, g, z, L, torch.log(u), eps, Lmax)


def split_hmc(precompute: Callable, logprob_a: Callable, logprob_b: Callable, a0, b0,
              generator=None, n_iter: int = 1000, a_iters: int = 4, eps_a: float = 0.2,
              eps_b: float = 0.05, Lmin: int = 5, Lmax: int = 15, Lmin_b: int | None = None,
              Lmax_b: int | None = None, n_warmup: int = 0,
              target_accept: float = 0.8) -> SplitHMCResult:
    """Alternate `a_iters` HMC updates of block A (`logprob_a(a, aux, b)`
    with `aux = precompute(b)` cached over the whole A sweep) with one HMC
    update of block B (`logprob_b(b, a)`, refactorizing at every leapfrog
    step), for one chain (a0 (Da,), b0 (Db,)) or C chains at once (a0
    (C, Da), b0 (C, Db)).

    Both logprobs return the FULL joint log target, written for one chain;
    precompute(b) returns a Module (the factor). One draw is recorded per
    A update: (a_i, b_current) is a joint state after every sub-update.
    n_warmup is additive: n_warmup + n_iter outer iterations run, and with
    n_warmup > 0 each block's step size adapts by dual averaging on its mean
    accept probability toward `target_accept` over the warmup, then freezes
    at its averaged value. `samples` holds only the post-warmup rows; the
    warmup rows are `warmup_samples`; accept rates count post-warmup
    proposals. `generator`: a torch.Generator on the chains' device, or a
    RandomStream."""
    single = a0.ndim == 1
    a = (a0[None] if single else a0).detach()
    b = (b0[None] if single else b0).detach()
    C, Da = a.shape
    Db = b.shape[1]
    Lmin_b = Lmin if Lmin_b is None else Lmin_b
    Lmax_b = Lmax if Lmax_b is None else Lmax_b
    stream = as_stream(generator, a)
    st_a = da_init(torch.full((C,), eps_a, dtype=a.dtype, device=a.device))
    st_b = da_init(torch.full((C,), eps_b, dtype=a.dtype, device=a.device))
    total = n_warmup + n_iter
    draws = a.new_empty((C, total * a_iters, Da + Db))
    acc_a = torch.zeros(C, dtype=torch.int64, device=a.device)
    acc_b = torch.zeros_like(acc_a)
    vg_a = block_a(logprob_a)
    vg_b = batched_value_and_grad(logprob_b, 0)
    fused = _fused(logprob_a, a)
    t_b = None
    with torch.no_grad():
        for it in range(total):
            with span("gp.split.outer"):
                in_warm = it < n_warmup
                # during warmup the exploring step sizes, after it the averaged
                eps_a_c = st_a[0] if in_warm else torch.exp(st_a[2])
                eps_b_c = st_b[0] if in_warm else torch.exp(st_b[2])

                # A sweep against the cached factor
                aux = _cached(precompute, b)
                t_a, g_a = start(vg_a, a, (aux, b))
                const = None if fused is None else fused.prior(b)
                acc_sweep = torch.zeros_like(acc_a)
                ap_sum = torch.zeros_like(st_a[0])
                for j in range(a_iters):
                    if fused is None:
                        a, t_a, g_a, aprob, accd = hmc_iteration(vg_a, a, t_a, g_a, stream,
                                                                 eps_a_c, Lmin, Lmax,
                                                                 rest=(aux, b))
                        ROUTES["graphed"] += 1
                    else:
                        a, t_a, g_a, aprob, accd = _fused_iteration(fused, aux, const, a, t_a,
                                                                    g_a, stream, eps_a_c, Lmin,
                                                                    Lmax)
                        ROUTES["fused"] += 1
                    acc_sweep += accd
                    ap_sum = ap_sum + aprob
                    k = it * a_iters + j
                    draws[:, k, :Da] = a
                    draws[:, k, Da:] = b

                # B update, refactorizing at every leapfrog step
                t_b, g_b = start(vg_b, b, (a,))
                b, t_b, g_b, aprob_b, accd_b = hmc_iteration(vg_b, b, t_b, g_b, stream, eps_b_c,
                                                             Lmin_b, Lmax_b, rest=(a,))
                if in_warm:
                    st_a = da_update(ap_sum / a_iters, st_a, target_accept)
                    st_b = da_update(aprob_b, st_b, target_accept)
                else:
                    acc_a += acc_sweep
                    acc_b += accd_b
    eps_a_f = torch.exp(st_a[2]) if n_warmup > 0 else st_a[0]
    eps_b_f = torch.exp(st_b[2]) if n_warmup > 0 else st_b[0]
    w = n_warmup * a_iters
    out = SplitHMCResult(
        samples=draws[:, w:], warmup_samples=draws[:, :w],
        accept_rate_a=acc_a.to(a.dtype) / (n_iter * a_iters),
        accept_rate_b=acc_b.to(a.dtype) / n_iter,
        final=torch.cat([a, b], dim=-1),
        final_target=t_b if t_b is not None else torch.full((C,), math.nan, dtype=a.dtype,
                                                            device=a.device),
        eps_a_final=eps_a_f, eps_b_final=eps_b_f)
    if single:
        out = SplitHMCResult(*(getattr(out, f)[0] for f in out.__dataclass_fields__))
    return out
