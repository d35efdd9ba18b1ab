"""User-facing MCMC entry points `mcmc` (HMC) and `ess` (elliptical slice)
(counterpart of `gaussianprocesses_jl_tpu/inference/mcmc.py`).

As in the JAX package, and unlike the reference: samples are (n_kept, D), a
row a draw; `burn` is the number of leading draws dropped; `chains=k` runs k
chains at once, here as one batch (every target evaluation covers all
chains in one batched call), starts jittered by 0.01 around the current
state. A `torch.Generator` on the model's device (or a RandomStream) takes
the place of the JAX key; its draws differ from `jax.random`'s.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.priors import Normal
from .ess import ess as _ess_kernel
from .hmc import as_stream
from .hmc import hmc as _hmc_kernel

__all__ = ["mcmc", "ess", "MCMCResult"]


@dataclass
class MCMCResult:
    samples: torch.Tensor  # (n_kept, D) or (chains, n_kept, D)
    accept_rate: float | torch.Tensor | None  # HMC only; None for ess()
    final: torch.Tensor
    # ess(): mean shrink proposals an iteration (ESS has no accept step)
    mean_proposals: float | torch.Tensor | None = None

    @property
    def posterior(self):
        """The reference's (D, n) layout."""
        return self.samples.transpose(-1, -2)


def _flags_for(gp, kwargs):
    return {n: bool(kwargs.pop(n, True)) for n in gp.block_flag_names()}


def _starts(x0, chains, stream):
    """x0 jittered by 0.01 standard normals, one row a chain."""
    return x0[None, :] + 0.01 * stream.normal((chains, x0.shape[0]), x0)


def _best(final_target) -> int:
    return int(torch.argmax(final_target))


def mcmc(gp, generator=None, n_iter: int = 1000, burn: int = 0, thin: int = 1,
         eps: float = 0.1, Lmin: int = 5, Lmax: int = 15, chains: int | None = None,
         verbose: bool = True, sampler: str = "joint", a_iters: int = 8,
         eps_a: float | None = None, eps_b: float | None = None, n_warmup: int = 0,
         **flag_kwargs) -> MCMCResult:
    """HMC over the model's sampled parameter vector: GPE -> [lognoise;
    mean; kernel], GPA -> [v; lik; mean; kernel]. Block flags
    (noise/lik/domean/kern) select hyperparameter blocks.

    sampler="split" (GPA only): the factor-cached Metropolis-within-Gibbs
    sampler (`inference/split.py`), `a_iters` updates of [v; lik; mean]
    against the cached factor per kernel-block update, step sizes eps_a and
    eps_b (default eps), adapted by dual averaging over `n_warmup` additional
    warmup iterations. All blocks are sampled: it rejects block flags. It
    records a draw per A update, so n_iter outer iterations give
    n_iter * a_iters rows, warmup rows excluded. The model takes the final
    state of its best chain (by final target)."""
    like = gp.params.flat_params()
    stream = as_stream(generator, like)
    if sampler == "split":
        return _mcmc_split(gp, stream, n_iter=n_iter, burn=burn, thin=thin, a_iters=a_iters,
                           eps_a=eps if eps_a is None else eps_a,
                           eps_b=eps if eps_b is None else eps_b, Lmin=Lmin, Lmax=Lmax,
                           chains=chains, verbose=verbose, flag_kwargs=flag_kwargs,
                           n_warmup=n_warmup)
    if sampler != "joint":
        raise ValueError(f"unknown sampler {sampler!r} (expected 'joint' or 'split')")
    flags = _flags_for(gp, flag_kwargs)
    if flag_kwargs:
        raise TypeError(f"unknown mcmc() arguments: {sorted(flag_kwargs)}")
    logprob, x0, _, _ = gp.make_logprob(**flags)

    if chains is None:
        res = _hmc_kernel(logprob, x0, stream, n_iter=n_iter, eps=eps, Lmin=Lmin, Lmax=Lmax)
        samples = res.samples[burn::thin]
        gp.set_params(res.final, **flags)
        accept = float(res.accept_rate)
    else:
        res = _hmc_kernel(logprob, _starts(x0, chains, stream), stream, n_iter=n_iter, eps=eps,
                          Lmin=Lmin, Lmax=Lmax)
        samples = res.samples[:, burn::thin]
        gp.set_params(res.final[_best(res.final_target)], **flags)
        accept = res.accept_rate

    if verbose:
        print(f"HMC: iterations={n_iter} burn={burn} thin={thin} kept={samples.shape[-2]} "
              f"eps={eps} L=[{Lmin},{Lmax}] "
              f"accept_rate={float(torch.as_tensor(accept).mean()):.4f}")
    return MCMCResult(samples=samples, accept_rate=accept, final=res.final)


def _mcmc_split(gp, stream, *, n_iter, burn, thin, a_iters, eps_a, eps_b, Lmin, Lmax, chains,
                verbose, flag_kwargs, n_warmup=0):
    from ..models.gpa import GPA as _GPA
    from .split import split_hmc as _split_kernel

    if not isinstance(gp, _GPA):
        raise TypeError("sampler='split' requires a GPA model (the split is "
                        "[v; lik; mean] vs [kern])")
    if flag_kwargs:
        # every extra kwarg, truthy or not: block flags are unsupported here
        # whatever their value, and a misspelt name must not pass silently
        raise ValueError("block flags are not supported with sampler='split' (all blocks "
                         f"are sampled); got {sorted(flag_kwargs)}")
    precompute, lp_a, lp_b, a0, b0 = gp.make_split_logprob()
    na = a0.shape[0]
    kw = dict(n_iter=n_iter, a_iters=a_iters, eps_a=eps_a, eps_b=eps_b, Lmin=Lmin, Lmax=Lmax,
              n_warmup=n_warmup)
    if chains is None:
        res = _split_kernel(precompute, lp_a, lp_b, a0, b0, stream, **kw)
        samples = res.samples[burn::thin]
        gp.set_params(res.final)
    else:
        x0s = _starts(torch.cat([a0, b0]), chains, stream)
        res = _split_kernel(precompute, lp_a, lp_b, x0s[:, :na], x0s[:, na:], stream, **kw)
        samples = res.samples[:, burn::thin]
        gp.set_params(res.final[_best(res.final_target)])
    # [accept_a, accept_b] (one pair a chain when chains=k)
    accept = torch.stack([res.accept_rate_a, res.accept_rate_b], dim=-1)

    if verbose:
        acc = accept.reshape(-1, 2).mean(0).tolist()
        print(f"split-HMC: outer={n_iter} a_iters={a_iters} burn={burn} thin={thin} "
              f"kept={samples.shape[-2]} eps=[{eps_a},{eps_b}] L=[{Lmin},{Lmax}] "
              f"accept[a,b]=[{acc[0]:.4f}, {acc[1]:.4f}]")
    return MCMCResult(samples=samples, accept_rate=accept, final=res.final)


def ess(gp, generator=None, n_iter: int = 1000, burn: int = 0, thin: int = 1,
        chains: int | None = None, verbose: bool = True, **flag_kwargs) -> MCMCResult:
    """Elliptical slice sampling of GPE hyperparameters. Every selected
    parameter must carry a Normal prior; the slice likelihood is the mll
    (the priors enter through the ellipse). With chains=k the model takes
    the final state of the chain with the best final mll."""
    from ..models.gpe import GPE as _GPE

    if not isinstance(gp, _GPE):
        raise TypeError("ess operates on GPE hyperparameters only")
    flags = _flags_for(gp, flag_kwargs)
    if flag_kwargs:
        raise TypeError(f"unknown ess() arguments: {sorted(flag_kwargs)}")

    # the joint Normal prior over the active blocks
    priors_all = _model_priors_flat(gp)
    mus, sigmas = [], []
    for name, s in zip(gp.block_flag_names(), gp.params.block_slices()):
        if not flags[name]:
            continue
        for i in range(s.start, s.stop):
            pr = priors_all[i]
            if not isinstance(pr, Normal):
                raise ValueError("ess requires all active parameters to have Normal priors; "
                                 f"parameter {i} has {pr!r}")
            mus.append(pr.mu)
            sigmas.append(pr.sigma)

    loglik, x0, _, _ = gp.make_logprob(include_priors=False, **flags)
    stream = as_stream(generator, x0)
    if chains is None:
        res = _ess_kernel(loglik, x0, mus, sigmas, stream, n_iter=n_iter)
        samples = res.samples[burn::thin]
        gp.set_params(res.final, **flags)
        props = float(res.mean_proposals)
    else:
        # jittered starts: identical ones would blind split-R-hat to modes
        res = _ess_kernel(loglik, _starts(x0, chains, stream), mus, sigmas, stream,
                          n_iter=n_iter)
        samples = res.samples[:, burn::thin]
        gp.set_params(res.final[_best(res.final_loglik)], **flags)
        props = res.mean_proposals

    if verbose:
        print(f"ESS: iterations={n_iter} burn={burn} thin={thin} "
              f"mean_proposals_per_iter={float(torch.as_tensor(props).mean()):.3f}")
    return MCMCResult(samples=samples, accept_rate=None, final=res.final, mean_proposals=props)


def _model_priors_flat(gp):
    """Priors aligned with the model's full flat parameter vector; a GPA's
    latents v have the implicit N(0, 1)."""
    from ..models.gpe import GPE as _GPE

    p = gp.params
    if isinstance(gp, _GPE):
        return p.lognoise.priors_flat() + p.mean.priors_flat() + p.kernel.priors_flat()
    return ([Normal(0.0, 1.0)] * p.v.numel() + p.lik.priors_flat() + p.mean.priors_flat()
            + p.kernel.priors_flat())
