"""Chain-parallel MCMC over a process mesh with collective adaptation
(counterpart of `gaussianprocesses_jl_tpu/parallel/chains.py`; the
BASELINE's configuration #5, "1024 chains ... with collective adaptation").

Each process holds a contiguous block of the C chains (its rows along the
mesh axis) and runs them as one batch through the samplers' cores of
`inference/` (`hmc_iteration`, `ess_iteration`, the split sampler's cached
factor and dual averaging), so every gram of an iteration is one launch for
all of its chains. Adaptation is collective, as in the JAX package:

  * `sharded_hmc`: one dual-averaging step size for every chain on every
    process, from the fleet-mean acceptance; during warmup a shared
    diagonal inverse mass matrix, estimated twice from the moments of every
    chain over a window, with Stan's shrinkage and a restart of the dual
    averaging at each update;
  * `sharded_split_hmc`: one step size for each block, from the fleet-mean
    acceptance of the A sweeps and of the B updates;
  * `sharded_ess`: the fleet's mean shrink-proposal count.

Two choices differ from the JAX package, so that a run's bits do not depend
on how many processes share it:

  * reductions gather the per-chain statistics (a few numbers a chain) in
    chain order and sum them on every process, where the JAX package sums
    each device's partial sum with `psum`;
  * every random number of global iteration `it` comes from one generator
    seeded from (seed, it), and every process draws the whole (C, ...) block
    and keeps its own rows. The JAX package folds `it` into a key carried by
    each chain. A test passes a function of `it` in place of the seed to
    replay the JAX package's draws.

On the card each chain block's start and transitions replay the CUDA
graphs of `inference/` (`utils/graphs.py`), kept for the log targets; the
collectives, the draws and the checkpoints stay outside every graph.

So a resumed or segmented run, or one over another number of processes,
gives the bits of one uninterrupted run, and a checkpoint needs no
generator state: `sharded_hmc` writes its state (per-chain leaves gathered
in chain order, by the process of rank 0) every `checkpoint_every`
iterations and resumes from an existing `checkpoint_path`.

Every process returns the whole (C, ...) result.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from ..inference.ess import SHRINK_BLOCK, _safe, batched_loglik, ess_iteration
from ..inference.hmc import RandomStream, batched_value_and_grad, hmc_iteration, start
from ..inference.split import _cached, block_a, da_init, da_update
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .mesh import Mesh

__all__ = ["sharded_hmc", "ShardedHMCResult", "sharded_split_hmc", "ShardedSplitHMCResult",
           "sharded_ess", "ShardedESSResult"]

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finalizer."""
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _iteration_stream(seed: int, it: int, device) -> RandomStream:
    """The RandomStream of global iteration `it`: a generator on `device`
    seeded from (seed, it)."""
    s = _mix((_mix(int(seed) & _MASK64) + 0x9E3779B97F4A7C15 * (it + 1)) & _MASK64)
    return RandomStream(torch.Generator(device=device).manual_seed(s >> 1))


class _Rows(RandomStream):
    """Rows [lo, hi) of the draws a stream makes for all C chains."""

    def __init__(self, stream: RandomStream, C: int, lo: int, hi: int):
        super().__init__(None)
        self.stream, self.C, self.rows = stream, C, slice(lo, hi)

    def hmc(self, c, D, Lmin, Lmax, like):
        return tuple(a[self.rows] for a in self.stream.hmc(self.C, D, Lmin, Lmax, like))

    def ess_start(self, c, D, like):
        return tuple(a[self.rows] for a in self.stream.ess_start(self.C, D, like))

    def ess_shrink_block(self, R, c, like):
        return self.stream.ess_shrink_block(R, self.C, like)[:, self.rows]


class _Fleet:
    """One process's share of C chains along `axis` of `mesh`: its rows,
    its streams, and the gathers and ordered sums over every chain."""

    def __init__(self, mesh: Mesh, axis: str, C: int, seed):
        n_dev = mesh.shape[axis]
        if C % n_dev:
            raise ValueError(f"{C} chains not divisible by {n_dev} processes")
        c = C // n_dev
        self.mesh, self.axis, self.C = mesh, axis, C
        self.lo, self.hi = mesh.coords[axis] * c, (mesh.coords[axis] + 1) * c
        self.seed = seed

    def stream(self, it: int) -> RandomStream:
        s = (self.seed(it) if callable(self.seed)
             else _iteration_stream(self.seed, it, self.mesh.device))
        return _Rows(s, self.C, self.lo, self.hi)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(c, ...) on each process -> (C, ...) in chain order."""
        return self.mesh.all_gather(x, self.axis)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The fleet mean of a per-chain statistic x (c,), summed in chain
        order on every process."""
        return torch.sum(self.gather(x)) / self.C


def _rows(theta0, fleet: _Fleet) -> torch.Tensor:
    return torch.as_tensor(theta0).detach().to(fleet.mesh.device)[fleet.lo:fleet.hi].clone()


@dataclass
class ShardedHMCResult:
    samples: torch.Tensor  # (C, n_keep, D)
    accept_rate: torch.Tensor  # (C,)
    eps_final: torch.Tensor  # ()
    minv_final: torch.Tensor  # (D,) the shared diagonal inverse mass matrix
    final: torch.Tensor  # (C, D)
    final_target: torch.Tensor  # (C,)


_PER_CHAIN = ("theta", "tgt", "grad", "acc", "s1", "s2")


def _save_state(fleet: _Fleet, path: str, carry: dict, it_done: int, samples) -> None:
    """Gather the per-chain leaves in chain order; the process of rank 0
    writes the file, and no process goes on before it is in place."""
    state = {"carry": {k: fleet.gather(v) if k in _PER_CHAIN else v for k, v in carry.items()},
             "it_done": it_done, "samples": fleet.gather(samples)}
    if not dist.is_initialized() or dist.get_rank() == 0:
        save_checkpoint(path, state)
    if dist.is_initialized():
        dist.barrier()


def sharded_hmc(logprob_fn: Callable, theta0, seed, mesh: Mesh, *, axis: str = "chains",
                n_iter: int = 1000, n_warmup: int = 0, eps0: float = 0.1, Lmin: int = 5,
                Lmax: int = 15, target_accept: float = 0.8, thin: int = 1,
                adapt_mass: bool = True, checkpoint_every: int | None = None,
                checkpoint_path: str | None = None,
                segment_iters: int | None = None) -> ShardedHMCResult:
    """C chains of HMC on a per-chain log target, sharded over `mesh` axis
    `axis`.

    theta0: (C, D), C divisible by the axis size. seed: an int, or a
    function of the global iteration returning the RandomStream of that
    iteration's draws for all C chains. During the first `n_warmup`
    iterations the step size adapts by collective dual averaging, and (when
    `adapt_mass` and n_warmup >= 20) a shared diagonal inverse mass matrix
    is estimated twice: at n_warmup/2 from the window [n_warmup/4,
    n_warmup/2) and at 3 n_warmup/4 from [n_warmup/2, 3 n_warmup/4), each
    time restarting the dual averaging at the current step size. Warmup
    draws are dropped; every `thin`-th draw is kept.

    checkpoint_every/checkpoint_path: write the sampler's state every k
    iterations; an existing `checkpoint_path` resumes the run. segment_iters:
    run in segments of this many iterations, writing nothing. Either gives
    the bits of one uninterrupted run."""
    C, D = theta0.shape
    fleet = _Fleet(mesh, axis, C, seed)
    if (checkpoint_every is None) != (checkpoint_path is None):
        raise ValueError("checkpoint_every and checkpoint_path must be given together")
    total = n_warmup + n_iter
    vg = batched_value_and_grad(logprob_fn)
    schedule = _Schedule(n_warmup, Lmin, Lmax, target_accept, adapt_mass)

    with torch.no_grad():
        theta = _rows(theta0, fleet)
        c, dt = theta.shape[0], theta.dtype
        tgt, grad = start(vg, theta)
        eps_t = torch.as_tensor(eps0, dtype=dt, device=theta.device)
        eps, mu, leb, hbar, t = da_init(eps_t)
        carry = {"theta": theta, "tgt": tgt, "grad": grad,
                 "acc": torch.zeros(c, dtype=dt, device=theta.device),
                 "da": (eps, mu, leb, hbar, t), "minv": torch.ones(D, dtype=dt, device=theta.device),
                 "s1": torch.zeros_like(theta), "s2": torch.zeros_like(theta), "n_win": 0}
        samples = theta.new_zeros((c, total, D))
        it_done = 0
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            like = {"carry": {k: v.new_zeros((C, *v.shape[1:])) if k in _PER_CHAIN else v
                              for k, v in carry.items()},
                    "it_done": 0, "samples": samples.new_zeros((C, total, D))}
            st = load_checkpoint(checkpoint_path, like)
            carry = {k: v[fleet.lo:fleet.hi].clone() if k in _PER_CHAIN else v
                     for k, v in st["carry"].items()}
            it_done = st["it_done"]
            samples = st["samples"][fleet.lo:fleet.hi].clone()

        seg = checkpoint_every or segment_iters or total
        while it_done < total:
            for it in range(it_done, min(it_done + seg, total)):
                _hmc_step(carry, it, vg, fleet, schedule)
                samples[:, it] = carry["theta"]
            it_done = min(it_done + seg, total)
            if checkpoint_path is not None and it_done < total:
                _save_state(fleet, checkpoint_path, carry, it_done, samples)

        kept = fleet.gather(samples[:, n_warmup:][:, ::thin])
        return ShardedHMCResult(samples=kept, accept_rate=fleet.gather(carry["acc"]) / n_iter,
                                eps_final=carry["da"][0], minv_final=carry["minv"],
                                final=fleet.gather(carry["theta"]),
                                final_target=fleet.gather(carry["tgt"]))


class _Schedule:
    """`sharded_hmc`'s settings: the warmup, the path lengths, the target
    acceptance, and (when the mass matrix adapts: n_warmup >= 20) the two
    mass-update iterations and the moment windows that end at them."""

    def __init__(self, n_warmup, Lmin, Lmax, target_accept, adapt_mass=True):
        self.n_warmup, self.Lmin, self.Lmax = n_warmup, Lmin, Lmax
        self.target_accept = target_accept
        self.do_mass = bool(adapt_mass) and n_warmup >= 20
        w2, w34 = n_warmup // 2, (3 * n_warmup) // 4
        self.updates = (w2 - 1, w34 - 1)
        self.windows = (range(n_warmup // 4, w2), range(w2, w34))


def _hmc_step(carry, it, vg, fleet, sch: _Schedule) -> None:
    """Global iteration `it` of `sharded_hmc`, updating `carry` in place."""
    eps = carry["da"][0]
    theta, tgt, grad, aprob, accepted = hmc_iteration(
        vg, carry["theta"], carry["tgt"], carry["grad"], fleet.stream(it), eps, sch.Lmin,
        sch.Lmax, minv=carry["minv"])
    carry.update(theta=theta, tgt=tgt, grad=grad)
    in_warmup = it < sch.n_warmup
    eps_n, mu, leb_n, hbar_n, t = da_update(fleet.mean(aprob), carry["da"], sch.target_accept)
    _, _, leb, hbar, _ = carry["da"]
    if in_warmup:
        carry["da"] = (eps_n, mu, leb_n, hbar_n, t)
    else:
        carry["da"] = (torch.exp(leb), mu, leb, hbar, t)
    if sch.do_mass:
        if any(it in w for w in sch.windows):
            carry["s1"] = carry["s1"] + theta
            carry["s2"] = carry["s2"] + theta * theta
            carry["n_win"] += 1
        if it in sch.updates:
            cnt = float(carry["n_win"] * fleet.C)
            m = torch.sum(fleet.gather(carry["s1"]), dim=0) / max(cnt, 1.0)
            var = torch.sum(fleet.gather(carry["s2"]), dim=0) / max(cnt, 1.0) - m * m
            # Stan's shrinkage toward a small unit scale for short windows
            var = (cnt / (cnt + 5.0)) * var + (5.0 / (cnt + 5.0)) * 1e-3
            carry["minv"] = torch.clamp(var, min=1e-10)
            # restart the dual averaging at the current step size
            eps = carry["da"][0]
            zero = torch.zeros_like(eps)
            carry["da"] = (eps, torch.log(10.0 * eps), torch.log(eps), zero, zero)
            carry["s1"] = torch.zeros_like(carry["s1"])
            carry["s2"] = torch.zeros_like(carry["s2"])
            carry["n_win"] = 0
    if not in_warmup:
        carry["acc"] = carry["acc"] + accepted.to(carry["acc"].dtype)


@dataclass
class ShardedSplitHMCResult:
    samples: torch.Tensor  # (C, n_iter * a_iters, Da + Db) post-warmup
    warmup_samples: torch.Tensor  # (C, n_warmup * a_iters, Da + Db)
    accept_rate_a: torch.Tensor  # (C,) post-warmup acceptance
    accept_rate_b: torch.Tensor  # (C,)
    eps_a_final: torch.Tensor  # () the shared adapted step sizes
    eps_b_final: torch.Tensor  # ()
    final: torch.Tensor  # (C, Da + Db)
    final_target: torch.Tensor  # (C,)


def sharded_split_hmc(precompute: Callable, logprob_a: Callable, logprob_b: Callable, theta0,
                      seed, mesh: Mesh, na: int, *, axis: str = "chains", n_iter: int = 1000,
                      a_iters: int = 8, n_warmup: int = 0, eps_a0: float = 0.2,
                      eps_b0: float = 0.05, Lmin: int = 5, Lmax: int = 15,
                      Lmin_b: int | None = None, Lmax_b: int | None = None,
                      target_accept: float = 0.8,
                      segment_iters: int | None = None) -> ShardedSplitHMCResult:
    """Chain-sharded split-block HMC (`inference/split.py`'s factor-cached
    sampler) with collective per-block dual averaging: during the first
    `n_warmup` outer iterations eps_a adapts on the fleet-mean accept
    probability of the A sweeps and eps_b on that of the B updates, each
    shared by every chain on every process.

    theta0: (C, na + nb), [a; b] per chain, C divisible by the axis size;
    seed as for `sharded_hmc`. n_warmup is additive. A draw is recorded per
    A update, pairing a_i with the b in force during the sweep; `samples`
    holds the post-warmup rows, `warmup_samples` the warmup rows.
    Lmin_b/Lmax_b: the B block's path lengths (default Lmin/Lmax).
    segment_iters: run in segments of this many outer iterations, with the
    bits of one run."""
    C, D = theta0.shape
    fleet = _Fleet(mesh, axis, C, seed)
    Lmin_b = Lmin if Lmin_b is None else Lmin_b
    Lmax_b = Lmax if Lmax_b is None else Lmax_b
    total = n_warmup + n_iter
    vg_a = block_a(logprob_a)
    vg_b = batched_value_and_grad(logprob_b, 0)

    with torch.no_grad():
        theta = _rows(theta0, fleet)
        a, b = theta[:, :na].contiguous(), theta[:, na:].contiguous()
        c, dt, dev = a.shape[0], a.dtype, a.device
        st_a = da_init(torch.as_tensor(eps_a0, dtype=dt, device=dev))
        st_b = da_init(torch.as_tensor(eps_b0, dtype=dt, device=dev))
        draws = a.new_empty((c, total * a_iters, D))
        acc_a = torch.zeros(c, dtype=torch.int64, device=dev)
        acc_b = torch.zeros_like(acc_a)
        t_b = None
        seg = segment_iters or total
        for first in range(0, total, seg):
            for it in range(first, min(first + seg, total)):
                stream = fleet.stream(it)
                in_warm = it < n_warmup
                eps_a = st_a[0] if in_warm else torch.exp(st_a[2])
                eps_b = st_b[0] if in_warm else torch.exp(st_b[2])

                # the A sweep against each chain's cached factor
                aux = _cached(precompute, b)
                t_a, g_a = start(vg_a, a, (aux, b))
                acc_sweep = torch.zeros_like(acc_a)
                ap_sum = torch.zeros(c, dtype=dt, device=dev)
                for j in range(a_iters):
                    a, t_a, g_a, aprob, accd = hmc_iteration(vg_a, a, t_a, g_a, stream, eps_a,
                                                             Lmin, Lmax, rest=(aux, b))
                    acc_sweep += accd
                    ap_sum = ap_sum + aprob
                    # (a_i, the b in force), recorded before the B update
                    draws[:, it * a_iters + j, :na] = a
                    draws[:, it * a_iters + j, na:] = b

                # the B update, refactorizing at every leapfrog step
                t_b, g_b = start(vg_b, b, (a,))
                b, t_b, _, ap_b, acc_b_d = hmc_iteration(vg_b, b, t_b, g_b, stream, eps_b, Lmin_b,
                                                         Lmax_b, rest=(a,))

                if in_warm:
                    st_a = da_update(fleet.mean(ap_sum / a_iters), st_a, target_accept)
                    st_b = da_update(fleet.mean(ap_b), st_b, target_accept)
                else:
                    acc_a += acc_sweep
                    acc_b += acc_b_d

        draws = fleet.gather(draws)
        w = n_warmup * a_iters
        return ShardedSplitHMCResult(
            samples=draws[:, w:], warmup_samples=draws[:, :w],
            accept_rate_a=fleet.gather(acc_a).to(dt) / (n_iter * a_iters),
            accept_rate_b=fleet.gather(acc_b).to(dt) / n_iter,
            eps_a_final=torch.exp(st_a[2]), eps_b_final=torch.exp(st_b[2]),
            final=fleet.gather(torch.cat([a, b], dim=1)), final_target=fleet.gather(t_b))


@dataclass
class ShardedESSResult:
    samples: torch.Tensor  # (C, n_iter, D)
    mean_proposals: torch.Tensor  # () the fleet's mean shrink proposals an iteration
    final: torch.Tensor  # (C, D)
    final_loglik: torch.Tensor  # (C,)


def sharded_ess(loglik_fn: Callable, theta0, prior_mu, prior_sigma, seed, mesh: Mesh, *,
                axis: str = "chains", n_iter: int = 1000,
                rounds: int = SHRINK_BLOCK) -> ShardedESSResult:
    """C elliptical-slice chains (`inference/ess.py`) sharded over `mesh`
    axis `axis`, with independent Normal priors N(prior_mu, prior_sigma^2);
    the mean shrink-proposal count is pooled over the fleet. theta0: (C,
    D), C divisible by the axis size; seed as for `sharded_hmc`; `rounds`
    shrink rounds a block. A process runs blocks while any of its own
    chains shrinks; the gathers follow the last iteration."""
    C, D = theta0.shape
    fleet = _Fleet(mesh, axis, C, seed)
    with torch.no_grad():
        f = _rows(theta0, fleet)
        prior_mu = torch.as_tensor(prior_mu, dtype=f.dtype, device=f.device)
        prior_sigma = torch.as_tensor(prior_sigma, dtype=f.dtype, device=f.device)
        ll_fn = batched_loglik(loglik_fn)
        ll_f = _safe(ll_fn(f))
        samples = f.new_empty((f.shape[0], n_iter, D))
        props = torch.zeros(f.shape[0], dtype=torch.int64, device=f.device)
        for it in range(n_iter):
            f, ll_f, p = ess_iteration(ll_fn, f, ll_f, prior_mu, prior_sigma, fleet.stream(it),
                                       rounds)
            samples[:, it] = f
            props += p
        mean_props = fleet.mean(props.to(torch.float32) / n_iter)
        return ShardedESSResult(samples=fleet.gather(samples), mean_proposals=mean_props,
                                final=fleet.gather(f), final_loglik=fleet.gather(ll_f))
