"""Configuration #5 on the card: 1024 chains on Student-t robust regression
with collective adaptation, as the JAX package's
`bench.py::bench_student_t_1024` runs it.

Run on a machine with one NVIDIA GPU:

    python -m gaussianprocesses_jl_tpu_torch.perf.student_t_study

The configuration: n = 60 points, x = sort(2 pi U) and y = sin(x) + 0.15
noise from `RandomState(1)`, every 8th point moved by +-4 (outliers); a GPA
with `SE(0, 0)`, `StuTLik(lsigma=-1, nu=3)`, Normal(0, 2) priors on the
kernel and Normal(-1, 1) on lsigma: D = 63, f32. The chains start at
x0 + 0.05 N(0, 1) and run on one process (`make_mesh()`, the 'chains' axis
of size 1, every chain batched), three samplers:

  * `sharded_hmc`: 400 warmup + 1000 iterations, eps0 0.02, target 0.8,
    the shared dual-averaged step size and diagonal mass matrix;
  * `sharded_split_hmc`: 200 warmup + 2000 outer iterations, a_iters 4,
    eps_a0 0.2, eps_b0 0.05 ([v; lsigma] against the cached factor, [kern]
    refactorizing);
  * `sharded_ess` on the Gaussian-noise GPE counterpart (lognoise -1, its
    Normal priors): 300 iterations, the first third dropped, through its
    CUDA graphs (shrink rounds in blocks of `ess.SHRINK_BLOCK`) and eager.

Each timed run follows an untimed short one of its sampler (kernels built,
allocator warm). For each sampler it prints the wall time, ESS min and
median (multi-chain), ESS/s, R-hat max and `valid` (R-hat < 1.01), the
acceptance and the adapted step sizes; then for one iteration (one call of
the sampler over one iteration, its start evaluation included): the
launches by kernel and shape, the host enqueue, the CUDA-event time and the
device-busy time (torch.profiler), for `sharded_hmc` and `sharded_split_hmc`
both with their CUDA graphs (`utils/graphs.py`, the default) and eager
(inside `graphs.eager()`), in one process; and the elliptical slice's
block size swept (`ess_rounds_sweep`: R = 1, 4, 8, 16 shrink rounds a
block, an iteration's CUDA-event, host and busy ms, graphed and eager;
the ESS runs take the R with the shortest iteration).
The flags cut the depths and choose the samplers; the last line of the
output is the numbers as one JSON object.

    python -m gaussianprocesses_jl_tpu_torch.perf.student_t_study --samplers ess
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.inference.diagnostics import (
    effective_sample_size,
    split_rhat,
)
from gaussianprocesses_jl_tpu_torch.inference import ess as ess_mod
from gaussianprocesses_jl_tpu_torch.inference.hmc import RandomStream
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.parallel import (
    make_mesh,
    sharded_ess,
    sharded_hmc,
    sharded_split_hmc,
)
from gaussianprocesses_jl_tpu_torch.perf.gram_study import (by_shape, eagerly, enqueue_ms,
                                                            launches, time_ms)
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal
from gaussianprocesses_jl_tpu_torch.utils.profiling import card_line, device_profile

__all__ = ["config5_data", "config5_model", "config5_gpe", "chain_starts", "run_hmc",
           "run_split", "run_ess", "one_iteration", "ess_rounds_sweep", "main"]

N, CHAINS = 60, 1024
HMC_WARMUP, HMC_ITERS, EPS0, TARGET = 400, 1000, 0.02, 0.8
SPLIT_WARMUP, SPLIT_ITERS, A_ITERS, EPS_A0, EPS_B0 = 200, 2000, 4, 0.2, 0.05
ESS_ITERS = 300
SWEEP_ROUNDS = (1, 4, 8, 16)
PRIOR_MU, PRIOR_SIGMA = (-1.0, 0.0, 0.0), (1.0, 2.0, 2.0)


def config5_data(n=N):
    """(x, y) as `bench.py` and examples/robust_regression.py make them."""
    rng = np.random.RandomState(1)
    x = np.sort(2 * np.pi * rng.rand(n)).astype(np.float32)
    y = (np.sin(x) + 0.15 * rng.randn(n)).astype(np.float32)
    y[::8] += rng.choice([-4.0, 4.0], size=len(y[::8])).astype(np.float32)
    return x, y


def config5_model(device, dtype=np.float32, n=N):
    """The configuration's Student-t GPA and its priors."""
    x, y = config5_data(n)
    m = gp.GPA(x.astype(dtype), y.astype(dtype), gp.MeanZero(), gp.SE(0.0, 0.0),
               gp.StuTLik(lsigma=-1.0, nu=3), device=device)
    m.set_priors(kern=[Normal(0.0, 2.0)] * 2, lik=[Normal(-1.0, 1.0)])
    return m


def config5_gpe(device, dtype=np.float32, n=N):
    """The Gaussian-noise GPE counterpart that `sharded_ess` samples."""
    x, y = config5_data(n)
    m = gp.GPE(x.astype(dtype), y.astype(dtype), kernel=gp.SE(0.0, 0.0), lognoise=-1.0,
               device=device)
    m.set_priors(noise=[Normal(-1.0, 1.0)], kern=[Normal(0.0, 2.0)] * 2)
    return m


def chain_starts(x0, chains, seed):
    """x0 + 0.05 N(0, 1), (chains, D), drawn on x0's device."""
    g = torch.Generator(device=x0.device).manual_seed(seed)
    return x0 + 0.05 * torch.randn((chains, x0.numel()), generator=g, dtype=x0.dtype,
                                   device=x0.device)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _diagnostics(post, wall) -> dict:
    """ESS and R-hat of (C, n, D) draws, per second of `wall`."""
    ess = effective_sample_size(post).cpu().numpy()
    rhat = split_rhat(post).cpu().numpy()
    return {"ess_min": float(ess.min()), "ess_median": float(np.median(ess)),
            "ess_per_sec_min": float(ess.min()) / wall,
            "ess_per_sec_median": float(np.median(ess)) / wall,
            "rhat_max": float(np.nanmax(rhat)), "valid": bool(np.nanmax(rhat) < 1.01),
            "draws_finite": bool(torch.isfinite(post).all())}


def _hmc_call(dev, chains, n_iter, warmup, seed):
    logprob, x0, _, _ = config5_model(dev).make_logprob()
    starts = chain_starts(x0, chains, 17)
    mesh = make_mesh()
    return lambda: sharded_hmc(logprob, starts, seed, mesh, n_iter=n_iter, n_warmup=warmup,
                               eps0=EPS0, target_accept=TARGET)


def _split_call(dev, chains, n_iter, warmup, seed):
    precompute, lp_a, lp_b, a0, b0 = config5_model(dev).make_split_logprob()
    starts = chain_starts(torch.cat([a0, b0]), chains, 3)
    mesh = make_mesh()
    return lambda: sharded_split_hmc(precompute, lp_a, lp_b, starts, seed, mesh, a0.numel(),
                                     n_iter=n_iter, n_warmup=warmup, a_iters=A_ITERS,
                                     eps_a0=EPS_A0, eps_b0=EPS_B0, target_accept=TARGET)


def _ess_call(dev, chains, n_iter, seed, rounds=ess_mod.SHRINK_BLOCK):
    loglik, x0, _, _ = config5_gpe(dev).make_logprob(include_priors=False)
    starts = chain_starts(x0, chains, 2)
    mesh = make_mesh()
    return lambda: sharded_ess(loglik, starts, PRIOR_MU, PRIOR_SIGMA, seed, mesh,
                               n_iter=n_iter, rounds=rounds)


def run_hmc(dev, chains=CHAINS, n_iter=HMC_ITERS, warmup=HMC_WARMUP) -> dict:
    _hmc_call(dev, chains, 1, 0, 0)()
    res, wall = _timed(_hmc_call(dev, chains, n_iter, warmup, 1))
    return {"iters_post_warmup": n_iter, "warmup": warmup, "wall_s": wall,
            "accept_rate": float(res.accept_rate.mean()), "eps_adapted": float(res.eps_final),
            "minv_range": [float(res.minv_final.min()), float(res.minv_final.max())],
            **_diagnostics(res.samples, wall)}


def run_split(dev, chains=CHAINS, n_iter=SPLIT_ITERS, warmup=SPLIT_WARMUP) -> dict:
    _split_call(dev, chains, 1, 1, 0)()
    res, wall = _timed(_split_call(dev, chains, n_iter, warmup, 1))
    return {"iters_post_warmup": n_iter, "warmup": warmup, "a_iters": A_ITERS, "wall_s": wall,
            "accept_a": float(res.accept_rate_a.mean()),
            "accept_b": float(res.accept_rate_b.mean()),
            "eps_a_adapted": float(res.eps_a_final), "eps_b_adapted": float(res.eps_b_final),
            **_diagnostics(res.samples, wall)}


def run_ess(dev, chains=CHAINS, n_iter=ESS_ITERS, eager=False,
            rounds=ess_mod.SHRINK_BLOCK) -> dict:
    """The ESS run, through its CUDA graphs or eagerly (`eager`), `rounds`
    shrink rounds a block."""
    way = eagerly if eager else (lambda f: f)
    way(_ess_call(dev, chains, 2, 0, rounds))()
    res, wall = _timed(way(_ess_call(dev, chains, n_iter, 1, rounds)))
    return {"iters": n_iter, "dropped": n_iter // 3, "wall_s": wall,
            "rounds_a_block": rounds, "mean_proposals": float(res.mean_proposals),
            **_diagnostics(res.samples[:, n_iter // 3:], wall)}


def ess_rounds_sweep(dev, chains=CHAINS, rounds=SWEEP_ROUNDS, iters=20, burn=20) -> dict:
    """For each R in `rounds`: `iters` elliptical-slice iterations of every
    chain from the state after `burn` iterations, the same draws each time
    (a generator a seeded iteration), R shrink rounds a block, through the
    CUDA graphs and eagerly: ms an iteration by CUDA events (median of 10
    calls after 2), host ms an iteration until the call returns (each block
    reads one flag, so the host waits for the card), device-busy ms an
    iteration (torch.profiler; None where it saw no kernel), the blocks an
    iteration, the launches and the mean proposals."""
    loglik, x0, _, _ = config5_gpe(dev).make_logprob(include_priors=False)
    ll_fn = ess_mod.batched_loglik(loglik)
    mu, sigma = (torch.tensor(v, dtype=x0.dtype, device=dev) for v in (PRIOR_MU, PRIOR_SIGMA))
    with torch.no_grad():
        f = chain_starts(x0, chains, 2)
        ll = ess_mod._safe(ll_fn(f))
        for i in range(burn):
            f, ll, _ = ess_mod.ess_iteration(ll_fn, f, ll, mu, sigma, _seeded(dev, i))
    out = {}
    for R in rounds:
        for label, way in (("graph", lambda g: g), ("eager", eagerly)):
            blocks, props = [], []

            def call():
                g, lg = f, ll
                with torch.no_grad():
                    for i in range(iters):
                        stream = _Counting(_seeded(dev, 1000 + i))
                        g, lg, p = ess_mod.ess_iteration(ll_fn, g, lg, mu, sigma, stream, R)
                        blocks.append(stream.blocks)
                        props.append(p)
                return g

            call = way(call)
            _, n = launches(call)
            row = {"blocks": sum(blocks) / iters,
                   "mean_proposals": float(torch.stack(props).double().mean()),
                   "launches": n, "event_ms": time_ms(call, reps=10, warmup=2) / iters,
                   "host_ms": enqueue_ms(call, reps=5) / iters}
            busy, kernels, _ = device_profile(call, reps=1)
            row["busy_ms"] = busy / iters if kernels else None
            out[f"R{R}_{label}"] = row
            print(f"ESS iteration, {chains} chains, R = {R}, {label}: {row['event_ms']:.3f} ms "
                  f"events, {row['host_ms']:.3f} ms host, {row['busy_ms']} ms busy, "
                  f"{row['blocks']:.1f} blocks, {row['mean_proposals']:.3f} proposals, "
                  f"launches {n} for {iters}", flush=True)
    best = min(rounds, key=lambda R: out[f"R{R}_graph"]["event_ms"])
    out["shortest_R"] = best
    return out


def _seeded(dev, i) -> RandomStream:
    return RandomStream(torch.Generator(device=dev).manual_seed(7919 * (i + 1)))


class _Counting(RandomStream):
    """A stream that counts the shrink blocks it draws."""

    def __init__(self, stream):
        super().__init__(stream.generator)
        self.blocks = 0

    def ess_shrink_block(self, R, C, like):
        self.blocks += 1
        return super().ess_shrink_block(R, C, like)



def one_iteration(dev, name, call) -> dict:
    """One call of a sampler over one iteration: launches by kernel and by
    `gram_study.by_shape`, host enqueue, CUDA-event time and device-busy time
    (None where torch.profiler saw no kernel)."""
    call()
    torch.cuda.synchronize()
    for k in gram_op.LAUNCHES:
        gram_op.LAUNCHES[k] = 0
    gram_op.LAUNCH_SHAPES.clear()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    call()
    end.record()
    enqueue = 1e3 * (time.perf_counter() - t0)
    end.synchronize()
    out = {"launches": dict(gram_op.LAUNCHES),
           "launches_by_shape": by_shape(),
           "enqueue_ms": enqueue, "event_ms": start.elapsed_time(end)}
    busy, kernels, ops = device_profile(call, reps=1, top=8)
    out.update(busy_ms=busy if kernels else None, kernels=kernels, operators=ops)
    share = ("not measured (torch.profiler saw no kernel)" if not kernels
             else f"{busy:.2f} ms ({100 * busy / out['event_ms']:.1f}% of the CUDA-event time)")
    print(f"one iteration of {name}: launches {out['launches']} by shape "
          f"{out['launches_by_shape']}; host enqueue {enqueue:.2f} ms, CUDA events "
          f"{out['event_ms']:.2f} ms, device busy {share}", flush=True)
    for key, ms, calls in kernels:
        print(f"    {ms:9.4f} ms  {calls:5d} x {key[:90]}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chains", type=int, default=CHAINS)
    parser.add_argument("--hmc-warmup", type=int, default=HMC_WARMUP)
    parser.add_argument("--hmc-iters", type=int, default=HMC_ITERS)
    parser.add_argument("--split-warmup", type=int, default=SPLIT_WARMUP)
    parser.add_argument("--split-iters", type=int, default=SPLIT_ITERS)
    parser.add_argument("--ess-iters", type=int, default=ESS_ITERS)
    parser.add_argument("--samplers", default="hmc,split,ess",
                        help="comma-separated: hmc, split, ess (ess: its R sweep and its run, "
                             "graphed and eager)")
    args = parser.parse_args(argv)
    samplers = set(args.samplers.split(","))
    if not torch.cuda.is_available():
        print("student_t_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"package: {gp.__file__}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, world size 1 ('chains' axis of size 1)",
          flush=True)
    C = args.chains
    # profiles from the smallest to the largest: a profile that followed a
    # large one in the same process has seen no kernel
    print(f"card: {card_line()}", flush=True)
    iteration = {}
    if "ess" in samplers:
        iteration["ess"] = one_iteration(dev, "sharded_ess", _ess_call(dev, C, 1, 0))
        iteration["ess_eager"] = one_iteration(dev, "sharded_ess eager",
                                               eagerly(_ess_call(dev, C, 1, 0)))
    if "hmc" in samplers:
        iteration["hmc_eager"] = one_iteration(dev, "sharded_hmc eager",
                                               eagerly(_hmc_call(dev, C, 1, 0, 0)))
        iteration["hmc"] = one_iteration(dev, "sharded_hmc", _hmc_call(dev, C, 1, 0, 0))
    if "split" in samplers:
        iteration["split_eager"] = one_iteration(dev, "sharded_split_hmc eager",
                                                 eagerly(_split_call(dev, C, 1, 0, 0)))
        iteration["split"] = one_iteration(dev, "sharded_split_hmc",
                                           _split_call(dev, C, 1, 0, 0))
    result = {"chains": C, "iteration": iteration}
    R = ess_mod.SHRINK_BLOCK
    if "ess" in samplers:
        # the runs take the block size with the shortest iteration
        result["ess_rounds_sweep"] = ess_rounds_sweep(dev, C)
        R = result["ess_rounds_sweep"]["shortest_R"]
    runs = {"hmc": lambda: run_hmc(dev, C, args.hmc_iters, args.hmc_warmup),
            "split": lambda: run_split(dev, C, args.split_iters, args.split_warmup),
            "ess_sampler": lambda: run_ess(dev, C, args.ess_iters, rounds=R),
            "ess_sampler_eager": lambda: run_ess(dev, C, args.ess_iters, eager=True, rounds=R)}
    for name, run in runs.items():
        if name.split("_")[0] in samplers:
            result[name] = run()
            print(f"config #5 {name}, {C} chains: " + json.dumps(result[name]), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
