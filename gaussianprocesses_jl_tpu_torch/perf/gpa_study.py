"""GPA classification with batched split-HMC chains on the card: the
BASELINE's configuration #2 ("effective samples/sec/chip on GPA
classification"), as the JAX package's `bench.py::bench_gpa_ess` runs it.

Run on a machine with one NVIDIA GPU:

    python -m gaussianprocesses_jl_tpu_torch.perf.gpa_study

(`--f32-gap` runs anywhere: the f32 model's distance from the f64 model on
the CPU, from which chip_smoke's phase 13 takes its tolerances.)

The configuration: n = 200 points in d = 5 (`RandomState(7)`, labels from
sin(x0) + 0.5 x1 + 0.3 noise > 0), a Matern 3/2 ARD kernel with a probit
`BernLik`, Normal(0, 2) priors on the six kernel hyperparameters, f32. 128
chains start 0.01 apart around the model's state and run the factor-cached
split sampler (`a_iters=16`, `eps_a=0.06`, `eps_b=0.08`, L in 5..15) for 400
outer iterations, of which the first 100 are dropped (no step-size
adaptation, as in the JAX bench). One untimed outer iteration first builds
the kernels and warms the allocator.

It prints, and gives as one JSON object on its last line, each twice: with
the sampler's CUDA graphs (`utils/graphs.py`, the default) and eager
(inside `graphs.eager()`, every operator dispatched from Python), in one
process:
  * one outer iteration at 128 chains and at 1: its launches of each gram
    kernel, its host enqueue (the time for the call to return, the card
    not waited for), its CUDA-event time, and at 128 chains its device-busy
    time with the device time by kernel and by operator (torch.profiler);
  * the run: wall time, ESS min and median (multi-chain, FFT), ESS/s min
    and median, rank-normalized R-hat max and `valid` (R-hat < 1.01), the
    accept rates of both blocks, and whether its draws equal the other
    run's bit for bit.
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
from gaussianprocesses_jl_tpu_torch.inference.split import split_hmc
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.perf.gram_study import eagerly
from gaussianprocesses_jl_tpu_torch.utils.profiling import card_line, device_profile
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal

__all__ = ["config2_model", "chain_starts", "outer_iterations", "run", "one_iteration",
           "f32_gap", "main"]

N, D_FEAT, CHAINS = 200, 5, 128
N_ITER, WARMUP, A_ITERS, EPS_A, EPS_B = 400, 100, 16, 0.06, 0.08
LMIN, LMAX = 5, 15


def config2_model(device, dtype=np.float32):
    """The configuration's GPA, data and priors as `bench.py` makes them."""
    rng = np.random.RandomState(7)
    X = rng.randn(N, D_FEAT).astype(np.float32)
    f_true = np.sin(X[:, 0]) + 0.5 * X[:, 1]
    y = (f_true + 0.3 * rng.randn(N) > 0).astype(np.float32)
    m = gp.GPA(X.astype(dtype), y.astype(dtype), gp.MeanZero(),
               gp.Matern(1.5, np.zeros(D_FEAT), 0.0), gp.BernLik(), device=device)
    m.set_priors(kern=[Normal(0.0, 2.0)] * (D_FEAT + 1))
    return m


def chain_starts(m, chains, generator):
    """(precompute, logprob_a, logprob_b, a (C, Da), b (C, Db)): the split
    target and the chains' starts, 0.01 standard normals around the
    model's state."""
    precompute, lp_a, lp_b, a0, b0 = m.make_split_logprob()
    x0 = torch.cat([a0, b0])
    starts = x0 + 0.01 * torch.randn((chains, x0.numel()), generator=generator,
                                     dtype=x0.dtype, device=x0.device)
    na = a0.numel()
    return precompute, lp_a, lp_b, starts[:, :na], starts[:, na:]


def outer_iterations(target, a, b, generator, n_iter):
    """`n_iter` outer iterations of the split sampler from (a, b)."""
    precompute, lp_a, lp_b = target
    return split_hmc(precompute, lp_a, lp_b, a, b, generator, n_iter=n_iter, a_iters=A_ITERS,
                     eps_a=EPS_A, eps_b=EPS_B, Lmin=LMIN, Lmax=LMAX)


def run(device, n_iter=N_ITER, warmup=WARMUP, chains=CHAINS, eager=False,
        keep_draws=False) -> dict:
    """The timed run of `chains` chains and its diagnostics (with
    `keep_draws`, the draws too, under "samples"); `eager` runs it inside
    `graphs.eager()`."""
    sweep = eagerly(outer_iterations) if eager else outer_iterations
    m = config2_model(device)
    g = torch.Generator(device=device).manual_seed(11)
    *target, a, b = chain_starts(m, chains, g)
    sync = torch.cuda.synchronize if m.x.is_cuda else (lambda: None)
    # kernels built, graphs captured, allocator warm: from a generator of
    # its own, so the timed run's draws do not depend on `eager`
    sweep(target, a, b, torch.Generator(device=device).manual_seed(0), 1)
    sync()
    t0 = time.perf_counter()
    res = sweep(target, a, b, g, n_iter)
    sync()
    wall = time.perf_counter() - t0
    post = res.samples[:, warmup * A_ITERS:]
    ess = effective_sample_size(post).cpu().numpy()
    rhat = split_rhat(post).cpu().numpy()
    finite = bool(torch.isfinite(res.samples).all())
    out = {
        "n_obs": m.nobs, "dim_theta": int(post.shape[-1]), "sampler": "split",
        "chains": chains, "iters": n_iter, "iters_post_warmup": n_iter - warmup,
        "draws_per_iter": A_ITERS, "a_iters": A_ITERS, "eps_a": EPS_A, "eps_b": EPS_B,
        "wall_s": wall, "s_per_outer_iter": wall / n_iter,
        "accept_a": float(res.accept_rate_a.mean()), "accept_b": float(res.accept_rate_b.mean()),
        "ess_min": float(ess.min()), "ess_median": float(np.median(ess)),
        "ess_per_sec_min": float(ess.min()) / wall,
        "ess_per_sec_median": float(np.median(ess)) / wall,
        "rhat_max": float(np.nanmax(rhat)), "valid": bool(np.nanmax(rhat) < 1.01),
        "draws_finite": finite, "eager": eager,
    }
    print(f"config #2{' eager' if eager else ''}, {chains} chains, {n_iter} outer iterations "
          f"({warmup} dropped), "
          f"a_iters={A_ITERS}: wall {wall:.3f} s ({1e3 * wall / n_iter:.2f} ms an outer "
          f"iteration); ESS min {out['ess_min']:.1f}, median {out['ess_median']:.1f}; ESS/s "
          f"min {out['ess_per_sec_min']:.2f}, median {out['ess_per_sec_median']:.2f}; R-hat "
          f"max {out['rhat_max']:.4f} (valid {out['valid']}); accept a {out['accept_a']:.3f}, "
          f"b {out['accept_b']:.3f}; draws finite {finite}", flush=True)
    if keep_draws:
        out["samples"] = res.samples
    return out


def one_iteration(device, chains, profile=True, eager=False) -> dict:
    """One outer iteration of `chains` chains: gram launches, host enqueue,
    CUDA-event time, and (with `profile`) device-busy ms with the device
    time by kernel and by operator, each per iteration; `eager` runs it
    inside `graphs.eager()`."""
    m = config2_model(device)
    g = torch.Generator(device=device).manual_seed(5)
    *target, a, b = chain_starts(m, chains, g)
    call = lambda: outer_iterations(target, a, b, g, 1)  # noqa: E731
    call = eagerly(call) if eager else call
    call()
    torch.cuda.synchronize()
    for name in gram_op.LAUNCHES:
        gram_op.LAUNCHES[name] = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    call()
    end.record()
    enqueue = 1e3 * (time.perf_counter() - t0)
    end.synchronize()
    out = {"chains": chains, "eager": eager, "gram_launches": gram_op.LAUNCHES["gram"],
           "gram_vjp_launches": gram_op.LAUNCHES["gram_vjp"], "enqueue_ms": enqueue,
           "event_ms": start.elapsed_time(end)}
    line = (f"one outer iteration{' eager' if eager else ''}, {chains} chains: "
            f"{out['gram_launches']} gram and "
            f"{out['gram_vjp_launches']} gram_vjp launches; host enqueue {enqueue:.2f} ms, "
            f"CUDA events {out['event_ms']:.2f} ms")
    if profile:
        busy, kernels, ops = device_profile(call, reps=1, top=12)
        out.update(busy_ms=busy, kernels=kernels, operators=ops)
        line += (f"; device busy {busy:.2f} ms ({100 * busy / out['event_ms']:.1f}% of the "
                 f"CUDA-event time)")
    print(line, flush=True)
    if profile:
        for title in ("kernels", "operators"):
            print(f"  {title} by self device time per outer iteration:")
            for key, ms, calls in out[title]:
                print(f"    {ms:9.4f} ms  {calls:5d} x {key[:90]}")
    return out


def f32_gap(states=4) -> list:
    """On the CPU, at `states` chain-like states of the configuration (v
    standard normal, the kernel hyperparameters 0.5 standard normals,
    RandomState(k)): how far the f32 model's target and gradient lie from
    the f64 model's, (target relative difference, gradient difference /
    max|g|), with the f64 model at its own nugget (1e-6) and at the f32
    model's (1e-4). The first pair is the nugget's effect, the second f32
    rounding; chip_smoke's phase 13 derives its tolerances from them."""
    from ..models import gpa as gpa_mod

    rows = []
    for k in range(states):
        rng = np.random.RandomState(k)
        vec = np.concatenate([rng.randn(N), 0.5 * rng.randn(D_FEAT + 1)])
        t32, g32 = config2_model("cpu", dtype=np.float32).set_params(vec).target_and_dtarget()
        m64 = config2_model("cpu", dtype=np.float64).set_params(vec)
        row = []
        for nugget in (gpa_mod.GPA_NUGGET, gpa_mod.gpa_nugget(torch.float32)):
            saved, gpa_mod.GPA_NUGGET = gpa_mod.GPA_NUGGET, nugget
            try:
                t64, g64 = m64.target_and_dtarget()
            finally:
                gpa_mod.GPA_NUGGET = saved
            row += [abs(float(t32) - float(t64)) / abs(float(t64)),
                    float((g32.double() - g64).abs().max() / g64.abs().max())]
        rows.append(row)
        print(f"state {k}: f32 vs f64 at nugget 1e-6: target {row[0]:.2e} relative, gradient "
              f"{row[1]:.2e} max|g|; at nugget 1e-4: {row[2]:.2e}, {row[3]:.2e}", flush=True)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--f32-gap", action="store_true",
                        help="only the f32 model's distance from f64, on the CPU")
    args = parser.parse_args(argv)
    if args.f32_gap:
        f32_gap()
        return 0
    if not torch.cuda.is_available():
        print("gpa_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"package: {gp.__file__}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(f"card: {card_line()}", flush=True)
    result = {"iteration": {"chains": one_iteration(dev, CHAINS),
                            "one_chain": one_iteration(dev, 1, profile=False),
                            "chains_eager": one_iteration(dev, CHAINS, eager=True),
                            "one_chain_eager": one_iteration(dev, 1, profile=False, eager=True)},
              "run": run(dev, keep_draws=True), "run_eager": run(dev, eager=True, keep_draws=True)}
    same = torch.equal(result["run"].pop("samples"), result["run_eager"].pop("samples"))
    result["run"]["draws_equal_eager"] = same
    print(f"graphed and eager draws equal bit for bit: {same}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
