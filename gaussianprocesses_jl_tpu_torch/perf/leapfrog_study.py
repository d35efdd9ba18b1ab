"""The fused leapfrog kernel (`ops/leapfrog.py`, `csrc/leapfrog.cu`) on the
card: held against its plain version and the graphed transition, and
timed against both, at configuration #2's shape (128 chains, n = 200,
float32) and at a ragged one.

Run on a machine with one NVIDIA GPU:

    python -m gaussianprocesses_jl_tpu_torch.perf.leapfrog_study

It prints one JSON object: for each case, the largest differences of the
kernel's outputs from the plain version's (and at the configuration's
shape from the graphed `hmc_transition`'s), over the chains whose accept
decisions agree, how many decisions differ, and the kernel's launches;
then the times of one A transition of every chain (CUDA events, median):
the kernel's launch alone, the fused route's iteration (draws and
launch), the plain version, and the graphed route's iteration (one CUDA
graph replay), the bound, and the split sampler's outer iteration with
its A transitions by route and the kernel's launches. `chip_smoke.py`'s
phase 33 calls `compare`, `refused` and `times`.
"""
from __future__ import annotations

import json

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.inference import split
from gaussianprocesses_jl_tpu_torch.inference.hmc import as_stream, hmc_iteration, hmc_transition
from gaussianprocesses_jl_tpu_torch.models.gpa import fused_block_a
from gaussianprocesses_jl_tpu_torch.ops import leapfrog
from gaussianprocesses_jl_tpu_torch.perf import gpa_study
from gaussianprocesses_jl_tpu_torch.perf.gram_study import time_ms
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal
from gaussianprocesses_jl_tpu_torch.utils.profiling import card_line

__all__ = ["CASES", "LIMITS", "case", "compare", "beyond_limits", "refused", "times", "main"]

# (name, dtype, chains, n): configuration #2's shape, and a ragged one in both precisions
CASES = (("config_f32", torch.float32, gpa_study.CHAINS, gpa_study.N),
         ("ragged_f32", torch.float32, 7, 61), ("ragged_f64", torch.float64, 7, 61))
LMAX, EPS = gpa_study.LMAX, gpa_study.EPS_A
# the kernel's largest gaps from the plain version (and the graphed
# transition) over the chains whose accept decisions agree: float32 sums in
# other orders than the plain version's and carries them over 15 steps
# (read on an H100: 2.1e-7, 1.0e-7, 5.9e-7 and 3.0e-5, the accept
# probability's from a target of |t| ~ 100 rounded to ~1e-5)
LIMITS = {torch.float32: {"theta": 1e-4, "target": 1e-4, "gradient": 1e-3, "accept_prob": 1e-3},
          torch.float64: {"theta": 1e-9, "target": 1e-9, "gradient": 1e-9, "accept_prob": 1e-9}}


def _model(dev, dtype, n):
    if n == gpa_study.N:
        return gpa_study.config2_model(dev, np.float32 if dtype == torch.float32 else np.float64)
    rng = np.random.RandomState(61)
    X = rng.randn(n, gpa_study.D_FEAT)
    y = (np.sin(X[:, 0]) + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    m = gp.GPA(X.astype(np_dt), y.astype(np_dt), gp.MeanZero(),
               gp.Matern(1.5, np.zeros(gpa_study.D_FEAT), 0.0), gp.BernLik(), device=dev)
    m.set_priors(kern=[Normal(0.0, 2.0)] * (gpa_study.D_FEAT + 1))
    return m


def case(dev, dtype, chains, n, seed=18):
    """(block, aux, b, vg, inputs): a transition's inputs from chains 0.3
    apart around the model's state, their momenta, path lengths in
    gpa_study's LMIN..LMAX and accept uniforms from one generator."""
    m = _model(dev, dtype, n)
    pre, la, _, a0, b0 = m.make_split_logprob()
    g = torch.Generator(device=dev).manual_seed(seed)
    a = a0 + 0.3 * torch.randn((chains, a0.numel()), generator=g, dtype=dtype, device=dev)
    b = b0 + 0.3 * torch.randn((chains, b0.numel()), generator=g, dtype=dtype, device=dev)
    aux = split._cached(pre, b)
    vg = split.block_a(la)
    with torch.no_grad():
        t, gr = vg(a, aux, b)
    z, steps, u = as_stream(g, a).hmc(chains, n, gpa_study.LMIN, LMAX, a)
    eps = torch.full((chains,), EPS, dtype=dtype, device=dev)
    block = fused_block_a(m.params, m.x, m.y, m.covstrat)
    return block, aux, b, vg, (a, t, gr, z, steps, torch.log(u), eps)


def _gaps(got, ref) -> dict:
    """The largest difference of each output over the chains whose accept
    decisions agree (theta and gradient over max(1, the reference's
    largest) a chain, the target over max(1, |target|)), and how many
    decisions differ."""
    same = got[4] == ref[4]

    def rel(x, r, dims):
        x, r = x[same].double(), r[same].double()
        scale = r.abs().amax(dims).clamp_min(1.0) if dims else r.abs().clamp_min(1.0)
        return float(((x - r).abs().amax(dims) if dims else (x - r).abs()).div(scale).max())

    return {"theta": rel(got[0], ref[0], -1), "target": rel(got[1], ref[1], ()),
            "gradient": rel(got[2], ref[2], -1),
            "accept_prob": float((got[3][same] - ref[3][same]).abs().max()),
            "decisions_differ": int((~same).sum())}


def compare(dev, dtype, chains, n, graphed=False) -> dict:
    """The kernel against its plain version (and with `graphed`, against
    `hmc_transition` on the autograd target) from the same inputs; raises
    unless the kernel launched once and the card finished without a
    fault."""
    block, aux, b, vg, args = case(dev, dtype, chains, n)
    const = block.prior(b)
    with torch.no_grad():
        before = leapfrog.LAUNCHES["leapfrog"]
        got = leapfrog.transition(block, aux, const, *args, LMAX)
        torch.cuda.synchronize()
        launches = leapfrog.LAUNCHES["leapfrog"] - before
        plain = leapfrog.transition_plain(aux.L, aux.ok, block.mu, block.y, const, *args, LMAX)
        out = {"launches": launches, "plain": _gaps(got, plain)}
        if graphed:
            out["graphed"] = _gaps(got, hmc_transition(vg, *args, LMAX, rest=(aux, b)))
    if launches != 1:
        raise RuntimeError(f"leapfrog: {launches} launches for one transition")
    return out


def beyond_limits(res: dict, dtype, chains: int) -> list:
    """(reference, gaps) of `compare`'s result where a gap passes its limit
    in `LIMITS`, or more accept decisions differ than one in 64 chains in
    float32 (a test within rounding of its threshold) or any in float64."""
    most = chains // 64 if dtype == torch.float32 else 0
    return [(ref, res[ref]) for ref in ("plain", "graphed") if ref in res
            and (any(res[ref][k] > lim for k, lim in LIMITS[dtype].items())
                 or res[ref]["decisions_differ"] > most)]


def refused(dev) -> str:
    """The wrapper's error on a launch the card refuses: n = 240 in float32
    needs more shared memory than a block may have."""
    n, C = 240, 2
    vec, row, mat = (torch.zeros(C, device=dev), torch.zeros(n, device=dev),
                     torch.zeros((C, n), device=dev))
    try:
        leapfrog.launch(torch.zeros((C, n, n), device=dev),
                        torch.ones(C, dtype=torch.bool, device=dev), row, row, vec, mat, vec, mat,
                        mat, torch.ones(C, dtype=torch.int64, device=dev), vec, vec + 0.1, 3)
    except RuntimeError as e:
        return str(e)
    raise RuntimeError("leapfrog: a launch past the shared memory was not refused")


def times(dev) -> dict:
    """Milliseconds of one A transition of every chain at configuration
    #2's shape: the kernel (20 launches back to back, so the card and not
    the host sets the pace), the fused route's iteration (draws and
    launch), the plain version, and the graphed route's iteration; the
    bound (the factors' triangles read once at 3.35 TB/s, against the
    triangular products' flops at 67 TFLOP/s); and one outer iteration of
    the split sampler with its A transitions by route and the kernel's
    launches, each an outer iteration, counted from 0 over the timed
    iterations alone."""
    name, dtype, C, n = CASES[0]
    block, aux, b, vg, (a, t, gr, z, steps, log_u, eps) = case(dev, dtype, C, n)
    const = block.prior(b)
    g = torch.Generator(device=dev).manual_seed(5)
    stream = as_stream(g, a)
    args = tuple(x.contiguous() for x in (aux.L, aux.ok, block.mu, block.y, const, a, t, gr, z,
                                          steps, log_u, eps)) + (LMAX,)
    with torch.no_grad():
        out = {
            "kernel_ms": time_ms(lambda: [leapfrog.launch(*args) for _ in range(20)]) / 20,
            "fused_iteration_ms": time_ms(lambda: split._fused_iteration(
                block, aux, const, a, t, gr, stream, eps, gpa_study.LMIN, LMAX), reps=50),
            "plain_ms": time_ms(lambda: leapfrog.transition_plain(*args), reps=5, warmup=1),
            "graphed_iteration_ms": time_ms(lambda: hmc_iteration(
                vg, a, t, gr, stream, eps, gpa_study.LMIN, LMAX, rest=(aux, b)), reps=20),
        }
    tri = C * n * (n + 1) // 2 * torch.finfo(dtype).bits // 8
    flops = C * LMAX * 2 * n * (n + 1)
    out["bound_ms"] = max(tri / 3.35e12, flops / 67e12) * 1e3
    out["bound_by"] = "bytes" if tri / 3.35e12 >= flops / 67e12 else "flops"
    m = gpa_study.config2_model(dev)
    target = gpa_study.chain_starts(m, C, g)
    gpa_study.outer_iterations(target[:3], *target[3:], g, 1)  # captures the B graphs
    before = dict(split.ROUTES)
    leapfrog.LAUNCHES["leapfrog"] = 0
    reps, warmup = 5, 1
    out["outer_iteration_ms"] = time_ms(
        lambda: gpa_study.outer_iterations(target[:3], *target[3:], g, 1), reps=reps,
        warmup=warmup)
    out["a_transitions_by_route"] = {k: (split.ROUTES[k] - before[k]) / (reps + warmup)
                                     for k in before}
    out["launches_per_outer_iteration"] = leapfrog.LAUNCHES["leapfrog"] / (reps + warmup)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("leapfrog_study: no CUDA device")
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {name: compare(dev, dt, C, n, graphed=name == "config_f32")
           for name, dt, C, n in CASES}
    res["refused"] = refused(dev)
    res["beyond_limits"] = {name: beyond_limits(res[name], dt, C) for name, dt, C, _ in CASES}
    res["times"] = times(dev)
    res["card"] = card_line()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
