"""Drive the PyTorch port's main path on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
device and the CUDA toolkit (nvcc); it builds the port's kernels from the
sources in the checkout at first use.

Phases, each of which exits non-zero on the first failure:
  1. the card: name and power limit (nvidia-smi), TF32 settings (both off);
  2. build every kernel, and the single launch's parts measurement (all
     nvcc processes at once), with ptxas's report;
  3. the gram kernel and its VJP kernel against their plain versions on the
     card: every profile family, iso and ARD, symmetric and cross, f32 and
     f64, n = 300 and 3000, d = 10, the VJP with the hyperparameters' gradient
     alone and with the inputs' too, and run twice for identical bits; then
     both at a ragged n on grids of 1 and 7 blocks, where each block walks
     many tiles;
  4. the headline main path: GPE target and gradient, SE, n = 3000, d = 10,
     f32 on the card, against the same model in f64 on the CPU (plain path)
     and in f64 on the card;
  5. the flagship composite SE + RQ*Matern32 with MeanConst at n = 3000;
  6. a few L-BFGS-B steps (`optimize(maxiter=10)`) on the headline model;
  7. prediction at 500 new points (the cross-gram path);
  8. times (perf/gram_study.py): each gram kernel's own device time
     (torch.profiler) beside its time per call (CUDA events), its host
     enqueue, its bound and its plain version's time, torch.cdist beside the
     forward, at n = 3000 and 16384 (the VJP at 3000); the backward of one
     gram as autograd runs it, by model; the headline evaluation split into
     its parts; the host's enqueue time of one evaluation; then five
     headline evaluations under torch.profiler (device time by kernel and by
     operator, and the device-busy share);
  9. the Cholesky study's kernels (csrc/cholesky.cu) and its SE gram against
     their plain versions on the card: the launch probe exactly, the study
     gram within f32 rounding, the panel (one cooperative launch over the
     card) at B = 256, 512, 1024 and on an indefinite panel (NaN where the
     plain version has it, no hang), the single launch at n = 2048 with
     B = 128, 256 and 512 on grids of 1, 2, 7 and the most blocks (each
     counting its grid syncs), on an indefinite K (no hang), and against an
     f64 factorization;
 10. the study's path at full size: the study gram (n = 3072), the probe,
     `cholesky_blocked_panels` at n = 10240, block = 1024 (10 panel
     launches) and the single launch at n = 10240 (1 launch), both against
     f32 `torch.linalg.cholesky_ex`;
 11. the study's timings (perf/cholesky_study.py, whose experiments check
     every size they time: the study gram up to n = 16384, the panel at
     B = 3072 on the headline's SE gram against its plain version and f64,
     and the fit of its times to a per-step cost and a product rate), the
     plain versions'
     times, and the single launch at n = 10240 against its plain version,
     with its grid, the grid syncs it counted, the split of its time into
     correction, diagonal blocks and apply from its own time stamps, and
     the rate of its deep product beside `gemm_tile`'s
     (perf/single_parts.py);
 12. the batched gram and VJP kernels against the vmapped plain versions:
     C = 1, 3 and 128 chains, n = 200 and 1001, d = 5, every family iso
     (inputs shared) and ARD (inputs per chain), symmetric and cross, f32
     and f64, the VJP with dp alone and with dX, twice for identical bits
     (and at C = 1 the unbatched launch's bits), then grids of 1 and 7
     blocks;
 13. configuration #2's GPA target (perf/gpa_study.py: BernLik, Matern 3/2
     ARD, n = 200, d = 5) in f32 on the card against f64 on the CPU and on
     the card, vmapped over 128 chains against a loop, and predict_y;
 14. the split sampler at configuration #2's width (128 chains, 25 outer
     iterations; then 1 chain), exactly 17 gram and 16 gram_vjp launches
     an outer iteration; `mcmc(chains=8)` and `ess` on a GPE;
 15. examples/classification.py's model through the port: train accuracy
     >= 0.75;
 16. perf/gpa_study.py cut to 40 outer iterations: one outer iteration's
     launches, host enqueue, CUDA-event and device-busy time, ESS, R-hat;
 17. FITC at N = 10 000 (configuration #4's data, perf/fitc_study.py): mll
     and gradient in f32 on the card against f32 and f64 on the CPU and in
     f64 on the card, 2 + 2 launches, prediction;
 18. configuration #4 at full width (N = 100 000, m = 512, d = 4, f32): the
     gram kernels against their plain versions at the cross shape 512 x
     100 000, then 3 Adam steps of perf/fitc_study.py (2 + 2 launches a
     step, 1 + 1 of them at the cross shape; a finite and falling loss);
 19. FSA at N = 10 000 over 23 ragged blocks: the batched block grams (one
     launch, parameters shared) against their plain versions, mll and
     gradient (3 + 3 launches) and prediction with blockindpred against
     f64 on the card and on the CPU;
 20. configuration #3, Poisson VI at n = 4096 (perf/vi_study.py): the ELBO
     rises over 150 Adam steps (1 gram launch, no VJP), the rate follows
     the counts; every gram launch of the run, and the VJP at its shapes,
     against the plain versions; the negative ELBO (value and gradient)
     and the predictive, f64 on the card against f64 on the CPU and f32
     against f64 at f32's nugget;
 21. cross-validation on the headline: logp_LOO and dlogp_LOO (1 + 1
     launches), logp_CVfold and dlogp_CVfold over 10 equal folds, f32 and
     f64 on the card against f64 on the CPU;
 22. optimize(method="optax", maxiter=10) on the headline: finite, no lower
     than the start, 1 + 1 launches an evaluation; then optax's L-BFGS
     (`inference/lbfgs.py`) through its CUDA graphs against
     `graphs.eager()` on the headline (10 iterations) and configuration
     #2's GPA (5): the same iterates and line-search trial counts, 1 + 1
     launches an evaluation each way, ms an iteration by CUDA events, host
     and device busy, evaluations and host reads an iteration;
 23. the notebook anchors (the examples' `run`, thresholds in
     perf/anchors.py): robust regression, Poisson MCMC
     against VI, Mauna Loa by both optimizers, the sparse golden mlls and
     the regression quickstart, each anchor's gram launches then held
     against the plain versions at their inputs;
 24. configuration #5 at full width (perf/student_t_study.py: 1024 chains
     of the Student-t GPA, n = 60, D = 63, f32) through `make_mesh()`, world
     size 1: `sharded_hmc` (24 warmup iterations, mass updates at 12 and 18,
     then 8), `sharded_split_hmc` (4 + 4 outer) and `sharded_ess` (10), with
     their launches by kernel and shape; every gram and VJP launch of the
     three, at C = 1024, n = 60, replayed against the plain versions in
     f64; then 8 iterations with a checkpoint after 4, resumed from it, bit
     for bit the uninterrupted run's;
 25. the elastic GP (perf/elastic_study.py): 4096 points in d = 10 appended
     in blocks of 64 across three capacity crossings, f32 and f64, the
     maintained factor's mll, alpha and factor against a fresh f64 GPE on
     the CPU at each crossing and at the end; 2 gram launches an in-bucket
     append; ms an append beside a refit's;
 26. the adapters: `GPRegressor` on the headline's data (maxiter=10) equal
     to a GPE built and optimized the same way; score and
     log_marginal_likelihood finite;
 27. the distributed dense GPE (perf/parallel_study.py): the headline through
     `DistributedFullCovariance(make_mesh({'j': 1}))` at n = 3000 (B = 500)
     and 16384 (B = 512), f32, against `FullCovariance` f32 and f64 on the
     card (and at 3000 f64 on the CPU), 1 + 1 launches an evaluation at the
     n x n cross shape, its time beside `FullCovariance`'s; a non-PD K gives
     -inf in f32 and f64; `optimize(maxiter=5)` and `predict_y`;
 28. configuration #2's GPA target on `DistributedFullCovariance(B=40)`
     (5 tiles), vmapped over 128 chains (the latent map's custom VJP under
     vmap: 1 + 1 launches at the cross shape), against the vmapped
     `FullCovariance` target; 10 `sharded_hmc` iterations over
     `AmbientFullCovariance` on make_pod_mesh({'j': 1});
 29. configuration #4 as the JAX bench runs it: `fitc_mll_sharded_fn` on
     make_mesh({'data': 1}), Adam with the guard, 2 warm-up and 3 timed
     steps (2 + 2 launches a step, a finite and falling loss), the start's
     mll and gradient against `fitc_study`'s `LowRankPD` path;
 30. configuration #3 as its example runs it: `sharded_vi_train` at n = 4096
     on make_mesh({'data': 1}), 150 steps, its ELBO trace against the
     replicated Adam run step for step; `sharded_vi` with 8 restarts
     (restart 0 against `vi(method="adam")`); one gram launch each fit;
     `ring_gram` at n = 3000 (one launch, cross);
 31. the BASELINE kernel table's ten compositions (perf/bench_study.py:
     fix, Masked at d = 1 and 9, sums and products) at n = 3000, f32: value
     and gradient against f64 on the card within the headline's bar, and
     one launch of each gram kernel an evaluation for each stationary leaf.
 32. the CUDA graphs against eager (`graphs.eager()`), each pair from the
     same inputs and draws: the headline's value and gradient (1 + 1
     launches each way; events, enqueue and busy ms), one HMC iteration at
     configuration #5's 1024 chains (15 + 15 launches) and one split outer
     iteration at configuration #2's 128 chains (17 + 16), each equal bit
     for bit or within the f32 bars, no accept decision changed; then one
     `sharded_ess` and one `ess_iteration` at 1024 chains (the same
     proposals each way), one VI Adam step of configuration #3, one padded
     elastic append at n = 4032, `logp_LOO` + `dlogp_LOO` at n = 3000 and
     one FITC step at N = 100 000 (`phase_graph_pairs`: events, enqueue and
     busy ms each way, equal bits or within `GRAPH_BARS`); a dropped
     model's graph gives its memory back.
 33. the fused leapfrog of split HMC's block A (`csrc/leapfrog.cu`,
     `perf/leapfrog_study.py`): the kernel against its plain version at
     configuration #2's shape (C = 128, n = 200, f32; also against the
     graphed transition) and at a ragged one (C = 7, n = 61, f32 and f64),
     one launch each, the card synchronized; a refused launch raises; the
     kernel's, the plain version's and the graphed transition's times, and
     one split outer iteration: its 16 A transitions on the fused route, one
     kernel launch each (the launches counted from 0 over those iterations;
     the kernel table's `launches`).
 34. FITC's float32 QR (`models/sparse._CholQR3`, `perf/qr_study.py`): on
     configuration #4's stacked matrix (100 512 x 512) at the benchmark
     pool's first start, the mixed-precision shifted Cholesky QR's forward
     and VJP times beside `torch.linalg.qr`'s (`library_ms`), and each route's
     ||Q^T Q - I||_2, ||QR - A||_2 / ||A||_2 and R's gap against float64
     Householder; the route's each under 4 u32 and under the library's, and
     its factors succeeded; a 3-iteration `optimize(method='optax')` from
     that start, through its graphs, takes the float32 route once an
     evaluation (`QR_ROUTES` against `QR_SHAPES`). No cell runs it.
On the card the targets, the samplers, VI's steps, optax's L-BFGS,
cross-validation, the predictives and the elastic append run through
their CUDA graphs (`utils/graphs.py`) in every phase unless it asks for
eager: phases 4-8, 13-16, 20-22, 24-25 and 27-30 among them. Every gram and VJP launch of
phases 27-31 and of phase 32's new pairs is kept (`captured_launches`;
under a graph, its capture's warm-up) and replayed against the plain
versions in f64.
Phase 8 also times the batched kernels (C = 128, n = 200; configuration
#5's C = 1024, n = 60), configuration #4's cross gram (512 x 100 000,
perf/fitc_study.py), the elastic append's grams and the distributed
strategy's cross grams (n x n at 3000 and 16384; C = 128 at 200 x 200) for
the table.
The kernel launch counts are set to 0 before each main-path call and read
after it: one evaluation launches the forward and the VJP kernel once for
each stationary gram (once for every chain of a vmapped batch), prediction
only the forward. The last three lines are the kernel table (JSON), the card, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.examples import (classification, mauna_loa, poisson_regression,
                                                     regression, robust_regression)
from gaussianprocesses_jl_tpu_torch.inference import ess as ess_mod, hmc, lbfgs
from gaussianprocesses_jl_tpu_torch.inference.hmc import batched_value_and_grad
from gaussianprocesses_jl_tpu_torch.inference.vi import adam_init, adam_step, make_neg_elbo
from gaussianprocesses_jl_tpu_torch.ops import cholesky_kernels as chol_op
from gaussianprocesses_jl_tpu_torch.ops import cuda, gram as gram_op
from gaussianprocesses_jl_tpu_torch.ops.distance import sqdist
from gaussianprocesses_jl_tpu_torch.ops.linalg import (
    add_diag,
    tri_inv_lower,
    tri_syrk_lower,
)
from gaussianprocesses_jl_tpu_torch.perf import cholesky_study as study
from gaussianprocesses_jl_tpu_torch.parallel import chains
from gaussianprocesses_jl_tpu_torch.perf import (anchors, bench_study, elastic_study, fitc_study,
                                                 gpa_study, gram_study, lbfgs_study,
                                                 leapfrog_study, parallel_study, qr_study,
                                                 single_parts,
                                                 student_t_study, vi_study)
from gaussianprocesses_jl_tpu_torch.perf.gram_study import (
    F32_FLOPS,
    HBM_BYTES_PER_S,
    eagerly,
    enqueue_ms,
    gram_bound_ms,
    gram_vjp_bound_ms,
    launches,
    profile_ms,
    time_ms,
)
from gaussianprocesses_jl_tpu_torch.utils import graphs
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal
from gaussianprocesses_jl_tpu_torch.utils.profiling import card_line, device_profile

N_HEAD, D = 3000, 10


def fail(msg):
    raise RuntimeError(msg)


def stationary_kernels():
    """One instance of every class that routes through the gram op."""
    ll = np.array([0.3, -0.2, 0.1, 0.4, 0.0, -0.1, 0.2, 0.3, -0.3, 0.1])
    return [
        ("SEIso", gp.SE(0.3, 0.1)),
        ("SEArd", gp.SE(ll, 0.1)),
        ("Mat12Iso", gp.Matern(0.5, 0.4, -0.1)),
        ("Mat12Ard", gp.Matern(0.5, ll + 0.2, -0.1)),
        ("Mat32Iso", gp.Matern(1.5, 0.3, 0.2)),
        ("Mat32Ard", gp.Matern(1.5, ll, 0.2)),
        ("Mat52Iso", gp.Matern(2.5, 0.2, 0.0)),
        ("Mat52Ard", gp.Matern(2.5, ll, 0.0)),
        ("RQIso", gp.RQ(0.2, 0.1, -0.3)),
        ("RQArd", gp.RQ(ll, 0.1, -0.3)),
        ("Periodic", gp.Periodic(ll=0.1, lsigma=0.05, lp=0.5)),
    ]


def phase_kernel_vs_plain(dev) -> float:
    """Every family x {iso, ARD} x {sym, cross} x {f32, f64} x n in
    {300, 3000}. Tolerance: f32 atol 1e-5 sigma^2, f64 atol 1e-12 sigma^2
    (the plain version takes the expansion above its size budget, which
    rounds r2 to a few ulp of |x|^2). Returns the largest f32 error."""
    rng = np.random.RandomState(1)
    worst32 = 0.0
    for n in (300, N_HEAD):
        X1np = rng.randn(n, D)
        X2np = rng.randn(n // 2 + 7, D)  # ragged against the 64-wide tile
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            X1 = torch.as_tensor(X1np, dtype=dtype, device=dev)
            X2 = torch.as_tensor(X2np, dtype=dtype, device=dev)
            for name, kern in stationary_kernels():
                k = kern.to(dtype=dtype, device=dev)
                p = k._gram_params()
                sig2 = float(torch.exp(2 * k.lsigma))
                for sym in (True, False):
                    A = k._scale(X1)
                    B = None if sym else k._scale(X2)
                    K = gram_op.launch_gram(k._family, p, A, B)
                    K0 = gram_op.gram_plain(k._family, p, A, B)
                    torch.cuda.synchronize()
                    err = float((K - K0).abs().max())
                    ok = bool(torch.isfinite(K).all()) and err <= tol * sig2
                    print(f"  gram {name:9s} n={n:5d} {'sym  ' if sym else 'cross'} "
                          f"{str(dtype)[6:]}: max|K - plain| = {err:.3e} "
                          f"(atol {tol * sig2:.1e}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"gram kernel disagrees with its plain version: {name}")
                    d0 = k._r2profile(torch.zeros((), dtype=dtype, device=dev))
                    if sym and not bool((K.diagonal() == d0).all()):
                        fail(f"gram kernel diagonal is not exactly profile(0): {name}")
                    if dtype == torch.float32:
                        worst32 = max(worst32, err)
    return worst32


def vjp_scales(family, p, X1, X2, G):
    """Sums of magnitudes that bound the VJP's rounding: sum_ij |G_ij|
    |dK_ij/dp| for each hyperparameter; |x_i| sum_j |W_ij| + sum_j |W_ij|
    |x_j| for each input (W = 2 G dK/dr2, both sides on a symmetric gram)."""
    K, dll, dex, dr2 = gram_op.gram_derivs(family, p, sqdist(X1, X2))
    A = G.abs()
    dp = torch.stack([2 * (A * K.abs()).sum(), (A * dll.abs()).sum(), (A * dex.abs()).sum()])
    W = 2 * A * dr2.abs()
    if X2 is None:
        W, X2 = W + W.T, X1
    return (dp, X1.abs() * W.sum(1, keepdim=True) + W @ X2.abs(),
            X2.abs() * W.sum(0)[:, None] + W.T @ X1.abs())


def check_vjp(got, ref, scales, tol):
    """(max |got - ref|, max |got - ref| / (tol scale)) over the outputs asked
    for; the second must not pass 1. The bound has a floor of the output
    dtype's smallest normal number over tol: where the f64 reference's
    terms lie below f32's range (a sampler's chain far out in its kernel's
    length scale and variance, K ~ 1e-93), f32 products underflow and the
    result is right as 0."""
    err = ratio = 0.0
    for a, b, s in zip(got, ref, scales):
        if (a is None) != (b is None):
            fail("gram_vjp returned other outputs than its plain version")
        if a is not None:
            diff = (a - b).abs()
            err = max(err, float(diff.max()))
            bound = tol * s + torch.finfo(a.dtype).tiny / tol
            ratio = max(ratio, float((diff / bound).nan_to_num(0.0, posinf=math.inf).max()))
    return err, ratio


def phase_vjp_vs_plain(dev) -> tuple:
    """The VJP kernel against `gram_vjp_plain` over the same grid of cases
    as the forward, on a random cotangent that is not symmetric, with
    the hyperparameters' gradient alone and with the inputs' too.
    Tolerance: each output within tol of its sum of magnitudes
    (`vjp_scales`), tol = 1e-5 in f32 (two f32 sums of up to n^2 terms in
    different orders, and r2 from the plain version's expansion, a few ulp
    of |x|^2 off) and 1e-12 in f64. A second launch must give the same
    bits. Returns (largest f32 absolute difference, largest ratio)."""
    rng = np.random.RandomState(2)
    worst32 = worst = 0.0
    for n in (300, N_HEAD):
        X1np, X2np = rng.randn(n, D), rng.randn(n // 2 + 7, D)
        Gnp = {True: rng.randn(n, n), False: rng.randn(n, n // 2 + 7)}
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            X1 = torch.as_tensor(X1np, dtype=dtype, device=dev)
            X2 = torch.as_tensor(X2np, dtype=dtype, device=dev)
            for name, kern in stationary_kernels():
                k = kern.to(dtype=dtype, device=dev)
                p = k._gram_params()
                for sym in (True, False):
                    A, B = k._scale(X1), None if sym else k._scale(X2)
                    G = torch.as_tensor(Gnp[sym], dtype=dtype, device=dev)
                    scales = vjp_scales(k._family, p, A, B, G)
                    line = []
                    for needs in ((True, False, False), (True, True, not sym)):
                        got = gram_op.launch_gram_vjp(k._family, p, A, B, G, needs)
                        again = gram_op.launch_gram_vjp(k._family, p, A, B, G, needs)
                        ref = gram_op.gram_vjp_plain(k._family, p, A, B, G, needs)
                        torch.cuda.synchronize()
                        same = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
                        err, ratio = check_vjp(got, ref, scales, tol)
                        ok = same and ratio <= 1.0
                        line.append(f"{'dp' if not needs[1] else 'dp+dX'} {err:.3e} "
                                    f"({ratio:.3f} of tol, same bits {same}) "
                                    f"{'ok' if ok else 'FAIL'}")
                        if not ok:
                            fail(f"gram_vjp disagrees with its plain version or between runs: "
                                 f"{name} n={n} sym={sym} {dtype} {needs}")
                        worst = max(worst, ratio)
                        if dtype == torch.float32:
                            worst32 = max(worst32, err)
                    print(f"  gram_vjp {name:9s} n={n:5d} {'sym  ' if sym else 'cross'} "
                          f"{str(dtype)[6:]}: max|vjp - plain| " + "; ".join(line))
    return worst32, worst


def phase_walks(dev) -> None:
    """Both kernels at a ragged n = 1001 (16 tiles a side) on grids of 1 and
    7 blocks and on the full grid, so that each block walks many tiles:
    the forward within atol 1e-5 sigma^2 of its plain version, the VJP
    within 1e-5 of its sums of magnitudes, f32."""
    rng = np.random.RandomState(3)
    X1 = torch.as_tensor(rng.randn(1001, D), dtype=torch.float32, device=dev)
    X2 = torch.as_tensor(rng.randn(507, D), dtype=torch.float32, device=dev)
    for name, kern in (("SEIso", gp.SE(0.3, 0.1)), ("Periodic", gp.Periodic(ll=0.1, lsigma=0.05, lp=0.5)),
                       ("Mat32Ard", gp.Matern(1.5, np.linspace(-0.3, 0.3, D), 0.2))):
        k = kern.to(dtype=torch.float32, device=dev)
        p, sig2 = k._gram_params(), float(torch.exp(2 * k.lsigma))
        for sym in (True, False):
            A, B = k._scale(X1), None if sym else k._scale(X2)
            G = torch.as_tensor(rng.randn(1001, 1001 if sym else 507), dtype=torch.float32,
                                device=dev)
            K0 = gram_op.gram_plain(k._family, p, A, B)
            ref = gram_op.gram_vjp_plain(k._family, p, A, B, G)
            scales = vjp_scales(k._family, p, A, B, G)
            for grid in (1, 7, 0):
                K = gram_op.launch_gram(k._family, p, A, B, grid=grid)
                err = float((K - K0).abs().max())
                verr, ratio = check_vjp(gram_op.launch_gram_vjp(k._family, p, A, B, G, grid=grid),
                                        ref, scales, 1e-5)
                ok = err <= 1e-5 * sig2 and ratio <= 1.0
                print(f"  walk {name:8s} n=1001 {'sym  ' if sym else 'cross'} on "
                      f"{grid or 'all':>3} blocks: max|K - plain| {err:.3e}, max|vjp - plain| "
                      f"{verr:.3e} ({ratio:.3f} of tol) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"tile walk on {grid} blocks disagrees with the plain version: {name}")


D_GPA = 5  # the GPA classification configuration's features


def batched_kernels():
    """Every family iso and (but Periodic) ARD, at d = 5."""
    ll = np.array([0.3, -0.2, 0.1, 0.4, 0.0])
    return [
        ("SEIso", gp.SE(0.3, 0.1)), ("SEArd", gp.SE(ll, 0.1)),
        ("Mat12Iso", gp.Matern(0.5, 0.4, -0.1)), ("Mat12Ard", gp.Matern(0.5, ll + 0.2, -0.1)),
        ("Mat32Iso", gp.Matern(1.5, 0.3, 0.2)), ("Mat32Ard", gp.Matern(1.5, ll, 0.2)),
        ("Mat52Iso", gp.Matern(2.5, 0.2, 0.0)), ("Mat52Ard", gp.Matern(2.5, ll, 0.0)),
        ("RQIso", gp.RQ(0.2, 0.1, -0.3)), ("RQArd", gp.RQ(ll, 0.1, -0.3)),
        ("Periodic", gp.Periodic(ll=0.1, lsigma=0.05, lp=0.5)),
    ]


def chain_operands(kern, C, X, X2, rng, dtype, dev):
    """(p (C, 3), A, B) of C chains whose hyperparameters scatter 0.1 around
    kern's: A and B shared (n, d) for an iso kernel, per chain (C, n, d) for
    an ARD one, whose inputs scale by each chain's length scales; B None for
    the symmetric gram."""
    k0 = kern.to(dtype=dtype, device=dev)
    thetas = k0.flat_params() + 0.1 * torch.as_tensor(rng.randn(C, k0.n_params), dtype=dtype,
                                                      device=dev)
    ks = [k0.with_flat_params(t) for t in thetas]
    P = torch.stack([k._gram_params() for k in ks]).contiguous()
    if not k0._ard:
        return P, X, X2
    A = torch.stack([k._scale(X) for k in ks]).contiguous()
    B = None if X2 is None else torch.stack([k._scale(X2) for k in ks]).contiguous()
    return P, A, B


def batched_vjp_scales(family, P, A, B, G):
    """`vjp_scales` of each chain, (C, ...)."""
    dims = gram_op._dims(P, A, B, G)
    return torch.func.vmap(lambda p, a, b, g: vjp_scales(family, p, a, b, g), in_dims=dims)(
        P, A, B, G)


def phase_batched_vs_plain(dev) -> dict:
    """Phase 12: the batched kernels against the vmapped plain versions, C
    in {1, 3, 128} chains, n in {200, 1001}, d = 5, every family iso (X
    shared) and ARD (X per chain), symmetric and cross, f32 and f64. The
    tolerances of phase 3, chain by chain: the forward within atol 1e-5
    sigma_c^2 (f32) or 1e-12 sigma_c^2 (f64); the VJP, with dp alone and with
    dX, each output within tol times its sum of magnitudes, launched twice
    for identical bits. At C = 1 the batched launch gives the unbatched
    launch's bits. Then a case on grids of 1 and 7 blocks. Returns the
    largest f32 differences and the largest VJP ratio."""
    rng = np.random.RandomState(12)
    gen = torch.Generator(device=dev).manual_seed(12)  # cotangents, made on the card
    worst = {"gram": 0.0, "gram_vjp": 0.0, "vjp_ratio": 0.0}
    for n in (200, 1001):
        Xnp, X2np = rng.randn(n, D_GPA), rng.randn(n // 2 + 7, D_GPA)
        for C in (1, 3, 128):
            line = {}
            for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
                X = torch.as_tensor(Xnp, dtype=dtype, device=dev)
                X2 = torch.as_tensor(X2np, dtype=dtype, device=dev)
                for name, kern in batched_kernels():
                    for sym in (True, False):
                        P, A, B = chain_operands(kern, C, X, None if sym else X2, rng, dtype,
                                                 dev)
                        fam = kern._family
                        sig2 = torch.exp(2 * P[:, 0])
                        K = gram_op.launch_gram(fam, P, A, B)
                        K0 = gram_op.gram_plain(fam, P, A, B)
                        err_c = (K - K0).abs().flatten(1).max(1).values
                        ok = bool(torch.isfinite(K).all()) and bool((err_c <= tol * sig2).all())
                        if C == 1:
                            one = gram_op.launch_gram(fam, P[0], A[0] if A.ndim == 3 else A,
                                                      None if B is None else
                                                      (B[0] if B.ndim == 3 else B))
                            ok = ok and torch.equal(K[0], one)
                        if not ok:
                            fail(f"batched gram disagrees with its plain version: {name} n={n} "
                                 f"C={C} sym={sym} {dtype}: {float(err_c.max()):.3e}")
                        G = torch.randn((C, n, n if sym else X2.shape[0]), generator=gen,
                                        dtype=dtype, device=dev)
                        scales = batched_vjp_scales(fam, P, A, B, G)
                        for needs in ((True, False, False), (True, True, not sym)):
                            got = gram_op.launch_gram_vjp(fam, P, A, B, G, needs)
                            again = gram_op.launch_gram_vjp(fam, P, A, B, G, needs)
                            ref = gram_op.gram_vjp_plain(fam, P, A, B, G, needs)
                            same = all(torch.equal(a, b) for a, b in zip(got, again)
                                       if a is not None)
                            verr, ratio = check_vjp(got, ref, scales, tol)
                            if C == 1:
                                one = gram_op.launch_gram_vjp(
                                    fam, P[0], A[0] if A.ndim == 3 else A,
                                    None if B is None else (B[0] if B.ndim == 3 else B), G[0],
                                    needs)
                                same = same and all(torch.equal(a[0], b) for a, b in
                                                    zip(got, one) if a is not None)
                            if not (same and ratio <= 1.0):
                                fail(f"batched gram_vjp disagrees with its plain version or "
                                     f"between runs: {name} n={n} C={C} sym={sym} {dtype} "
                                     f"{needs}: ratio {ratio:.3f}, same bits {same}")
                            worst["vjp_ratio"] = max(worst["vjp_ratio"], ratio)
                            if dtype == torch.float32:
                                worst["gram_vjp"] = max(worst["gram_vjp"], verr)
                        if dtype == torch.float32:
                            worst["gram"] = max(worst["gram"], float(err_c.max()))
                        line[str(dtype)[6:]] = max(line.get(str(dtype)[6:], 0.0),
                                                   float((err_c / sig2).max()))
            print(f"  batched n={n:4d} C={C:3d}: 11 kernels x sym/cross x dp/dp+dX ok; largest "
                  f"forward error / sigma^2: f32 {line['float32']:.3e}, f64 "
                  f"{line['float64']:.3e}", flush=True)
    # the walk over (chain, tile) pairs on small grids, 3 chains at n = 1001
    X = torch.as_tensor(rng.randn(1001, D_GPA), dtype=torch.float32, device=dev)
    for name, kern in (("SEIso", gp.SE(0.3, 0.1)),
                       ("Mat32Ard", gp.Matern(1.5, np.linspace(-0.3, 0.3, D_GPA), 0.2))):
        P, A, _ = chain_operands(kern, 3, X, None, rng, torch.float32, dev)
        G = torch.randn((3, 1001, 1001), generator=gen, dtype=torch.float32, device=dev)
        K0 = gram_op.gram_plain(kern._family, P, A)
        ref = gram_op.gram_vjp_plain(kern._family, P, A, None, G)
        scales = batched_vjp_scales(kern._family, P, A, None, G)
        sig2 = torch.exp(2 * P[:, 0])[:, None, None]
        for grid in (1, 7):
            K = gram_op.launch_gram(kern._family, P, A, grid=grid)
            err = float(((K - K0).abs() / sig2).max())
            _, ratio = check_vjp(gram_op.launch_gram_vjp(kern._family, P, A, None, G, grid=grid),
                                 ref, scales, 1e-5)
            ok = err <= 1e-5 and ratio <= 1.0
            print(f"  batched walk {name} C=3 n=1001 on {grid} blocks: max|K - plain|/sigma^2 "
                  f"{err:.3e}, vjp {ratio:.3f} of tol {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"batched walk on {grid} blocks disagrees with the plain version: {name}")
    return worst


def phase_gpa_target(dev) -> tuple:
    """Phase 13: configuration #2's GPA target (BernLik, Matern 3/2 ARD,
    n = 200, d = 5, `perf/gpa_study.py`) at a chain's state (v standard
    normal, the six kernel hyperparameters 0.5 standard normals):
      * f32 on the card against f64 on the CPU: target rtol 1e-4, gradient
        atol 2e-3 max|g|. The f32 model's nugget is 1e-4, the f64 model's
        1e-6 (`gpa_nugget`); on the CPU, over four such states
        (`perf/gpa_study.py --f32-gap`), that alone
        moves the target by up to 2.9e-5 relative and the gradient by up to
        2.9e-4 max|g|, where f32 rounding at one nugget moves them by 4e-8
        and 7e-7. f64 on the card against it: target rtol 1e-9, gradient
        rtol 1e-8 with atol 1e-10 max|g|;
      * the vmapped value and gradient over 128 chains (one launch of each
        gram kernel) against a loop over 4 of them, f32: target rtol 1e-5,
        gradient atol 1e-4 max|g| (batched against single factorizations);
      * predict_y at 500 new points: finite, probabilities in [0, 1].
    Returns the launches of the three main-path calls, summed."""
    rng = np.random.RandomState(13)
    vec = np.concatenate([rng.randn(gpa_study.N), 0.5 * rng.randn(gpa_study.D_FEAT + 1)])

    def make(dtype, device):
        return gpa_study.config2_model(device, dtype=dtype).set_params(vec)

    m32 = make(np.float32, dev)
    (t, g), n_eval = launches(m32.target_and_dtarget)
    print(f"GPA target f32 card {float(t):.6f}: {n_eval[0]} gram and {n_eval[1]} gram_vjp "
          f"launches")
    if n_eval != (1, 1) or not (bool(torch.isfinite(t)) and bool(torch.isfinite(g).all())):
        fail("GPA target: non-finite, or not one launch of each gram kernel")
    t_ref, g_ref = make(np.float64, "cpu").target_and_dtarget()
    t64, g64 = make(np.float64, dev).target_and_dtarget()
    gmax = float(g_ref.abs().max())
    check_close("GPA f32 target vs f64 CPU", t.cpu(), t_ref, 1e-4)
    check_close("GPA f32 gradient vs f64 CPU", g.cpu(), g_ref, 0.0, 2e-3 * gmax)
    check_close("GPA f64 card target vs f64 CPU", t64.cpu(), t_ref, 1e-9)
    check_close("GPA f64 card gradient vs f64 CPU", g64.cpu(), g_ref, 1e-8, 1e-10 * gmax)

    logprob, x0, _, _ = m32.make_logprob()
    gen = torch.Generator(device=dev).manual_seed(13)
    states = x0 + 0.3 * torch.randn((gpa_study.CHAINS, x0.numel()), generator=gen,
                                    dtype=x0.dtype, device=dev)
    (tb, gb), n_batch = launches(lambda: batched_value_and_grad(logprob)(states))
    print(f"GPA target vmapped over {gpa_study.CHAINS} chains: {n_batch[0]} gram and "
          f"{n_batch[1]} gram_vjp launches")
    if n_batch != (1, 1):
        fail("vmapped GPA target: not one launch of each gram kernel for every chain")
    for c in range(4):
        gc, tc = torch.func.grad_and_value(logprob)(states[c])
        check_close(f"vmapped target, chain {c}, vs its own call", tb[c].cpu(), tc.cpu(), 1e-5)
        check_close(f"vmapped gradient, chain {c}, vs its own call", gb[c].cpu(), gc.cpu(), 0.0,
                    1e-4 * float(gc.abs().max()))

    Xs = np.random.RandomState(7).randn(500, gpa_study.D_FEAT).astype(np.float32)
    (prob, var), n_pred = launches(lambda: m32.predict_y(Xs))
    print(f"GPA predict_y at 500 points: {n_pred[0]} gram and {n_pred[1]} gram_vjp launches, "
          f"probabilities in [{float(prob.min()):.4f}, {float(prob.max()):.4f}]")
    if not (bool(torch.isfinite(prob).all()) and bool(torch.isfinite(var).all())
            and bool(((prob >= 0) & (prob <= 1)).all()) and n_pred[1] == 0):
        fail("GPA predict_y: non-finite, outside [0, 1], or a VJP launch")
    return tuple(a + b + c for a, b, c in zip(n_eval, n_batch, n_pred))


N_SAMPLER_ITERS = 25  # phase 14's outer iterations at 128 chains


def phase_samplers(dev) -> dict:
    """Phase 14: the samplers at configuration #2's full width. The split
    sampler (`a_iters=16`, `eps_a=0.06`, `eps_b=0.08`, L in 5..15, no
    adaptation) for N_SAMPLER_ITERS outer iterations over 128 chains, then 2
    over one chain: every draw finite, both mean accept rates (128 chains)
    in (0.2, 1], and exactly 17 gram and 16 gram_vjp launches an outer
    iteration at either chain count (1 for the cached factor, 1 + Lmax for
    the kernel block's update). Then 5 iterations of `mcmc(sampler="joint",
    chains=8)` (1 + 5 Lmax launches of each) and `ess` on a GPE with Normal
    priors (n = 200, d = 5, chains=8, forward launches only). Returns
    {"split": ..., "joint": ..., "ess": ...}, each with its launches."""
    gen = torch.Generator(device=dev).manual_seed(14)
    m = gpa_study.config2_model(dev)
    out = {}
    for C, iters in ((gpa_study.CHAINS, N_SAMPLER_ITERS), (1, 2)):
        *target, a, b = gpa_study.chain_starts(m, C, gen)
        t0 = time.perf_counter()
        res, n = launches(lambda: gpa_study.outer_iterations(target, a, b, gen, iters))
        secs = time.perf_counter() - t0
        acc = (float(res.accept_rate_a.mean()), float(res.accept_rate_b.mean()))
        finite = bool(torch.isfinite(res.samples).all())
        print(f"split sampler, {C} chains, {iters} outer iterations: {secs:.3f} s "
              f"({1e3 * secs / iters:.1f} ms an iteration), {n[0]} gram and {n[1]} gram_vjp "
              f"launches, accept a {acc[0]:.3f}, b {acc[1]:.3f}, draws "
              f"{tuple(res.samples.shape)} finite {finite}", flush=True)
        if n != (17 * iters, 16 * iters):
            fail(f"split sampler at {C} chains: {n} launches, expected "
                 f"{(17 * iters, 16 * iters)}")
        if not finite or (C > 1 and not all(0.2 < r <= 1.0 for r in acc)):
            fail(f"split sampler at {C} chains: non-finite draws or accept rates {acc}")
        out["split" if C > 1 else "split_one_chain"] = {
            "chains": C, "iters": iters, "s": secs, "launches": n, "accept": acc}

    mj = gpa_study.config2_model(dev)
    t0 = time.perf_counter()
    res, n = launches(lambda: gp.mcmc(mj, gen, n_iter=5, chains=8, eps=0.05, verbose=False))
    secs = time.perf_counter() - t0
    print(f"joint HMC, 8 chains, 5 iterations: {secs:.3f} s, {n[0]} gram and {n[1]} gram_vjp "
          f"launches, accept {res.accept_rate.mean().item():.3f}", flush=True)
    if n != (1 + 5 * 15, 1 + 5 * 15) or res.samples.shape != (8, 5, mj.num_params()) or \
            not bool(torch.isfinite(res.samples).all()):
        fail("joint HMC: wrong launches, shape or non-finite draws")
    out["joint"] = {"chains": 8, "iters": 5, "s": secs, "launches": n}

    rng = np.random.RandomState(15)
    Xg = rng.randn(gpa_study.N, gpa_study.D_FEAT)
    yg = np.sin(Xg[:, 0]) + 0.1 * rng.randn(gpa_study.N)
    mg = gp.GPE(Xg.astype(np.float32), yg.astype(np.float32), gp.MeanZero(), gp.SE(0.0, 0.0),
                lognoise=-1.0, device=dev)
    mg.set_priors(noise=[Normal(-1.0, 1.0)], kern=[Normal(0.0, 1.0)] * 2)
    t0 = time.perf_counter()
    res, n = launches(lambda: gp.ess(mg, gen, n_iter=20, chains=8, verbose=False))
    secs = time.perf_counter() - t0
    props = float(res.mean_proposals.mean())
    print(f"ess on a GPE, 8 chains, 20 iterations: {secs:.3f} s, {n[0]} gram and {n[1]} "
          f"gram_vjp launches, {props:.2f} proposals an iteration", flush=True)
    if n[0] < 21 or n[1] != 0 or res.samples.shape != (8, 20, 3) or \
            not bool(torch.isfinite(res.samples).all()):
        fail("ess: wrong launches, shape or non-finite draws")
    out["ess"] = {"chains": 8, "iters": 20, "s": secs, "launches": n}
    return out


# examples/classification.py runs 250 outer iterations (its n_iter // 4);
# cut to 100 to keep the script inside its time (PERF.md §4)
N_CLASS_ITERS = 100


def phase_classification(dev) -> dict:
    """Phase 15: examples/classification.py's model and data through the
    port's example (`examples/classification.py` in the port, its `run`) on
    the card (n = 80, d = 5, Matern 3/2 ARD, BernLik, Normal(0, 2) priors,
    f32): one chain of the split sampler, `a_iters=8`, `eps_a=eps_b=0.06`,
    N_CLASS_ITERS outer iterations; the model takes the final state, and
    its train accuracy must reach 0.75, the anchor of
    tests/test_notebook_parity.py. The launches are the sampler's and the
    accuracy's prediction."""
    t0 = time.perf_counter()
    res, n_launch = launches(lambda: classification.run(dev, np.float32, 4 * N_CLASS_ITERS,
                                                        verbose=False))
    secs = time.perf_counter() - t0
    acc = res["accuracy"]
    print(f"classification anchor: {N_CLASS_ITERS} outer iterations in {secs:.3f} s, "
          f"{n_launch[0]} gram and {n_launch[1]} gram_vjp launches, accept "
          f"{res['accept']}, train accuracy {acc:.3f} (anchor 0.75)", flush=True)
    if not acc >= 0.75:
        fail(f"classification anchor: train accuracy {acc:.3f} < 0.75")
    return {"s": secs, "accuracy": acc, "launches": n_launch}


# phase 16: gpa_study's run, cut from the JAX bench's 400 outer iterations
# (100 dropped) to keep the script inside its time; the full run is
# `python -m gaussianprocesses_jl_tpu_torch.perf.gpa_study` alone (PERF.md)
N_STUDY_ITERS = 40


def phase_gpa_study(dev) -> dict:
    """Phase 16: perf/gpa_study.py at configuration #2: one outer iteration
    at 128 chains (launches, host enqueue, CUDA-event and device-busy time,
    device time by kernel and operator) and at 1 (launches, enqueue), then
    the timed run of N_STUDY_ITERS outer iterations (a quarter dropped, as
    the JAX bench drops 100 of 400) with ESS and R-hat. The launch counts
    must be 17 and 16 again, and every draw finite."""
    it = {"chains": gpa_study.one_iteration(dev, gpa_study.CHAINS),
          "one_chain": gpa_study.one_iteration(dev, 1, profile=False)}
    for row in it.values():
        if (row["gram_launches"], row["gram_vjp_launches"]) != (17, 16):
            fail(f"gpa_study: {row['chains']} chains launched {row['gram_launches']} gram and "
                 f"{row['gram_vjp_launches']} gram_vjp kernels an outer iteration")
    run = gpa_study.run(dev, n_iter=N_STUDY_ITERS, warmup=N_STUDY_ITERS // 4)
    if not run["draws_finite"]:
        fail("gpa_study: non-finite draws")
    return {"iteration": it, "run": run}


def phase_vjp_times(dev) -> dict:
    """The VJP kernel at n = 3000, d = 10, f32, on a random cotangent: the
    headline's SE (hyperparameters alone) and an ARD SE (the inputs' gradient
    too): own device time of its two kernels (torch.profiler), time per call
    (CUDA events), host enqueue, bound, and the plain version's time."""
    X = torch.as_tensor(np.random.RandomState(4).randn(N_HEAD, D), dtype=torch.float32,
                        device=dev)
    G = torch.as_tensor(np.random.RandomState(5).randn(N_HEAD, N_HEAD), dtype=torch.float32,
                        device=dev)
    rows = {}
    for label, kern, needs in (("SE dp", gp.SE(0.0, 0.0), (True, False, False)),
                               ("SE ARD dp+dX", gp.SE(np.linspace(-0.2, 0.3, D), 0.1),
                                (True, True, False))):
        k = kern.to(dtype=torch.float32, device=dev)
        p, A = k._gram_params(), k._scale(X)
        call = lambda: gram_op.launch_gram_vjp(k._family, p, A, None, G, needs)  # noqa: E731
        own, n_kernels, by_kernel = profile_ms(call, match="gram_vjp")
        # the VJP kernel and its reduction, by the kernel's name
        split = {("reduce" if "reduce" in key else "vjp"): ms for key, ms in by_kernel.items()}
        b_ms, b_by = gram_vjp_bound_ms(N_HEAD, N_HEAD, D, 4, True, needs[1])
        rows[label] = row = {
            "own_ms": own, "own_ms_by_kernel": split, "kernels_per_call": n_kernels,
            "call_ms": time_ms(call),
            "enqueue_ms": enqueue_ms(call), "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": time_ms(lambda: gram_op.gram_vjp_plain(k._family, p, A, None, G, needs))}
        print(f"  gram_vjp {label} f32 n={N_HEAD}: own {own:.4f} ms in {n_kernels:.0f} kernels "
              f"(vjp {split.get('vjp', 0.0):.4f} ms, reduce {split.get('reduce', 0.0):.4f} ms) "
              f"({100 * b_ms / own:.1f}% of the {b_by} bound {b_ms:.4f} ms), call "
              f"{row['call_ms']:.4f} ms, enqueue {row['enqueue_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms")
    return rows


def check_close(what, got, ref, rtol, atol=0.0):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    err = float(np.max(np.abs(got - ref) - rtol * np.abs(ref)))
    ok = bool(np.all(np.isfinite(got))) and err <= atol
    print(f"  {what}: max(|got - ref| - rtol|ref|) = {err:.3e} "
          f"(rtol {rtol:g}, atol {atol:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what} disagrees with its reference")


def phase_model(name, make, expect_launches):
    """Target and gradient in f32 on the card against f64 on the CPU (the
    plain path) and f64 on the card (the kernel). f32 tolerances: target
    rtol 1e-3; gradient atol 2e-2 max|g| (f32 Cholesky of an n = 3000 gram
    at noise variance e^-2 keeps ~3 digits). f64 card: target rtol 1e-9,
    gradient rtol 1e-8 with atol 1e-10 max|g|."""
    m32 = make(np.float32, None)
    (t, g), n_launch = launches(m32.target_and_dtarget)
    print(f"{name}: f32 card target {float(t):.6f}, {n_launch[0]} gram and {n_launch[1]} "
          f"gram_vjp launches")
    if n_launch != (expect_launches, expect_launches):
        fail(f"{name}: expected {expect_launches} gram and gram_vjp launches, got {n_launch}")
    if not (bool(torch.isfinite(t)) and bool(torch.isfinite(g).all())):
        fail(f"{name}: non-finite target or gradient")
    t_ref, g_ref = make(np.float64, "cpu").target_and_dtarget()
    t64, g64 = make(np.float64, None).target_and_dtarget()
    gmax = float(g_ref.abs().max())
    check_close(f"{name} f32 target vs f64 CPU", t.cpu(), t_ref, 1e-3)
    check_close(f"{name} f32 gradient vs f64 CPU", g.cpu(), g_ref, 0.0, 2e-2 * gmax)
    check_close(f"{name} f64 card target vs f64 CPU", t64.cpu(), t_ref, 1e-9)
    check_close(f"{name} f64 card gradient vs f64 CPU", g64.cpu(), g_ref, 1e-8,
                1e-10 * gmax)
    return m32, n_launch


N_STUDY, STUDY_BLOCK = 10240, 1024  # the study's full factorization
N_STUDY_GRAM = 3072


def reset_launches() -> None:
    for name in gram_op.LAUNCHES:
        gram_op.LAUNCHES[name] = 0
    for name in chol_op.LAUNCHES:
        chol_op.LAUNCHES[name] = 0


def max_rel(got, ref) -> float:
    """max|got - ref| / max|ref|, in f64 (NaN if either holds a NaN)."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


def check_rel(what, got, ref, tol) -> float:
    """Fails unless max|got - ref| <= tol max|ref|; returns max|got - ref|."""
    err = max_rel(got, ref)
    ok = err <= tol  # False on NaN
    print(f"  {what}: max|got - ref| / max|ref| = {err:.3e} (tol {tol:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what} disagrees with its reference")
    return float((got.double() - ref.double()).abs().max())


def phase_study_vs_plain(dev) -> dict:
    """Each study kernel against its plain version on the same card inputs;
    returns {kernel: largest absolute difference}. Tolerances: the probe is
    exact (the same f32 add); the study gram atol 1e-5 e^p0 (the plain
    version takes the clamped expansion at these n, which rounds r2 to a few
    ulp of |x|^2); the panel and the single launch 1e-5 of max|ref| (two
    summation orders of a well-conditioned f32 factorization, each within
    ~1e-6 of f64), and the single launch within the study's 1e-4 of f64."""
    g = torch.Generator(device=dev).manual_seed(5)
    errs = {}
    A = torch.randn((512, 512), generator=g, dtype=torch.float32, device=dev)
    for n_iter in (512, 4096):
        o = chol_op.launch_probe(A, n_iter)
        ok = bool(torch.equal(o, chol_op.launch_probe_plain(A, n_iter)))
        print(f"  launch probe n_iter={n_iter}: equal to A[:8, :128] + n_iter: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("launch probe disagrees with its plain version")
    errs["launch_probe"] = 0.0

    params = study.study_params(dev)
    p = torch.tensor([study.STUDY_LSIG, study.STUDY_LL, 0.0], device=dev)
    errs["se_gram_study"] = 0.0
    for n in (1024, N_STUDY_GRAM):
        X = torch.randn((n, D), generator=g, dtype=torch.float32, device=dev)
        K = study.se_gram_study(X, params)
        err = float((K - gram_op.gram_plain(gram_op.SE, p, X)).abs().max())
        tol = study.GRAM_ATOL * math.exp(2 * study.STUDY_LSIG)
        diag_ok = bool((K.diagonal() == torch.exp(params[0])).all())
        ok = err <= tol and diag_ok
        print(f"  study SE gram n={n}: max|K - plain| = {err:.3e} (atol {tol:.1e}), "
              f"diagonal exactly e^p0: {diag_ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("study SE gram disagrees with its plain version")
        errs["se_gram_study"] = max(errs["se_gram_study"], err)

    errs["chol_inv_panel"] = 0.0
    for B in (256, 512, 1024):
        Ap = study.spd_test_matrix(B, 64, dev, seed=B)
        L, Linv = chol_op.chol_inv_panel(Ap)
        L0, Linv0 = chol_op.chol_inv_panel_plain(Ap)
        upper_ok = bool((torch.triu(L, 1) == 0).all() and (torch.triu(Linv, 1) == 0).all())
        if not upper_ok:
            fail(f"chol_inv_panel B={B}: nonzero above the diagonal")
        for what, got, ref in (("L", L, L0), ("L^-1", Linv, Linv0)):
            err = check_rel(f"panel B={B} {what} vs plain", got, ref, study.PANEL_RTOL)
            errs["chol_inv_panel"] = max(errs["chol_inv_panel"], err)
    # the schedule holds on any grid: one block, a few, the largest; and at
    # one tile (no grid sync but the kernel's end)
    Ap = study.spd_test_matrix(512, 64, dev, seed=512)
    L0, Linv0 = chol_op.chol_inv_panel_plain(Ap)
    for grid in (1, 2, 7, chol_op.max_grid_blocks("panel")):
        syncs = torch.zeros(1, dtype=torch.int32, device=dev)
        L, Linv = chol_op.chol_inv_panel_on_grid(Ap, grid, syncs)
        for what, got, ref in (("L", L, L0), ("L^-1", Linv, Linv0)):
            check_rel(f"panel B=512 on {grid} blocks {what} vs plain", got, ref, study.PANEL_RTOL)
        if int(syncs.item()) != chol_op.panel_grid_syncs(512):
            fail(f"panel B=512 on {grid} blocks: {int(syncs.item())} grid syncs counted, "
                 f"the schedule has {chol_op.panel_grid_syncs(512)}")
    A1 = study.spd_test_matrix(64, 64, dev, seed=1)
    for what, got, ref in zip(("L", "L^-1"), chol_op.chol_inv_panel(A1, T=64),
                              chol_op.chol_inv_panel_plain(A1, T=64)):
        check_rel(f"panel B=64 {what} vs plain", got, ref, study.PANEL_RTOL)
    phase_indefinite_panel(dev)

    Ks = study.spd_test_matrix(2048, 64, dev, seed=7)
    Ks_before = Ks.clone()
    L = chol_op.single_launch_cholesky(Ks, B=256, R=1024)
    if not torch.equal(Ks, Ks_before):
        fail("single_launch_cholesky changed its input")
    check_rel("single launch n=2048 vs f64 cholesky_ex", L,
              torch.linalg.cholesky_ex(Ks.double())[0], 1e-4)
    # every panel width on any grid: one block, a few, the largest; the grid
    # syncs the kernel counted against the schedule's
    errs["single_launch_cholesky"] = 0.0
    for B in (128, 256, 512):
        L0 = chol_op.single_launch_cholesky_plain(Ks, B=B, R=1024)
        for grid in (1, 2, 7, chol_op.max_grid_blocks("single_launch")):
            syncs = torch.zeros(1, dtype=torch.int32, device=dev)
            L = chol_op.single_launch_cholesky_on_grid(Ks, grid, syncs, B=B)
            if not bool((torch.triu(L, 1) == 0).all()):
                fail(f"single launch B={B} on {grid} blocks: nonzero above the diagonal")
            err = check_rel(f"single launch n=2048 B={B} on {grid} blocks vs plain", L, L0, 1e-5)
            errs["single_launch_cholesky"] = max(errs["single_launch_cholesky"], err)
            if int(syncs.item()) != chol_op.single_launch_grid_syncs(2048, B):
                fail(f"single launch B={B} on {grid} blocks: {int(syncs.item())} grid syncs "
                     f"counted, the schedule has {chol_op.single_launch_grid_syncs(2048, B)}")
    phase_indefinite_single(dev)
    return errs


def phase_indefinite_single(dev) -> None:
    """The single launch on an indefinite K (pivot 1000 of 2048 at -1e4):
    the launch returns, NaN from that pivot on where the plain version has
    it, and the leading 1000 x 1000 finite and within 1e-5 of max|.| of
    the plain version's."""
    K = study.spd_test_matrix(2048, 64, dev, seed=7)
    K[1000, 1000] = -1e4
    L = chol_op.single_launch_cholesky(K)
    torch.cuda.synchronize()  # returns: no block waits at a grid sync
    L0 = chol_op.single_launch_cholesky_plain(K)
    same_nan = bool(torch.equal(torch.tril(L).isnan(), torch.tril(L0).isnan()))
    print(f"  indefinite single launch: {int(L.isnan().sum())} NaN, NaN where the plain version "
          f"has it: {same_nan}, L[1000, 1000] NaN: {bool(L[1000, 1000].isnan())}")
    if not (same_nan and bool(L[1000, 1000].isnan())):
        fail("indefinite single launch: NaN pattern differs from the plain version's")
    check_rel("indefinite single launch L[:1000, :1000] vs plain", L[:1000, :1000],
              L0[:1000, :1000], 1e-5)


def phase_indefinite_panel(dev) -> None:
    """The panel kernel on an indefinite panel (pivot 200 of 256 negative):
    the launch returns, NaN stands where the plain version has it on and
    below the diagonal, and the leading 128 x 128, before the bad pivot, is
    finite and within 1e-5 of max|.| of the plain version's."""
    g = torch.Generator(device=dev).manual_seed(5)
    W = torch.randn((256, 64), generator=g, dtype=torch.float32, device=dev)
    A = W @ W.T + 256 * torch.eye(256, dtype=torch.float32, device=dev)
    A[200, 200] = -1e4
    L, Linv = chol_op.chol_inv_panel(A)
    torch.cuda.synchronize()  # returns: no block waits at a grid sync
    for what, got, ref in zip(("L", "L^-1"), (L, Linv), chol_op.chol_inv_panel_plain(A)):
        same_nan = bool(torch.equal(torch.tril(got).isnan(), torch.tril(ref).isnan()))
        print(f"  indefinite panel {what}: {int(got.isnan().sum())} NaN, NaN where the plain "
              f"version has it: {same_nan}")
        if not (bool(got.isnan().any()) and same_nan):
            fail(f"indefinite panel: {what} NaN pattern differs from the plain version's")
        check_rel(f"indefinite panel {what}[:128, :128] vs plain", got[:128, :128],
                  ref[:128, :128], study.PANEL_RTOL)


def phase_study_path(dev) -> dict:
    """The study's path once at full size, counts set to 0 just before and
    read just after; the factors checked against f32 cholesky_ex (the
    study's 1e-4 relative error). Returns the launch counts."""
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((N_STUDY_GRAM, D), generator=g, dtype=torch.float32, device=dev)
    A = torch.ones((512, 512), dtype=torch.float32, device=dev)
    K = study.spd_test_matrix(N_STUDY, 256, dev)
    params = study.study_params(dev)
    torch.cuda.synchronize()
    reset_launches()
    Kg = study.se_gram_study(X, params)
    o = chol_op.launch_probe(A, 512)
    Lp = study.cholesky_blocked_panels(K, block=STUDY_BLOCK)
    Ls = chol_op.single_launch_cholesky(K)
    torch.cuda.synchronize()
    counts = {"se_gram_study": gram_op.LAUNCHES["gram"], **chol_op.LAUNCHES}
    print(f"  launches on the study path: {counts}; cooperative grids of 256-thread blocks: "
          f"panel B={STUDY_BLOCK} {panel_grid(STUDY_BLOCK)}, single launch "
          f"{chol_op.max_grid_blocks('single_launch')}")
    expect = {"se_gram_study": 1, "launch_probe": 1,
              "chol_inv_panel": N_STUDY // STUDY_BLOCK, "single_launch_cholesky": 1}
    if counts != expect:
        fail(f"study path launches {counts}, expected {expect}")
    if not (bool(torch.isfinite(Kg).all()) and bool((o == 513.0).all())):
        fail("study gram not finite or probe wrong")
    L0 = torch.linalg.cholesky_ex(K)[0]
    check_rel(f"cholesky_blocked_panels n={N_STUDY} vs f32 cholesky_ex", Lp, L0, 1e-4)
    check_rel(f"single launch n={N_STUDY} vs f32 cholesky_ex", Ls, L0, 1e-4)
    if not bool((torch.triu(Ls, 1) == 0).all()):
        fail("single_launch_cholesky: nonzero above the diagonal at full size")
    return counts


def panel_grid(B: int) -> int:
    return chol_op.panel_grid_blocks(B, chol_op.max_grid_blocks("panel"))


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) * 1e6


def bound(nbytes, flops):
    """(ms, 'bytes' or 'operations'): the larger of bytes at the memory rate
    and f32 operations at the non-tensor rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def once_ms(fn, *args):
    """(fn(*args), milliseconds of that one call between two CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_study_times(dev, card) -> dict:
    """The study's timings, then the plain versions' and the bounds; returns
    the table rows' numbers by kernel. A row's `ms` is the kernel's own time
    on the card; where the host sets a call's time (the probe, the study
    gram) the time per call stands beside it as `call_ms`."""
    print(f"  launch probe (best of 2 x 50 launches, CUDA events), card {card}")
    probe = study.study_launch_overhead(dev)
    print("  study gram (best of 2 x 10)")
    grams = study.study_gram(dev, reps=10)
    print("  panel (best of 2 x 3)")
    panels = study.study_panel(dev, reps=3)
    c_step_ms, panel_rate = study.panel_fit(panels.values())
    print("  single launch (best of 2 x 3)")
    single = study.study_single_launch(dev, n=N_STUDY)
    print("the single launch's correction alone, the deep product and gemm_tile "
          "(perf/single_parts.py)")
    products = single_parts.product_rates(dev, n=N_STUDY)
    print("  full factorization four ways (best of 2 x 3)")
    full = study.study_full(dev, n=N_STUDY)

    A = torch.ones((512, 512), dtype=torch.float32, device=dev)
    Ap = study.spd_test_matrix(STUDY_BLOCK, 64, dev)
    K = study.spd_test_matrix(N_STUDY, 256, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    X = torch.randn((N_STUDY_GRAM, D), generator=g, dtype=torch.float32, device=dev)
    _, plain_panel_ms = once_ms(chol_op.chol_inv_panel_plain, Ap)
    Ls_plain, plain_single_ms = once_ms(chol_op.single_launch_cholesky_plain, K)
    check_rel(f"single launch n={N_STUDY} vs plain", chol_op.single_launch_cholesky(K),
              Ls_plain, study.PANEL_RTOL)
    plain = {
        "launch_probe": time_ms(lambda: chol_op.launch_probe_plain(A, 512)),
        "se_gram_study": grams[N_STUDY_GRAM][2],
        "chol_inv_panel": plain_panel_ms,
        "single_launch_cholesky": plain_single_ms,
    }
    cdist_ms = time_ms(lambda: torch.cdist(X, X), reps=10)
    # the probe's adds each wait for the last: one per 4 cycles at the
    # card's maximum SM clock, however many cores the card has
    clock_hz = sm_clock_hz()
    chain_ms = {n: 1e3 * 4 * n / clock_hz for n in probe}
    probe_enqueue_ms = enqueue_ms(lambda: chol_op.launch_probe(A, 512), reps=50)
    for n, (ms, dev_ms) in probe.items():
        print(f"  probe n_iter={n}: {1e3 * ms:.3f} us per call, {1e3 * dev_ms:.3f} us on the "
              f"card; its chain of {n} dependent adds at 4 cycles each at the maximum SM "
              f"clock ({clock_hz / 1e9:.3f} GHz): {1e3 * chain_ms[n]:.3f} us")
    print(f"  probe n_iter=512: host enqueue of one call {1e3 * probe_enqueue_ms:.3f} us")
    # one launch's floor on the card (the probe with no adds, measured) plus
    # the chain of 512 dependent adds
    floor_ms = probe[0][1]
    probe_bound = (floor_ms + chain_ms[512], "operations")
    print(f"  probe bound: floor {1e3 * floor_ms:.3f} us + chain {1e3 * chain_ms[512]:.3f} us "
          f"= {1e3 * probe_bound[0]:.3f} us; the probe at 512 adds reaches "
          f"{100 * probe_bound[0] / probe[512][1]:.1f}% of it")
    B, n = STUDY_BLOCK, N_STUDY
    rows = {
        "se_gram_study": (grams[N_STUDY_GRAM][1], plain["se_gram_study"],
                          gram_bound_ms(N_STUDY_GRAM, N_STUDY_GRAM, D, 4, True), None,
                          {"call_ms": grams[N_STUDY_GRAM][0], "cdist_ms": cdist_ms,
                           "call_ms_by_n": {k: v[0] for k, v in grams.items()},
                           "ms_by_n": {k: v[1] for k, v in grams.items()}}),
        "chol_inv_panel": (panels[f"B={B}"][0], plain["chol_inv_panel"],
                           bound(12 * B * B, 2 * B**3 / 3), panels[f"B={B}"][2],
                           {"grid_blocks": panels[f"B={B}"].grid_blocks,
                            "grid_syncs": panels[f"B={B}"].grid_syncs,
                            "ms_by_case": {k: v.ms for k, v in panels.items()},
                            "bound_ms_by_case": {k: bound(12 * v.B**2, 2 * v.B**3 / 3)[0]
                                                 for k, v in panels.items()},
                            "library_ms_by_case": {k: v.library_ms for k, v in panels.items()},
                            "cholesky_ex_ms_by_case": {k: v.cholesky_ex_ms
                                                       for k, v in panels.items()},
                            "fit_c_step_ms": c_step_ms, "fit_rate_tflops": panel_rate}),
        "launch_probe": (probe[512][1], plain["launch_probe"], probe_bound, None,
                         {"call_ms": probe[512][0], "floor_ms": floor_ms,
                          "call_ms_by_n_iter": {n: v[0] for n, v in probe.items()},
                          "ms_by_n_iter": {n: v[1] for n, v in probe.items()},
                          "enqueue_ms": probe_enqueue_ms}),
        "single_launch_cholesky": (single["single"], plain["single_launch_cholesky"],
                                   bound(8 * n * n, n**3 / 3), full["cholesky_ex"],
                                   {**single["stamped"], "full_ms": full,
                                    "product_tflops_by_depth": {c: v[1] for c, v in
                                                                products.items()},
                                    "gemm_tile_tflops_by_depth": {c: v[3] for c, v in
                                                                  products.items()}}),
    }
    for name, (ms, pl, (b_ms, b_by), lib, _) in rows.items():
        lib_s = "none" if lib is None else f"{lib:.4f} ms"
        print(f"  {name}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"plain {pl:.4f} ms, library {lib_s}")
    return rows


# phases 17-23: the sparse models, VI, cross-validation, the on-device
# L-BFGS and the notebook anchors

def target_grad(m):
    t, g = m.target_and_dtarget()
    return float(t), g.double().cpu().numpy()


def check_model(name, m32, refs):
    """m32's target and gradient on the card (its launches counted) against
    each reference model in `refs`: [(label, model, value rtol, gradient
    atol over max|g|)]. Returns the launches."""
    (t32, g32), n = launches(lambda: target_grad(m32))
    print(f"{name}: f32 card target {t32:.6f}, {n[0]} gram and {n[1]} gram_vjp launches")
    for label, m, rtol, gtol in refs:
        t, g = target_grad(m)
        check_close(f"{name} {label} target", t32, t, rtol)
        check_close(f"{name} {label} gradient", g32, g, 0.0, gtol * float(np.abs(g).max()))
    return n


def phase_fitc_10k(dev) -> tuple:
    """Phase 17: FITC at N = 10 000, m = 512, d = 4 (configuration #4's data
    cut in N). Tolerances from `python -m ...perf.fitc_study --f32-gap` (CPU,
    four states): the f32 model stands up to 5.2e-2 (mll, relative) and
    2.0e-2 max|g| from f64, most of it its relative jitter on Kuu (1e-4
    against 1e-10), so f32 card vs f64 CPU holds at rtol 0.1 and 4e-2
    max|g|; f32 rounding alone (the rows permuted) moves them by 1.0e-6 and
    4.4e-6, so f32 card vs f32 CPU holds at 1e-4 and 1e-3 max|g|; f64 card
    vs f64 CPU at rtol 1e-9 and 1e-8 max|g|. Then predict_y at 500 points
    (3 forward launches: K(Xu), K(Xu, X), K(Xu, Xs); no VJP). Returns the
    launches."""
    n = fitc_study.N_GAP
    m32 = fitc_study.config4_model(dev, n)
    m64c = fitc_study.config4_model("cpu", n, np.float64)
    n_eval = check_model(f"FITC N={n}", m32, [
        ("f32 card vs f32 CPU", fitc_study.config4_model("cpu", n), 1e-4, 1e-3),
        ("f32 card vs f64 CPU", m64c, 0.1, 4e-2)])
    check_f64_card(f"FITC N={n}", fitc_study.config4_model(dev, n, np.float64), m64c)
    if n_eval != (2, 2):
        fail(f"FITC: {n_eval} launches, expected (2, 2)")
    Xs = np.random.RandomState(7).randn(500, fitc_study.D_FEAT).astype(np.float32)
    (mu, var), n_pred = launches(lambda: m32.predict_y(Xs))
    print(f"FITC predict_y at 500 points: {n_pred} launches, mean range "
          f"[{float(mu.min()):.4f}, {float(mu.max()):.4f}], min variance {float(var.min()):.4e}")
    if not (bool(torch.isfinite(mu).all()) and bool((var >= 0).all()) and n_pred == (3, 0)):
        fail("FITC predict_y: non-finite, negative variance or wrong launches")
    return tuple(a + b for a, b in zip(n_eval, n_pred))


def check_f64_card(name, m64, m64c):
    t, g = target_grad(m64)
    tc, gc = target_grad(m64c)
    check_close(f"{name} f64 card vs f64 CPU target", t, tc, 1e-9)
    check_close(f"{name} f64 card vs f64 CPU gradient", g, gc, 1e-8,
                1e-10 * float(np.abs(gc).max()))


def _f64(t):
    return None if t is None else t.double()


def check_gram_at(what, fam, p, X1, X2) -> float:
    """The gram kernel against its plain version at one shape of the path
    (X1 or p batched over blocks or chains where 3-D or 2-D): within atol
    1e-5 sigma^2 in f32 and 1e-12 sigma^2 in f64 (phase 3's tolerances).
    The plain version runs in f64 on the same inputs: the kernel takes
    direct differences, and the f32 plain version, above its size budget,
    takes the expansion, whose rounding of r2 (a few ulp of |x|^2) alone
    passes the f32 tolerance where |x|^2 is large (576 at configuration
    #3's n = 4096). Returns max|K - plain|."""
    tol = 1e-5 if X1.dtype == torch.float32 else 1e-12
    sig2 = float(torch.exp(2 * p[..., 0]).max())
    K = gram_op.launch_gram(fam, p, X1, X2)
    K0 = gram_op.gram_plain(fam, p.double(), X1.double(), _f64(X2))
    err = float((K.double() - K0).abs().max())
    ok = bool(torch.isfinite(K).all()) and err <= tol * sig2
    print(f"  {what}: max|K - plain| {err:.3e} (atol {tol * sig2:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the gram kernel disagrees with its plain version at {what}")
    return err


def check_vjp_at(what, fam, p, X1, X2, G, needs=(True, False, False)) -> float:
    """The VJP kernel against its plain version (in f64 on the same inputs,
    as in `check_gram_at`) at one shape of the path: each output asked for
    within 1e-5 (f32) or 1e-12 (f64) of its sums of magnitudes (phase 3's
    tolerances). Returns the largest absolute difference."""
    tol = 1e-5 if X1.dtype == torch.float32 else 1e-12
    got = gram_op.launch_gram_vjp(fam, p, X1, X2, G, needs)
    args = (p.double(), X1.double(), _f64(X2), G.double())
    ref = gram_op.gram_vjp_plain(fam, *args, needs)
    batched = p.ndim == 2 or X1.ndim == 3 or (X2 is not None and X2.ndim == 3)
    scales = (batched_vjp_scales if batched else vjp_scales)(fam, *args)
    err, ratio = check_vjp(got, ref, scales, tol)
    print(f"  {what}: max|vjp - plain| {err:.3e} ({ratio:.3f} of tol) "
          f"{'ok' if ratio <= 1.0 else 'FAIL'}")
    if not ratio <= 1.0:
        fail(f"the VJP kernel disagrees with its plain version at {what}")
    return err


def phase_kernels_at(dev, what, fam, p, X1, X2, G) -> dict:
    """Both gram kernels at one of the path's shapes, the VJP with dp alone
    (as the sparse models' steps run it). Returns the largest absolute
    differences."""
    return {"gram": check_gram_at(what, fam, p, X1, X2),
            "gram_vjp": check_vjp_at(what, fam, p, X1, X2, G)}


@contextlib.contextmanager
def captured_launches(every: bool = False):
    """While open, keeps a copy of the inputs of the last launch of each
    gram kernel at each (family, dtype, shapes, needs) that the path runs
    (a sampler's first VJP may have a zero cotangent: its latents start
    at 0), or of every launch with `every`, so that `check_captured` can
    hold the kernels against their plain versions at those inputs after
    the run whose launches are counted. A launch under CUDA-graph capture
    computes nothing yet and is not kept: a graphed path's launches are
    kept from its capture's warm-up, which ran on the same inputs. So the
    block opens by dropping every kept graph (`graphs.clear()`): each
    graphed region in it captures anew, and no graph captured before it
    replays launches that nothing here holds against the plain version."""
    graphs.clear()
    seen = {}
    launch_gram, launch_gram_vjp = gram_op.launch_gram, gram_op.launch_gram_vjp

    def keep(key, *args):
        if args[2].is_cuda and torch.cuda.is_current_stream_capturing():
            return
        if every:
            key += (len(seen),)
        seen[key] = tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                          for a in args)

    def shapes(*ts):
        return tuple(None if t is None else tuple(t.shape) for t in ts)

    def gram(family, p, X1, X2=None, grid=0):
        keep(("gram", family, X1.dtype, shapes(p, X1, X2)), family, p, X1, X2)
        return launch_gram(family, p, X1, X2, grid)

    def vjp(family, p, X1, X2, G, needs=(True, True, True), grid=0):
        needs = tuple(bool(x) for x in needs)
        keep(("gram_vjp", family, X1.dtype, shapes(p, X1, X2, G), needs),
             family, p, X1, X2, G, needs)
        return launch_gram_vjp(family, p, X1, X2, G, needs, grid)

    gram_op.launch_gram, gram_op.launch_gram_vjp = gram, vjp
    try:
        yield seen
    finally:
        gram_op.launch_gram, gram_op.launch_gram_vjp = launch_gram, launch_gram_vjp


def check_captured(what, seen) -> dict:
    """Every launch `captured_launches` kept, replayed and held against the
    plain version (`check_gram_at`, `check_vjp_at`). Returns the largest
    absolute differences."""
    errs = {"gram": 0.0, "gram_vjp": 0.0}
    for key, args in seen.items():
        shape = " x ".join("-" if s is None else str(s) for s in key[3])
        label = f"{what}: {key[0]} family {key[1]} {str(key[2])[6:]} {shape}"
        if key[0] == "gram":
            errs["gram"] = max(errs["gram"], check_gram_at(label, *args))
        else:
            errs["gram_vjp"] = max(errs["gram_vjp"], check_vjp_at(label + f" {key[4]}", *args))
    return errs


N_FITC_STEPS = 3  # phase 18's Adam steps at N = 100 000


def phase_fitc_100k(dev) -> dict:
    """Phase 18: configuration #4 at full width. The gram kernels at the cross
    shape against their plain versions; N_FITC_STEPS steps of
    perf/fitc_study.py's Adam with the reject-don't-commit guard (counts set
    to 0 before, read after: exactly 2 + 2 launches a step, 1 + 1 of them at
    the cross shape, counted by shape where they launch), each timed by
    CUDA events, the loss finite and falling. (The cross gram's own times
    are taken in phase 8, before phase 16's profile.)"""
    X, _, Xu = fitc_study.config4_data()
    f32 = dict(dtype=torch.float32, device=dev)
    X, Xu = torch.as_tensor(X, **f32), torch.as_tensor(Xu, **f32)
    G = torch.randn((fitc_study.M, fitc_study.N), generator=torch.Generator(device=dev)
                    .manual_seed(18), **f32)
    errs = phase_kernels_at(dev, f"cross gram SE {fitc_study.M} x {fitc_study.N}", gram_op.SE,
                            torch.tensor([0.0, 0.0, 0.0], **f32), Xu, X, G)
    del G
    t0 = time.perf_counter()
    trainer = fitc_study.FitcAdam(fitc_study.config4_model(dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step_ms, losses = [], []

    def steps():
        for _ in range(N_FITC_STEPS):
            loss, ms = once_ms(trainer.step)
            losses.append(loss)
            step_ms.append(ms)

    _, n = launches(steps)
    shape = (fitc_study.M, fitc_study.N)
    cross = tuple(gram_op.LAUNCH_SHAPES[(name, *shape, True)] for name in ("gram", "gram_vjp"))
    print(f"FITC N={fitc_study.N}: set-up {setup_s:.2f} s, losses {losses}, step ms "
          f"{step_ms}, {n[0]} gram and {n[1]} gram_vjp launches ({cross[0]} and {cross[1]} "
          f"at {shape[0]} x {shape[1]}), peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB", flush=True)
    if n != (2 * N_FITC_STEPS, 2 * N_FITC_STEPS) or cross != (N_FITC_STEPS, N_FITC_STEPS):
        fail(f"FITC at N={fitc_study.N}: {n} launches ({cross} at the cross shape), expected "
             f"2 + 2 a step, 1 + 1 of them K(Xu, X)")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"FITC at N={fitc_study.N}: loss not finite or not falling: {losses}")
    return {"launches": n, "cross_launches": cross, "losses": losses, "step_ms": step_ms,
            "setup_s": setup_s, "max_abs_err": errs}


def fsa_model(device, dtype):
    X, y, Xu = fitc_study.config4_data(fitc_study.N_GAP)
    # 23 ragged blocks (434 or 435 points) of the points ordered along x_1
    blocks = np.array_split(np.argsort(X[:, 0], kind="stable"), 23)
    return gp.FSA(X.astype(dtype), Xu.astype(dtype), [b.tolist() for b in blocks],
                  y.astype(dtype), kernel=gp.SE(0.0, 0.0), lognoise=-1.0, device=device)


def phase_fsa(dev) -> tuple:
    """Phase 19: FSA at N = 10 000 (configuration #4's data and inducing
    rows) over 23 ragged blocks along x_1. The batched block grams (X
    (23, 435, 4), p shared) against their plain versions; the mll and
    gradient: f32 card against f32 CPU (rtol 1e-4, 1e-3 max|g|, phase 17's
    rounding tolerances) and f64 card against f64 CPU (rtol 1e-9, 1e-8),
    3 + 3 launches (K(Xu), K(Xu, X), the blocks in one); predict_f with
    blockindpred at 400 points against f64 on the CPU (mean atol 1e-9,
    variance atol 1e-9) and in f32 finite, 5 forward launches (the three of
    the factor, K(Xu, Xs) and the blocks' cross grams in one). Returns the
    launches and the kernel errors."""
    m32 = fsa_model(dev, np.float32)
    cs = m32.covstrat
    Xb = m32.x[cs.block_idx.reshape(-1)].reshape(*cs.block_idx.shape, m32.dim).contiguous()
    G = torch.randn(Xb.shape[:2] + Xb.shape[1:2], generator=torch.Generator(device=dev)
                    .manual_seed(19), dtype=torch.float32, device=dev)
    errs = phase_kernels_at(dev, f"FSA block grams {tuple(Xb.shape)}", gram_op.SE,
                            torch.zeros(3, dtype=torch.float32, device=dev), Xb, None, G)
    n_eval = check_model("FSA N=10000", m32, [
        ("f32 card vs f32 CPU", fsa_model("cpu", np.float32), 1e-4, 1e-3)])
    m64c = fsa_model("cpu", np.float64)
    m64 = fsa_model(dev, np.float64)
    check_f64_card("FSA N=10000", m64, m64c)
    if n_eval != (3, 3):
        fail(f"FSA: {n_eval} launches, expected (3, 3)")
    Xs = np.random.RandomState(19).randn(400, fitc_study.D_FEAT)
    order = np.argsort(Xs[:, 0], kind="stable")
    bip = [b.tolist() for b in np.array_split(order, 23)]
    (mu32, var32), n_pred = launches(lambda: m32.predict_f(Xs.astype(np.float32),
                                                           blockindpred=bip))
    mu64, var64 = m64.predict_f(Xs, blockindpred=bip)
    mu_c, var_c = m64c.predict_f(Xs, blockindpred=bip)
    check_close("FSA blockindpred f64 card vs CPU mean", mu64.cpu(), mu_c, 0.0, 1e-9)
    check_close("FSA blockindpred f64 card vs CPU variance", var64.cpu(), var_c, 0.0, 1e-9)
    print(f"FSA predict_f with blockindpred, f32: {n_pred} launches, max|mu32 - mu64| "
          f"{float((mu32.double() - mu64).abs().max()):.3e}")
    if not (bool(torch.isfinite(mu32).all()) and bool(torch.isfinite(var32).all())
            and n_pred == (5, 0)):
        fail("FSA predict_f: non-finite in f32 or not 5 forward launches")
    return tuple(a + b for a, b in zip(n_eval, n_pred)), errs


# phase 20's tolerances, as (value or mean, gradient or variance). f64 on
# the card against f64 on the CPU, the CPU's gram by direct differences as
# the kernel takes them; `vi_study --f32-gap` (CPU) grounds them: on the
# observations permuted the f64 objective moved 1.3e-13 (value, relative)
# and 1.5e-11 (gradient, of max|g|) at the f32 nugget 1e-4, 8.8e-12 and
# 1.5e-9 at f64's own 1e-6; the predictive 4.9e-13 and 6.3e-12 (of max),
# 4.4e-11 and 5.1e-10. (The plain version's expansion of r2, which an f64
# CPU reference takes at this size otherwise, moves them 5.7e-13 and
# 3.1e-9, 4.5e-10 and 3.2e-7; 9.9e-12 and 1.0e-9, 7.8e-10 and 8.5e-8.)
VI_F64 = {"1e-4": (1e-11, 1e-9), "1e-6": (1e-9, 1e-7)}
VI_F64_PREDICTIVE = {"1e-4": (1e-10, 1e-10), "1e-6": (1e-8, 1e-8)}
# f32 on the card against f64 on the card at the same nugget (1e-4), and
# against f32 on the CPU (its gram by direct differences: the plain f32
# gram's expansion of r2 at |x|^2 = 576 moves K by ~5e-5, half the nugget,
# and the CPU's f32 factor then fails). `--f32-gap` (CPU, direct
# differences): f32 against f64 at 1e-4 stood 3.0e-4 (value) and 6.8e-3
# (gradient), the predictive 2.6e-5 and 4.3e-3; f32 against itself
# permuted 2.0e-4 and 6.6e-3.
VI_F32_OBJECTIVE = (1e-3, 2e-2)
VI_F32_CPU_OBJECTIVE = (1e-3, 3e-2)
VI_F32_PREDICTIVE = (1e-4, 2e-2)


def within(what, got, tol) -> None:
    """Fails unless each of `got` (relative gaps) is within its `tol`."""
    ok = all(g <= t for g, t in zip(got, tol))  # False on NaN
    print(f"  {what}: {got[0]:.3e}, {got[1]:.3e} (tol {tol[0]:g}, {tol[1]:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what}: {got} beyond {tol}")


def phase_vi(dev) -> dict:
    """Phase 20: configuration #3 (perf/vi_study.py). Its run on the card
    (launches counted from 0 around the fit: 1 gram, no VJP) must raise the
    ELBO over 150 Adam steps with the f32 prior factor holding, and the
    rate exp(m + v/2) must correlate with the counts above 0.5 (the
    Poisson anchor's bar). Every gram launch of the run (the f32 and f64
    priors, 4096 x 4096 symmetric, and the predictives' cross grams) is
    then held against the plain version, and the VJP kernel, which the
    fit does not run, at the same shapes on a random cotangent. The
    negative ELBO's value and gradient at theta0 and at the fit, and the
    predictive from the fit's Q: f64 on the card against f64 on the CPU at
    both nuggets (`VI_F64`, `VI_F64_PREDICTIVE`), f32 on the card against
    f64 on the card at f32's nugget (`VI_F32_OBJECTIVE`,
    `VI_F32_PREDICTIVE`) and against f32 on the CPU
    (`VI_F32_CPU_OBJECTIVE`)."""
    with captured_launches() as seen:
        out = vi_study.run(dev)
    errs = check_captured("VI", seen)
    k = gp.Matern(1.5, np.log(0.5), 0.0).to(dtype=torch.float32, device=dev)
    t, _ = vi_study.config3_data()
    X = k._scale(torch.as_tensor(t[:, None], dtype=torch.float32, device=dev))
    gen = torch.Generator(device=dev).manual_seed(20)
    for sym in (True, False):
        G = torch.randn((vi_study.N, vi_study.N), generator=gen, dtype=torch.float32, device=dev)
        errs["gram_vjp"] = max(errs["gram_vjp"], check_vjp_at(
            f"VI Matern 3/2 {vi_study.N} x {vi_study.N} {'sym' if sym else 'cross'}",
            k._family, k._gram_params(), X, None if sym else X.flip(0).contiguous(), G,
            (True, True, not sym)))
    if not (out["factor_ok"] and out["elbo"] > out["elbo0"] and out["rate_corr"] > 0.5
            and out["fit_launches"] == (1, 0) and out["objective_launches"] == (3, 0)
            and out["predict_launches"] == (6, 0) and out["predictive"]["finite"]
            and all(row["finite"] for row in out["objective"].values())):
        fail(f"VI at n={out['n']}: {out}")
    for at, row in out["objective"].items():
        within(f"VI neg_elbo at {at}, f64 card vs CPU, nugget 1e-4",
               row["f64_card_vs_cpu_1e-4"], VI_F64["1e-4"])
        within(f"VI neg_elbo at {at}, f64 card vs CPU, nugget 1e-6",
               row["f64_card_vs_cpu"], VI_F64["1e-6"])
        within(f"VI neg_elbo at {at}, f32 card vs f64 card, nugget 1e-4",
               row["f32_card_vs_f64_card_1e-4"], VI_F32_OBJECTIVE)
        within(f"VI neg_elbo at {at}, f32 card vs f32 CPU", row["f32_card_vs_f32_cpu"],
               VI_F32_CPU_OBJECTIVE)
    pr = out["predictive"]
    within("VI predictive, f64 card vs CPU, nugget 1e-4", pr["f64_1e-4_card_vs_cpu"],
           VI_F64_PREDICTIVE["1e-4"])
    within("VI predictive, f64 card vs CPU, nugget 1e-6", pr["f64_card_vs_cpu"],
           VI_F64_PREDICTIVE["1e-6"])
    within("VI predictive, f32 card vs f64 card, nugget 1e-4", pr["card_f32_vs_f64_1e-4"],
           VI_F32_PREDICTIVE)
    out["max_abs_err"] = errs
    return out


def phase_cv(dev) -> tuple:
    """Phase 21: cross-validation on the headline (SE, n = 3000, d = 10):
    logp_LOO, dlogp_LOO (exactly 1 + 1 launches), logp_CVfold and
    dlogp_CVfold over 10 equal folds, f32 on the card against f64 on the
    card (value rtol 1e-4, gradient atol 1e-3 max|g|; on the CPU the f32
    model stood 2.0e-7 and 7.4e-7 from f64) and f64 on the card against f64
    on the CPU (rtol 1e-9, gradient 1e-8 with atol 1e-10 max|g|). Returns
    the launches of the f32 calls."""
    rng = np.random.RandomState(42)
    Xh, yh = rng.randn(N_HEAD, D), rng.randn(N_HEAD)
    folds = [list(range(i * N_HEAD // 10, (i + 1) * N_HEAD // 10)) for i in range(10)]

    def make(dtype, device):
        return gp.GPE(Xh.astype(dtype), yh.astype(dtype), gp.MeanZero(), gp.SE(0.0, 0.0),
                      lognoise=-1.0, device=device)

    calls = {"logp_LOO": lambda m: gp.logp_LOO(m), "dlogp_LOO": lambda m: gp.dlogp_LOO(m),
             "logp_CVfold": lambda m: gp.logp_CVfold(m, folds),
             "dlogp_CVfold": lambda m: gp.dlogp_CVfold(m, folds)}
    m32, m64, m64c = make(np.float32, dev), make(np.float64, dev), make(np.float64, "cpu")
    total = [0, 0]
    for name, fn in calls.items():
        v32, n = launches(lambda: fn(m32))
        v64, vc = fn(m64).cpu().numpy(), fn(m64c).numpy()
        print(f"{name}: f32 card {np.round(v32.cpu().numpy(), 4).tolist()}, {n[0]} gram and "
              f"{n[1]} gram_vjp launches")
        grad = name.startswith("d")
        scale = float(np.abs(vc).max())
        check_close(f"{name} f32 card vs f64 card", v32.cpu(), v64, 0.0 if grad else 1e-4,
                    1e-3 * scale if grad else 0.0)
        check_close(f"{name} f64 card vs f64 CPU", v64, vc, 1e-9 if not grad else 1e-8,
                    1e-10 * scale if grad else 0.0)
        if name == "dlogp_LOO" and n != (1, 1):
            fail(f"dlogp_LOO: {n} launches, expected (1, 1)")
        total = [a + b for a, b in zip(total, n)]
    return tuple(total)


def optax_pair(name, model, iters, bar) -> tuple:
    """One graph-against-eager pair of phase 22 (`graph_pair`):
    `lbfgs.minimize` on the model's objective from its start, `iters`
    iterations, each way giving its iterates and its line-search trial
    counts (equal bits, or the iterates within `bar`, and the same counts
    each way), 1 + 1 launches an evaluation. Returns (the launches of both
    ways, the pair's numbers with the ms, evaluations and host reads an
    iteration)."""
    vg, x0, _, _ = model.make_objective()
    runs = []

    def setup():
        def call():
            trace = []
            res = lbfgs.minimize(vg, x0, iters, trace=trace)
            runs.append(res)
            return [*(x for x, _ in trace), res.x,
                    torch.stack([step.search.count for _, step in trace])]
        return call

    out, res = graph_pair(name, setup, (bar,), phase=22)
    if not torch.equal(res[0][-1], res[1][-1]):
        fail(f"phase 22: {name}: trial counts {res[0][-1].tolist()} graphed, "
             f"{res[1][-1].tolist()} eager")
    r = runs[0]
    out.update(n_iter=r.n_iter, counts=res[0][-1].tolist(), evaluations=r.evaluations / r.n_iter,
               host_reads=r.host_reads / r.n_iter)
    for label in ("graph", "eager"):
        for k in ("event_ms", "enqueue_ms", "busy_ms"):
            if out[f"{k}_{label}"] is not None:
                out[f"{k}_{label}"] /= r.n_iter
    print(f"  {name}: an iteration {out['event_ms_graph']:.4f} ms events, "
          f"{out['enqueue_ms_graph']:.4f} ms host, {out['busy_ms_graph']} ms busy graphed; "
          f"{out['event_ms_eager']:.4f} / {out['enqueue_ms_eager']:.4f} / "
          f"{out['busy_ms_eager']} eager; {out['evaluations']:.2f} evaluations and "
          f"{out['host_reads']:.2f} host reads an iteration, trial counts {out['counts']}",
          flush=True)
    evals = sum(1 + c for c in out["counts"])
    if out["launches_graph"] != (evals, evals):
        fail(f"phase 22: {name}: launches {out['launches_graph']} for {evals} evaluations")
    return [2 * n for n in out["launches_graph"]], out


def phase_optax(dev) -> tuple:
    """Phase 22: method='optax', optax's L-BFGS with its zoom line search
    (`inference/lbfgs.py`), on the card:
      * `optimize(method="optax", maxiter=10)` on the headline in f32: the
        target finite and no lower than at the start, and 1 + 1 launches
        for each evaluation the loop and its line search made;
      * `optax_pair` on the headline (10 iterations) and on configuration
        #2's GPA (n = 200 latents and 6 hyperparameters, 5 iterations):
        graphed and eager, the same iterates and trial counts.
    Returns (the launches of every run, the pairs' numbers)."""
    rng = np.random.RandomState(42)
    m = gp.GPE(rng.randn(N_HEAD, D).astype(np.float32), rng.randn(N_HEAD).astype(np.float32),
               gp.MeanZero(), gp.SE(0.0, 0.0), lognoise=-1.0, device=dev)
    p0 = m.get_params().clone()
    t_start = float(m.target)
    t0 = time.perf_counter()
    res, n = launches(lambda: m.optimize(method="optax", maxiter=10))
    secs = time.perf_counter() - t0
    t_end = float(m.target)
    evals = int(res.message.split()[0])
    print(f"optimize(method='optax', maxiter=10): target {t_start:.6f} -> {t_end:.6f}, "
          f"{res.n_iter} iterations, {res.message}, {n[0]} gram and {n[1]} gram_vjp launches, "
          f"{secs:.3f} s")
    if not (np.isfinite(t_end) and t_end >= t_start and n == (evals, evals)):
        fail("optimize(method='optax'): not finite, lower than at the start, or not 1 + 1 "
             "launches an evaluation")
    m.set_params(p0)
    total, out = optax_pair(f"headline SE n={N_HEAD} f32", m, 10, GRAPH_BARS["headline"][0])
    n = [a + b for a, b in zip(n, total)]
    total, out["config2"] = optax_pair("configuration #2's GPA", gpa_study.config2_model(dev), 5,
                                       GRAPH_BARS["sampler"][0])
    return tuple(a + b for a, b in zip(n, total)), out


# the anchors' sampler depths, cut to keep the script inside its time
# (PERF.md §4): robust regression and Poisson HMC from the examples' 500
# to 250 iterations (70 s each at 500), the quickstart from its parity
# test's 200 to 100; Poisson's vi (300) and Mauna Loa (maxiter=200) not cut
ANCHOR_ITERS = {"robust": 250, "poisson": 250, "regression": 100}


def phase_anchors(dev) -> dict:
    """Phase 23: the notebook anchors (the examples' `run`, the thresholds in
    perf/anchors.py) on the card, f32 but Mauna Loa and the sparse pins, in
    f64 (the Mauna Loa gram does not
    factor in f32 at its start, tests/test_torch_anchors.py): robust
    regression (rmse_t < rmse_g and < 0.15), Poisson (both correlations >
    0.5, within 0.15), Mauna Loa by L-BFGS-B and by method='optax' (rmse <
    3.5), the sparse golden mlls at N = 1000 (abs 1e-3), the regression
    quickstart (finite). Every gram launch of each anchor is then held
    against its plain version at its inputs (`check_captured`, the last
    launch at each family, dtype and shape): d = 1, n = 40 to 1000, the
    Mauna Loa composite's SE, Periodic and RQ grams in f64. Returns each
    anchor's numbers, the launches and the kernels' largest differences."""
    out, total, errs = {}, [0, 0], {"gram": 0.0, "gram_vjp": 0.0}

    def run(name, fn):
        t0 = time.perf_counter()
        with captured_launches() as seen:
            res, n = launches(fn)
        res["s"], res["launches"] = time.perf_counter() - t0, n
        print(f"anchor {name}: {json.dumps(res)}", flush=True)
        for kernel, err in check_captured(name, seen).items():
            errs[kernel] = max(errs[kernel], err)
        out[name] = res
        total[0] += n[0]
        total[1] += n[1]
        return res

    r = run("robust_regression", lambda: robust_regression.run(
        dev, np.float32, ANCHOR_ITERS["robust"], verbose=False))
    if not (r["rmse_t"] < r["rmse_g"] and r["rmse_t"] < anchors.ROBUST_RMSE_T):
        fail(f"robust regression anchor: {r}")
    r = run("poisson", lambda: poisson_regression.run(dev, np.float32, ANCHOR_ITERS["poisson"],
                                                      verbose=False))
    if not (min(r["corr_mcmc"], r["corr_vi"]) > anchors.POISSON_CORR
            and abs(r["corr_mcmc"] - r["corr_vi"]) < anchors.POISSON_GAP):
        fail(f"Poisson anchor: {r}")
    for method in ("lbfgs", "optax"):
        r = run(f"mauna_loa_{method}",
                lambda: mauna_loa.run(dev, method=method, verbose=False))
        if not (r["rmse"] < anchors.MAUNA_LOA_RMSE and r["mll"] > r["mll0"]):
            fail(f"Mauna Loa anchor ({method}): {r}")
    r = run("sparse_golden", lambda: anchors.sparse_golden(dev))
    if not r["within"]:
        fail(f"sparse golden mlls: {r}")
    r = run("regression", lambda: regression.run(dev, np.float32, ANCHOR_ITERS["regression"],
                                                 verbose=False))
    if not r["finite"]:
        fail(f"regression quickstart: {r}")
    return out, tuple(total), errs


# phase 24's depths at 1024 chains, cut from the bench's (PERF.md §4):
# sharded_hmc 24 warmup (mass updates at 12 and 18) + 8, sharded_split_hmc
# 4 + 4 outer, sharded_ess 10
CONFIG5 = {"hmc": (24, 8), "split": (4, 4), "ess": 10}


def phase_config5(dev) -> dict:
    """Phase 24: configuration #5 at 1024 chains, f32, through `make_mesh()`
    (one process: the card's machine has one card). sharded_hmc (eps0 0.02,
    target 0.8): exactly 1 + 15 gram and gram_vjp launches an iteration at
    60 x 60 (its start evaluation, then Lmax leapfrog steps), finite
    targets, a step size moved from eps0, an adapted mass matrix; the split
    sampler: exactly 17 + 16 an outer iteration; the ESS: forward launches
    only. Every launch of the three kept by `captured_launches` is replayed
    against the plain version in f64. Then 8 iterations (4 + 4) of
    sharded_hmc three ways: whole; with a checkpoint written after 4 (the
    run goes on to 8); resumed from that checkpoint: all three bit for bit
    equal."""
    mesh = gp.make_mesh()
    print(f"  make_mesh(): world size 1, axis 'chains' of size {mesh.shape['chains']} on "
          f"{mesh.device} (the machine has one card: no collective runs)")
    C = student_t_study.CHAINS
    logprob, x0, _, _ = student_t_study.config5_model(dev).make_logprob()
    starts = student_t_study.chain_starts(x0, C, 17)
    precompute, lp_a, lp_b, a0, b0 = student_t_study.config5_model(dev).make_split_logprob()
    starts_s = student_t_study.chain_starts(torch.cat([a0, b0]), C, 3)
    loglik, xg0, _, _ = student_t_study.config5_gpe(dev).make_logprob(include_priors=False)
    starts_e = student_t_study.chain_starts(xg0, C, 2)
    (hw, hn), (sw, sn), en = CONFIG5["hmc"], CONFIG5["split"], CONFIG5["ess"]
    out = {}
    with captured_launches() as seen:
        for name, call, per_iter in (
                ("sharded_hmc", lambda: chains.sharded_hmc(
                    logprob, starts, 24, mesh, n_iter=hn, n_warmup=hw,
                    eps0=student_t_study.EPS0, target_accept=student_t_study.TARGET),
                 (15, 15)),
                ("sharded_split_hmc", lambda: chains.sharded_split_hmc(
                    precompute, lp_a, lp_b, starts_s, 24, mesh, a0.numel(), n_iter=sn,
                    n_warmup=sw, a_iters=student_t_study.A_ITERS, eps_a0=student_t_study.EPS_A0,
                    eps_b0=student_t_study.EPS_B0), (17, 16)),
                ("sharded_ess", lambda: chains.sharded_ess(
                    loglik, starts_e, student_t_study.PRIOR_MU, student_t_study.PRIOR_SIGMA, 24,
                    mesh, n_iter=en), None)):
            t0 = time.perf_counter()
            res, n = launches(call)
            secs = time.perf_counter() - t0
            shapes = gram_study.by_shape()
            iters = {"sharded_hmc": hw + hn, "sharded_split_hmc": sw + sn, "sharded_ess": en}[name]
            print(f"  {name}, {C} chains, {iters} iterations: {secs:.3f} s "
                  f"({1e3 * secs / iters:.1f} ms an iteration), launches {n}, by shape {shapes}",
                  flush=True)
            # sharded_hmc: its start evaluation, then Lmax evaluations an
            # iteration; the ESS: forward only, one or more an iteration
            if per_iter is None:
                ok = n[1] == 0 and n[0] >= iters + 1
            else:
                start = 1 if name == "sharded_hmc" else 0
                ok = n == tuple(start + per_iter[i] * iters for i in range(2))
            if not ok or any(k[1:3] != (60, 60) for k in gram_op.LAUNCH_SHAPES):
                fail(f"{name}: launches {n} by shape {shapes}, expected {per_iter} an "
                     f"iteration at 60 x 60")
            out[name] = {"s": secs, "iters": iters, "launches": n, "by_shape": shapes,
                         "result": res}
    h, sp, e = (out[k]["result"] for k in ("sharded_hmc", "sharded_split_hmc", "sharded_ess"))
    eps = float(h.eps_final)
    print(f"  sharded_hmc: eps {student_t_study.EPS0} -> {eps:.5f}, minv in "
          f"[{float(h.minv_final.min()):.4f}, {float(h.minv_final.max()):.4f}], accept "
          f"{float(h.accept_rate.mean()):.3f}; split: eps_a {float(sp.eps_a_final):.5f}, eps_b "
          f"{float(sp.eps_b_final):.5f}; ess: {float(e.mean_proposals):.3f} proposals an "
          f"iteration")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        h.final_target, h.samples, sp.final_target, sp.samples, e.final_loglik, e.samples))
    if not (finite and eps != student_t_study.EPS0 and not bool((h.minv_final == 1).all())):
        fail("configuration #5: non-finite targets or draws, or no adaptation")
    errs = check_captured("configuration #5", seen)

    whole = chains.sharded_hmc(logprob, starts, 5, mesh, n_iter=4, n_warmup=4, eps0=0.02)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/config5.ckpt.npz"
        written = chains.sharded_hmc(logprob, starts, 5, mesh, n_iter=4, n_warmup=4, eps0=0.02,
                                     checkpoint_every=4, checkpoint_path=path)
        resumed = chains.sharded_hmc(logprob, starts, 5, mesh, n_iter=4, n_warmup=4, eps0=0.02,
                                     checkpoint_every=4, checkpoint_path=path)
    fields = ("samples", "accept_rate", "eps_final", "minv_final", "final", "final_target")
    same = {f: torch.equal(getattr(r, f), getattr(whole, f))
            for r in (written, resumed) for f in fields}
    print(f"  checkpointed after 4 of 8 iterations, and resumed from the file: bit for bit the "
          f"uninterrupted run's: {all(same.values())}")
    if not all(same.values()):
        fail(f"configuration #5: a checkpointed or resumed run differs: {same}")
    for row in out.values():
        del row["result"]
    out["max_abs_err"] = errs
    out["launches"] = tuple(sum(out[k]["launches"][i] for k in
                                ("sharded_hmc", "sharded_split_hmc", "sharded_ess"))
                            for i in range(2))
    return out


# phase 25's tolerances on the maintained factor against a fresh f64 GPE on
# the CPU, as (mll relative, alpha of max, factor of max). The CPU
# (`elastic_study --f32-gap`) put the f64 model within 0, 9.5e-15 and
# 2.4e-15 of it at n = 1024-4096, the f32 model within 8.1e-8, 4.4e-6 and
# 1.5e-6 (its gram by the expansion of r2).
ELASTIC_F64 = (1e-10, 1e-10, 1e-10)
ELASTIC_F32 = (1e-6, 5e-5, 2e-5)


def phase_elastic(dev) -> dict:
    """Phase 25: the elastic GP (perf/elastic_study.py) grown to 4096 points
    in blocks of 64 on the card, f32 and f64, across the capacity crossings
    at 1024, 2048 and 3072: the maintained factor against a fresh f64 GPE
    on the CPU at n = 1024, 2048, 3072 and 4096 (`ELASTIC_F64`,
    `ELASTIC_F32`); exactly 2 gram launches (K(X, x_new) at capacity x 64
    and K(x_new) at 64 x 64) and no VJP an in-bucket append, 1 (the refit) at a
    crossing; ms an append at n = 960 and 4032 beside one refit's at 1024
    and 4096 (f32)."""
    es = elastic_study
    refs, out = {}, {}
    total, by_shape = [0, 0], {"cross": 0, "block": 0}
    for dtype, tol in ((torch.float64, ELASTIC_F64), (torch.float32, ELASTIC_F32)):
        name = str(dtype)[6:]
        res, n = launches(lambda: es.run(dev, dtype, refs))
        total = [a + b for a, b in zip(total, n)]
        for (kernel, n1, n2, _), count in gram_op.LAUNCH_SHAPES.items():
            if kernel == "gram" and n2 == es.K:
                by_shape["block" if n1 == es.K else "cross"] += count
        crossings = [a["n"] for a in res["appends"] if a["crossing"]]
        counts = {a["launches"] for a in res["appends"][1:] if not a["crossing"]}
        cross_counts = {a["launches"] for a in res["appends"] if a["crossing"]}
        print(f"  {name}: capacity {res['capacity']}, crossings at n = {crossings}; launches an "
              f"in-bucket append {sorted(counts)}, a crossing {sorted(cross_counts)}")
        if crossings != list(range(es.CAPACITY, es.N, es.STEPSIZE)) or counts != {(2, 0)} \
                or cross_counts != {(1, 0)}:
            fail(f"elastic {name}: crossings {crossings}, launches {counts} / {cross_counts}")
        for n, g in res["gaps"].items():
            within(f"elastic {name} at n={n} (mll, alpha) vs f64 CPU", g[:2], tol[:2])
            within(f"elastic {name} at n={n} (alpha, factor) vs f64 CPU", g[1:], tol[1:])
        ms = {a["n"]: a["ms"] for a in res["appends"]}
        small, large = es.CAPACITY - es.K, es.N - es.K
        out[name] = {"gaps": res["gaps"], f"append_ms_at_{small}": ms[small],
                     f"append_ms_at_{large}": ms[large],
                     "append_ms_median_last_bucket": statistics.median(
                         a["ms"] for a in res["appends"]
                         if a["n"] > es.N - es.STEPSIZE and not a["crossing"])}
        if dtype == torch.float32:
            for n in (es.CAPACITY, es.N):
                out[name][f"refit_ms_{n}"] = es.refit_ms(res["model"], n)
        print(f"  {name}: " + json.dumps({k: v for k, v in out[name].items() if k != "gaps"}))
    out["launches"], out["launches_by_shape"] = tuple(total), by_shape
    return out


def phase_adapters(dev) -> tuple:
    """Phase 26: GPRegressor (maxiter=10) on the headline's data in f32 on
    the card: its predictions and standard deviations at 500 points equal,
    bit for bit, those of a GPE built the same way and optimized with
    maxiter=10; score and log_marginal_likelihood finite. Returns its
    launches (fit and predict)."""
    rng = np.random.RandomState(42)
    Xh, yh = rng.randn(N_HEAD, D).astype(np.float32), rng.randn(N_HEAD).astype(np.float32)
    Xs = np.random.RandomState(7).randn(500, D).astype(np.float32)
    est = gp.GPRegressor(kernel=gp.SE(0.0, 0.0), lognoise=-1.0, maxiter=10)
    (mu, sd), n = launches(lambda: est.fit(Xh, yh).predict(Xs, return_std=True))
    m = gp.GPE(Xh, yh, gp.MeanZero(), gp.SE(0.0, 0.0), lognoise=-1.0)
    m.optimize(maxiter=10)
    mu_m, var_m = m.predict_y(Xs)
    same = np.array_equal(mu, mu_m.cpu().numpy()) and np.array_equal(
        sd, np.sqrt(var_m.cpu().numpy()))
    score, lml = est.score(Xh, yh), est.log_marginal_likelihood()
    print(f"  GPRegressor(maxiter=10) n={N_HEAD}: on {est.gp_.device}, {n[0]} gram and {n[1]} "
          f"gram_vjp launches, predictions equal to the GPE's {same}, score {score:.6f}, "
          f"log_marginal_likelihood {lml:.6f}")
    if not (same and np.isfinite(score) and np.isfinite(lml) and est.gp_.device.type == "cuda"):
        fail("GPRegressor: predictions differ from the GPE's, or non-finite score or mll")
    return n


# phase 27's bar: the headline's (value relative, gradient of max|g|), or
# twice FullCovariance's own f32 gap from f64 at that size, the larger
HEADLINE_BAR = (1e-3, 2e-2)
# phase 28: phase 13's f32 tolerances (target relative, gradient of max|g|)
GPA_TOL = (1e-4, 2e-3)
# phase 29: phase 17's f32 card vs f32 CPU tolerances, here the sharded mll
# against the LowRankPD path, both f32 on the card
FITC_TOL = (1e-4, 1e-3)
N_SHARDED_FITC_STEPS = 3
# phase 30: the sharded ELBO trace against the replicated Adam run's, max
# gap over 150 steps as a fraction of max|ELBO|: 5.8e-8 measured on an
# H100 (f32; the two objectives sum log v as log v and as 2 rho)
VI_TRACE_TOL = 1e-6


def dist_table_rows(kernel):
    """(table key, `parallel_study.gram_rows` name, `gram_study.by_shape`
    name) of the distributed strategy's shapes for one gram kernel: the
    headline's cross gram at n = 3000 and 16384 (phase 27; phase 30's ring
    gram is 3000 x 3000 too) and configuration #2's batched cross gram at
    C = 128 (phase 28; a batched launch counts once for its chains)."""
    vjp = " dp" if kernel == "gram_vjp" else ""
    C, n = gpa_study.CHAINS, gpa_study.N
    return ([(f"cross_{m}x{m}", f"cross {kernel}{vjp} {m}x{m}", f"{kernel} cross {m}x{m}")
             for m in (3000, 16384)]
            + [(f"batched_cross_{C}x{n}x{n}", f"batched cross {kernel} C={C} {n}x{n}",
                f"{kernel} cross {n}x{n}")])


def dist_by_shape(dist) -> collections.Counter:
    """Launches by shape of phases 27-30's main-path calls, each counted
    from 0 around that call alone (`launches`): no reference, timing rep,
    factor study or replay is in them."""
    fit, vi_out = dist["dense"]["fit"], dist["vi"]
    counts = collections.Counter()
    for shapes in ([row["by_shape"] for row in dist["dense"]["sizes"]]
                   + [fit["optimize_by_shape"], fit["predict_by_shape"],
                      dist["gpa"]["by_shape"], dist["gpa"]["hmc_by_shape"],
                      dist["fitc"]["by_shape"], vi_out["train_by_shape"],
                      vi_out["restarts_by_shape"], vi_out["ring_by_shape"]]):
        counts.update(shapes)
    return counts


def phase_dist_dense(dev) -> dict:
    """Phase 27: the distributed dense GPE. At each size, the f32 target and
    gradient on `DistributedFullCovariance` against `FullCovariance` f32 on
    the card (`HEADLINE_BAR`), and against f64 on the card (and at n = 3000
    f64 on the CPU) within the bar or twice `FullCovariance`'s own f32 gap
    from that reference, the larger (both printed); exactly one launch of
    each gram kernel an evaluation, at the n x n cross shape. A non-PD K is
    -inf in f32 and f64; `optimize(maxiter=5)` rises from its start and
    `predict_y` (2 forward launches) is finite."""
    out = {"sizes": []}
    total = [0, 0]
    for n, B in parallel_study.DENSE_SIZES:
        row = parallel_study.dense(dev, n, B)
        within(f"distributed f32 vs FullCovariance f32 card, n={n}", row["dist32_vs_full32"],
               HEADLINE_BAR)
        for ref, name in (("full64", "f64 card"), ("full64_cpu", "f64 CPU")):
            if f"dist32_vs_{ref}" not in row:
                continue
            own = row[f"full32_vs_{ref}"]
            tol = tuple(max(b, 2 * g) for b, g in zip(HEADLINE_BAR, own))
            print(f"  n={n} against FullCovariance {name}: the bar {HEADLINE_BAR}, twice "
                  f"FullCovariance f32's own gap {tuple(2 * g for g in own)}")
            within(f"distributed f32 vs FullCovariance {name}, n={n}", row[f"dist32_vs_{ref}"],
                   tol)
        want = {f"gram cross {n}x{n}": 1, f"gram_vjp cross {n}x{n}": 1}
        if row["launches"] != (1, 1) or row["by_shape"] != want or not row["finite"]:
            fail(f"distributed headline n={n}: launches {row['by_shape']}, expected {want}, "
                 f"finite {row['finite']}")
        total = [a + b for a, b in zip(total, row["launches"])]
        out["sizes"].append(row)
    out["nonpd"] = parallel_study.nonpd(dev)
    if any(v != -math.inf for v in out["nonpd"].values()):
        fail(f"a non-PD K on the distributed strategy: {out['nonpd']}, expected -inf")
    fit = out["fit"] = parallel_study.dense_fit(dev)
    if not (np.isfinite(fit["target_end"]) and fit["target_end"] >= fit["target_start"]
            and fit["predict_finite"] and fit["predict_launches"] == (2, 0)
            and min(fit["optimize_launches"]) >= 1):
        fail(f"distributed optimize/predict_y: {fit}")
    out["launches"] = tuple(a + b + c for a, b, c in zip(total, fit["optimize_launches"],
                                                          fit["predict_launches"]))
    return out


def phase_dist_gpa(dev) -> dict:
    """Phase 28: configuration #2's GPA target on
    `DistributedFullCovariance(B=40)` vmapped over 128 chains (1 + 1
    launches, batched cross 200 x 200) against the vmapped `FullCovariance`
    target within `GPA_TOL` (every chain, relative to its own max|g|); then
    10 `sharded_hmc` iterations over `AmbientFullCovariance` on
    make_pod_mesh({'j': 1}): finite, 1 + 5 evaluations an iteration."""
    out = parallel_study.gpa(dev)
    within("distributed GPA vs FullCovariance, vmapped", (out["target_rel"],
                                                          out["gradient_rel"]), GPA_TOL)
    n = gpa_study.N
    want_hmc = 1 + 5 * parallel_study.HMC_ITERS
    cross = (f"gram cross {n}x{n}", f"gram_vjp cross {n}x{n}")
    if (out["launches"] != (1, 1) or out["by_shape"] != dict.fromkeys(cross, 1)
            or not out["hmc_finite"] or out["hmc_by_shape"] != dict.fromkeys(cross, want_hmc)):
        fail(f"distributed GPA: {out}")
    out["total_launches"] = tuple(a + b for a, b in zip(out["launches"], out["hmc_launches"]))
    return out


def phase_sharded_fitc(dev) -> dict:
    """Phase 29: configuration #4 through `fitc_mll_sharded_fn` on
    make_mesh({'data': 1}): the start's mll and gradient against the
    LowRankPD path's within `FITC_TOL`; 2 + N_SHARDED_FITC_STEPS Adam steps,
    exactly 2 + 2 launches a timed step, 1 + 1 of them at 512 x 100 000, a
    finite and falling loss."""
    out = parallel_study.fitc(dev, steps=N_SHARDED_FITC_STEPS)
    within("sharded FITC start vs LowRankPD", out["start_vs_lowrank"], FITC_TOL)
    k = N_SHARDED_FITC_STEPS
    if out["launches"] != (2 * k, 2 * k) or out["cross_launches"] != (k, k):
        fail(f"sharded FITC: launches {out['launches']} ({out['cross_launches']} at the cross "
             f"shape), expected 2 + 2 a step, 1 + 1 of them K(Xu, X)")
    losses = out["losses"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"sharded FITC: loss not finite or not falling: {losses}")
    return out


def phase_sharded_vi(dev) -> dict:
    """Phase 30: configuration #3 through `sharded_vi_train` (n = 4096, 150
    steps): its ELBO trace within `VI_TRACE_TOL` of the replicated Adam
    run's at every step, and rising; `sharded_vi` with 8 restarts: restart
    0's final ELBO that of vi(method="adam") within 1e-6; one gram launch
    (the prior's, n x n) each fit; `ring_gram` at n = 3000 equal to
    `kernel.gram` within 1e-5 sigma^2 (one launch, cross)."""
    out = parallel_study.vi(dev)
    n = out["n"]
    ok = (out["trace_vs_replicated"] <= VI_TRACE_TOL and out["trace_last"] > out["trace_first"]
          and out["restart0_vs_vi"] <= 1e-6 and out["ring_launches"] == (1, 0)
          and out["ring_by_shape"] == {"gram cross 3000x3000": 1}
          and out["train_by_shape"] == out["restarts_by_shape"] == {f"gram {n}x{n}": 1}
          and out["ring_vs_gram"] <= 1e-5)
    print(f"  sharded VI: trace gap {out['trace_vs_replicated']:.3e} (tol {VI_TRACE_TOL:g}), "
          f"restart 0 vs vi {out['restart0_vs_vi']:.3e} (tol 1e-6), ring_gram "
          f"{out['ring_vs_gram']:.3e} (tol 1e-5): {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"sharded VI: {out}")
    return out


def phase_compositions(dev) -> tuple:
    """Phase 31: `bench_study`'s ten compositions at n = 3000 (the micro
    suite's data: `RandomState(42)` drawn for n = 100, then n = 3000), f32 on
    the card against f64 on the card within `HEADLINE_BAR`; each evaluation
    launches the gram and the VJP kernel once for each stationary leaf.
    Every gram and VJP launch of each composition's f32 evaluation is kept
    (`captured_launches(every=True)`: two SE leaves share a shape) and
    replayed against the plain versions in f64
    (`check_captured`): Masked at d = 1 and 9, and the products' and sums'
    cotangents, are shapes and inputs no earlier phase holds the kernels
    at. Returns the launches of all ten and the kernels' largest
    differences."""
    rng = np.random.RandomState(bench_study.SEED)
    bench_study.bench_data(bench_study.MICRO_SIZES[0], rng)
    X64, y64 = bench_study.bench_data(N_HEAD, rng)
    data = {dt: tuple(torch.as_tensor(a, dtype=dt, device=dev) for a in (X64, y64))
            for dt in (torch.float32, torch.float64)}
    total, errs = [0, 0], {"gram": 0.0, "gram_vjp": 0.0}
    for name, kern in bench_study.compositions().items():
        p32 = bench_study.bench_params(kern, torch.float32, dev)
        with captured_launches(every=True) as seen:
            got, n = launches(lambda: bench_study.mll_and_grad(p32, *data[torch.float32]))
        if {key[0] for key in seen} != {"gram", "gram_vjp"}:
            fail(f"{name}: the evaluation's launches were not captured: {list(seen)}")
        for kernel, err in check_captured(name, seen).items():
            errs[kernel] = max(errs[kernel], err)
        del seen
        leaves = bench_study.LEAVES[name]
        print(f"  {name}: f32 mll {float(got[0]):.4f}, {n[0]} gram and {n[1]} gram_vjp "
              f"launches ({leaves} stationary leaves)")
        if n != (leaves, leaves):
            fail(f"{name}: {n} launches an evaluation, expected {leaves} of each")
        ref = bench_study.mll_and_grad(bench_study.bench_params(kern, torch.float64, dev),
                                       *data[torch.float64])
        within(f"{name} f32 vs f64 card", bench_study.gaps(got, ref), HEADLINE_BAR)
        total = [a + b for a, b in zip(total, n)]
    return tuple(total), errs


# phase 32's bars where graph and eager differ in bits: the headline's (value
# relative, gradient of max|g|), and for a sampler's states, targets and
# gradients the GPA target's f32 bar of phase 13 (relative to each
# output's largest magnitude); an accept decision must not change
GRAPH_BARS = {"headline": HEADLINE_BAR, "sampler": GPA_TOL, "vi": (VI_TRACE_TOL,),
              "elastic": ELASTIC_F32, "fitc": FITC_TOL}


def graph_gap(got, ref) -> float:
    """0 for equal bits, else max|got - ref| / max|ref|."""
    if torch.equal(got, ref):
        return 0.0
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def graph_pair(name, setup, bar, reps=10, phase=32):
    """One graph-against-eager pair of phase 32 (or `phase`). `setup()` makes
    fresh state and returns a zero-argument call whose result is a list of tensors; each
    way runs a call of its own setup once (outputs compared, launches
    counted from 0), then another setup's call is timed: CUDA-event ms,
    host enqueue ms and device-busy ms (torch.profiler; None where it saw
    no kernel). Equal bits, or the gap (`graph_gap`) of every output within
    `bar`[0], and the same launches each way."""
    row = {}
    for label, way in (("graph", lambda f: f), ("eager", eagerly)):
        out, n = launches(way(setup()))
        call = way(setup())
        busy, kernels, _ = device_profile(call, reps=3)
        row[label] = {"out": out, "launches": n, "event_ms": time_ms(call, reps=reps, warmup=2),
                      "enqueue_ms": enqueue_ms(call, reps=reps),
                      "busy_ms": busy if kernels else None}
    gaps = [graph_gap(a, b) for a, b in zip(row["graph"]["out"], row["eager"]["out"])]
    summary = {"bits": max(gaps) == 0.0, "gap": max(gaps),
               **{f"{k}_{label}": row[label][k] for label in row
                  for k in ("launches", "event_ms", "enqueue_ms", "busy_ms")}}
    print(f"  {name}, graph vs eager: "
          f"{'equal bits' if summary['bits'] else f'gap {max(gaps):.3e}'}; " + ", ".join(
              f"{label} {r['event_ms']:.4f} ms events, {r['enqueue_ms']:.4f} ms enqueue, "
              f"{r['busy_ms']} ms busy, launches {r['launches']}"
              for label, r in row.items()), flush=True)
    if row["graph"]["launches"] != row["eager"]["launches"] or max(gaps) > bar[0]:
        fail(f"phase {phase}: {name}: launches {row['graph']['launches']} against "
             f"{row['eager']['launches']}, or gap {gaps} over {bar[0]}")
    return summary, [row[label]["out"] for label in row]


def phase_graph_pairs(dev) -> tuple:
    """Phase 32's pairs for the later graphed paths, every launch of
    the block kept by `captured_launches` and held against the plain
    version: one `sharded_ess` iteration of configuration #5 (1024 chains;
    the same proposal counts each way) and one `ess_iteration` timed; one
    Adam step of configuration #3 (VI, n = 4096); one padded elastic append
    at n = 4032, capacity 4096; `logp_LOO` and `dlogp_LOO` on the headline
    (n = 3000); one FITC step of configuration #4 (N = 100 000). Returns
    ({pair: summary}, the largest absolute differences of the launches)."""
    out = {}
    with captured_launches() as seen:
        C = student_t_study.CHAINS
        loglik, xg0, _, _ = student_t_study.config5_gpe(dev).make_logprob(include_priors=False)
        starts = student_t_study.chain_starts(xg0, C, 2)
        mesh = gp.make_mesh()

        def sharded():
            return lambda: list(vars(chains.sharded_ess(
                loglik, starts, student_t_study.PRIOR_MU, student_t_study.PRIOR_SIGMA, 32, mesh,
                n_iter=1)).values())

        out["sharded_ess_iteration"], res = graph_pair(
            f"one sharded_ess iteration, configuration #5 ({C} chains)", sharded,
            GRAPH_BARS["sampler"])
        if not torch.equal(res[0][1], res[1][1]):
            fail("phase 32: the ESS's mean proposal count differs between graph and eager")
        ll_fn = ess_mod.batched_loglik(loglik)
        mu, sigma = (torch.tensor(v, dtype=starts.dtype, device=dev)
                     for v in (student_t_study.PRIOR_MU, student_t_study.PRIOR_SIGMA))
        ll0 = ess_mod._safe(ll_fn(starts))

        def one():
            return lambda: list(ess_mod.ess_iteration(
                ll_fn, starts, ll0, mu, sigma,
                hmc.RandomStream(torch.Generator(device=dev).manual_seed(33))))

        out["ess_iteration"], res = graph_pair(
            f"one ess_iteration, {C} chains, blocks of {ess_mod.SHRINK_BLOCK} rounds", one,
            GRAPH_BARS["sampler"])
        if not torch.equal(res[0][2], res[1][2]):
            fail("phase 32: the ESS's proposals differ between graph and eager")
        out["ess_iteration"]["max_proposals"] = int(res[0][2].max())

        m3 = vi_study.config3_model(dev)
        neg_elbo, theta0, _ = make_neg_elbo(m3)

        def vi_step():
            state = [adam_init(theta0)]

            def call():
                state[0], val = adam_step(neg_elbo, state[0], vi_study.LR)
                return [*state[0], val]
            return call

        out["vi_adam_step"], _ = graph_pair(
            f"one Adam step, configuration #3 (n = {vi_study.N})", vi_step, GRAPH_BARS["vi"])

        es = elastic_study
        X, y = es.data()
        grown = es.model(dev, torch.float32)
        for i in range(0, es.N - es.K, es.K):
            grown.append(X[i:i + es.K], y[i:i + es.K])
        n0 = grown.nobs

        def append():
            call = es.append_again(grown)
            return lambda: [call()]

        out["elastic_append"], _ = graph_pair(
            f"one elastic append at n = {n0}, capacity {grown.capacity}", append,
            GRAPH_BARS["elastic"][2:])

        rng = np.random.RandomState(42)
        Xh, yh = rng.randn(N_HEAD, D), rng.randn(N_HEAD)
        mh = gp.GPE(Xh.astype(np.float32), yh.astype(np.float32), gp.MeanZero(),
                    gp.SE(0.0, 0.0), lognoise=-1.0, device=dev)
        out["loo_pair"], _ = graph_pair(
            f"logp_LOO + dlogp_LOO, headline n = {N_HEAD}",
            lambda: lambda: [gp.logp_LOO(mh), gp.dlogp_LOO(mh)], GRAPH_BARS["headline"])

        model4 = fitc_study.config4_model(dev)

        def fitc_step():
            trainer = fitc_study.FitcAdam(model4)
            return lambda: [torch.tensor(trainer.step()), *trainer.state]

        out["fitc_step"], _ = graph_pair(
            f"one FITC step, configuration #4 (N = {fitc_study.N})", fitc_step,
            GRAPH_BARS["fitc"])
    errs = check_captured("phase 32", seen)
    del seen
    return out, errs


def phase_graphs(dev) -> dict:
    """Phase 32: the CUDA graphs (`utils/graphs.py`) against eager
    (inside `graphs.eager()`), in one process, each pair from the same
    inputs and draws:
      * the headline (SE, n = 3000, d = 10, f32): value and gradient, 1 + 1
        launches each way; CUDA-event ms, host enqueue ms and device-busy
        ms (torch.profiler) of each;
      * one HMC iteration of configuration #5 (1024 chains of the Student-t
        GPA, D = 63, Lmax 15, a diagonal M^-1): the new states, targets,
        gradients, accept probabilities and decisions, 15 + 15 launches
        each way; CUDA-event and enqueue ms of each;
      * one outer iteration of the split sampler at configuration #2 (128
        chains, a_iters 16): the draws, the final state and target, 17 + 16
        launches each way; enqueue, CUDA-event and busy ms of each
        (`gpa_study.one_iteration`).
    Each pair is equal bit for bit, or its gap (`graph_gap`) is within
    GRAPH_BARS and no accept decision differs. Then the pairs of
    `phase_graph_pairs` (the elliptical slice, VI's step, the elastic
    append, the LOO pair, FITC's step). Last, the headline's model
    captured anew and dropped: the memory its graph reserved goes back to
    the card with it (at most a tenth left)."""
    out = {}
    rng = np.random.RandomState(42)
    Xh, yh = rng.randn(N_HEAD, D), rng.randn(N_HEAD)
    m = gp.GPE(Xh.astype(np.float32), yh.astype(np.float32), gp.MeanZero(), gp.SE(0.0, 0.0),
               lognoise=-1.0, device=dev)
    ways = {"graph": lambda f: f, "eager": eagerly}
    row = {}
    for label, way in ways.items():
        call = way(m.target_and_dtarget)
        (t, g), n = launches(call)
        busy, kernels, _ = device_profile(call)
        row[label] = {"value": t, "grad": g, "launches": n, "event_ms": time_ms(call),
                      "enqueue_ms": enqueue_ms(call), "busy_ms": busy,
                      "kernels_seen": len(kernels)}
    gaps = (graph_gap(row["graph"]["value"], row["eager"]["value"]),
            graph_gap(row["graph"]["grad"], row["eager"]["grad"]))
    out["headline"] = summary = {
        "bits": gaps == (0.0, 0.0), "gap": gaps,
        **{f"{k}_{label}": row[label][k] for label in row
           for k in ("launches", "event_ms", "enqueue_ms", "busy_ms", "kernels_seen")}}
    print(f"  headline SE n={N_HEAD} f32, graph vs eager: "
          f"{'equal bits' if summary['bits'] else f'gap {gaps}'}; " + ", ".join(
              f"{label} {r['event_ms']:.4f} ms events, {r['enqueue_ms']:.4f} ms enqueue, "
              f"{r['busy_ms']:.4f} ms busy, launches {r['launches']}"
              for label, r in row.items()), flush=True)
    if any(r["launches"] != (1, 1) for r in row.values()) or not all(
            gap <= bar for gap, bar in zip(gaps, GRAPH_BARS["headline"])):
        fail(f"phase 32: the graphed headline's launches or gap {gaps}")

    gpa = student_t_study.config5_model(dev)
    logprob, x0, _, _ = gpa.make_logprob()
    theta = student_t_study.chain_starts(x0, student_t_study.CHAINS, 17)
    vg = batched_value_and_grad(logprob)
    t0, g0 = hmc.start(vg, theta)
    minv = torch.linspace(0.5, 1.5, theta.shape[1], dtype=theta.dtype, device=dev)
    eps = torch.tensor(student_t_study.EPS0, dtype=theta.dtype, device=dev)
    row = {}
    for label, way in ways.items():
        @way
        def call(seed=32):
            stream = hmc.RandomStream(torch.Generator(device=dev).manual_seed(seed))
            # L in 5..15: sharded_hmc's path lengths
            return hmc.hmc_iteration(vg, theta, t0, g0, stream, eps, 5, 15, minv)
        res, n = launches(call)
        row[label] = {"out": res, "launches": n, "event_ms": time_ms(call, reps=5),
                      "enqueue_ms": enqueue_ms(call, reps=5)}
    gaps = [graph_gap(a, b) for a, b in zip(row["graph"]["out"][:4], row["eager"]["out"][:4])]
    same_decisions = torch.equal(row["graph"]["out"][4], row["eager"]["out"][4])
    out["hmc_transition"] = summary = {
        "chains": student_t_study.CHAINS, "bits": max(gaps) == 0.0 and same_decisions,
        "gap": max(gaps), "same_decisions": same_decisions,
        **{f"{k}_{label}": row[label][k] for label in row
           for k in ("launches", "event_ms", "enqueue_ms")}}
    print(f"  one HMC iteration, configuration #5 ({student_t_study.CHAINS} chains), graph vs "
          f"eager: {'equal bits' if summary['bits'] else f'gap {max(gaps):.3e}'}, decisions "
          f"equal {same_decisions}; " + ", ".join(
              f"{label} {r['event_ms']:.4f} ms events, {r['enqueue_ms']:.4f} ms enqueue, "
              f"launches {r['launches']}" for label, r in row.items()), flush=True)
    if any(r["launches"] != (15, 15) for r in row.values()) or not same_decisions or \
            max(gaps) > GRAPH_BARS["sampler"][0]:
        fail(f"phase 32: the graphed HMC iteration's launches, decisions or gap {gaps}")

    m2 = gpa_study.config2_model(dev)
    row = {}
    for label, way in ways.items():
        gen = torch.Generator(device=dev).manual_seed(32)
        *target, a, b = gpa_study.chain_starts(m2, gpa_study.CHAINS, gen)
        res, n = launches(lambda: way(gpa_study.outer_iterations)(target, a, b, gen, 1))
        row[label] = {"out": (res.samples, res.final, res.final_target), "launches": n,
                      **{k: v for k, v in gpa_study.one_iteration(
                          dev, gpa_study.CHAINS, eager=label == "eager").items()
                         if k in ("enqueue_ms", "event_ms", "busy_ms")}}
    gaps = [graph_gap(a, b) for a, b in zip(row["graph"]["out"], row["eager"]["out"])]
    out["split_outer_iteration"] = summary = {
        "chains": gpa_study.CHAINS, "bits": max(gaps) == 0.0, "gap": max(gaps),
        **{f"{k}_{label}": row[label][k] for label in row
           for k in ("launches", "event_ms", "enqueue_ms", "busy_ms")}}
    same = "equal bits" if summary["bits"] else f"gap {max(gaps):.3e}"
    print(f"  one split outer iteration, configuration #2 ({gpa_study.CHAINS} chains), graph "
          f"vs eager: {same}; " + ", ".join(
              f"{label} {r['event_ms']:.2f} ms events, {r['enqueue_ms']:.2f} ms enqueue, "
              f"{r['busy_ms']:.2f} ms busy, launches {r['launches']}"
              for label, r in row.items()), flush=True)
    if any(r["launches"] != (17, 16) for r in row.values()) or \
            max(gaps) > GRAPH_BARS["sampler"][0]:
        fail(f"phase 32: the graphed split iteration's launches or gap {gaps}")

    pairs, out["max_abs_err"] = phase_graph_pairs(dev)
    out.update(pairs)

    # a model's graphs go with it, and the pool's memory with the last graph
    graphs.clear()
    base = torch.cuda.memory_reserved(dev)
    m = gp.GPE(Xh.astype(np.float32), yh.astype(np.float32), gp.MeanZero(), gp.SE(0.0, 0.0),
               lognoise=-1.0, device=dev)
    m.target_and_dtarget()
    held = torch.cuda.memory_reserved(dev) - base
    del m
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_reserved(dev) - base
    out["pool_release"] = {"held_bytes": held, "left_bytes": left}
    print(f"  a dropped model's graph: {held} bytes reserved with it, {left} after it",
          flush=True)
    if held <= 0 or left > 0.1 * held:
        fail(f"phase 32: a dropped model's graph left {left} of {held} bytes reserved")
    return out


def phase_leapfrog(dev) -> dict:
    """Phase 33: the fused leapfrog kernel against its plain version (and
    the graphed transition at configuration #2's shape) at each of
    `leapfrog_study.CASES`, a refused launch, and the times."""
    out = {}
    for name, dtype, C, n in leapfrog_study.CASES:
        res = leapfrog_study.compare(dev, dtype, C, n, graphed=C > 64)
        print(f"leapfrog {name} (C = {C}, n = {n}): {res}", flush=True)
        beyond = leapfrog_study.beyond_limits(res, dtype, C)
        if beyond:
            fail(f"phase 33: the leapfrog kernel at {name} beyond its limits: {beyond}")
        out[name] = res
    out["refused"] = leapfrog_study.refused(dev)
    out["times"] = leapfrog_study.times(dev)
    routes = out["times"]["a_transitions_by_route"]
    launches = out["times"]["launches_per_outer_iteration"]
    if routes != {"fused": gpa_study.A_ITERS, "graphed": 0} or launches != routes["fused"]:
        fail(f"phase 33: an outer iteration's A transitions by route {routes} and kernel "
             f"launches {launches}, not {gpa_study.A_ITERS} fused transitions of one launch each")
    print("leapfrog: " + json.dumps(out), flush=True)
    return out


QR_GAP = 4 * 2.0 ** -24  # phase 34: four float32 unit roundoffs


def phase_cholqr(dev) -> dict:
    """Phase 34: FITC's float32 QR route against `torch.linalg.qr` on
    configuration #4's stacked matrix (`qr_study.card_check`)."""
    out = qr_study.card_check(dev)
    route, lib = out["cholqr3"], out["library"]
    over = {k: route[k] for k in ("orth", "residual", "r_gap")
            if not route[k] < min(QR_GAP, lib[k])}
    if over or not route["ok"]:
        fail(f"phase 34: the float32 QR route's gaps {over} over {QR_GAP:.2e} or over the "
             f"library's {lib}, or its factors failed (ok {route['ok']})")
    fit, shape = out["fit"], f"{out['rows']} {out['cols']}"
    if fit["qr_routes"] != {f"cholqr3 {shape}": fit["qr_shapes"].get(f"qr {shape}")} or (
            fit["qr_shapes"].get(f"qr {shape}") != fit["evaluations"]):
        fail(f"phase 34: a fit's QRs by route {fit['qr_routes']} and by shape "
             f"{fit['qr_shapes']}, not one float32 route an evaluation ({fit['evaluations']})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    print(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    sources = (*cuda.SOURCES, "single_parts.cu")
    logs = cuda.build(sources)
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(sources)}")
    for src, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print(f"  {src}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                print(f"  {src}:   {line.strip()}")

    # 3. kernels against their plain versions
    print("phase 3: gram kernel vs plain version")
    worst32 = phase_kernel_vs_plain(dev)
    print("phase 3: gram_vjp kernel vs plain version")
    vjp_worst32, vjp_ratio = phase_vjp_vs_plain(dev)
    print("phase 3: both kernels' tile walks on small grids")
    phase_walks(dev)

    # 4. headline: BASELINE's mll + gradient, SE, n = 3000, d = 10
    rng = np.random.RandomState(42)
    Xh, yh = rng.randn(N_HEAD, D), rng.randn(N_HEAD)

    def headline(dtype, device):
        return gp.GPE(Xh.astype(dtype), yh.astype(dtype), gp.MeanZero(),
                      gp.SE(0.0, 0.0), lognoise=-1.0, device=device)

    m, main_launches = phase_model("headline SE", headline, 1)
    main_launches = list(main_launches)

    # 5. flagship composite at full width
    rng0 = np.random.RandomState(0)
    Xf, yf = rng0.randn(N_HEAD, D), np.sin(rng0.randn(N_HEAD))

    def flagship(dtype, device):
        kern = gp.SE(0.2, 0.1) + gp.RQ(0.1, 0.0, -0.2) * gp.Matern(1.5, 0.3, 0.0)
        return gp.GPE(Xf.astype(dtype), yf.astype(dtype), gp.MeanConst(beta=0.0),
                      kern, lognoise=-1.0, device=device)

    _, n_flag = phase_model("flagship SE+RQ*Mat32", flagship, 3)
    main_launches = [a + b for a, b in zip(main_launches, n_flag)]

    # 6. trainer
    t_start = float(m.target)
    res, n_opt = launches(lambda: m.optimize(maxiter=10))
    t_end = float(m.target)
    print(f"optimize(maxiter=10): target {t_start:.6f} -> {t_end:.6f}, "
          f"{res.n_iter} iterations, {n_opt[0]} gram and {n_opt[1]} gram_vjp launches, "
          f"{res.message}")
    if not (np.isfinite(t_end) and t_end >= t_start and min(n_opt) >= 1):
        fail("optimize: target not finite, lower than at the start, or no launches")
    main_launches = [a + b for a, b in zip(main_launches, n_opt)]

    # 7. prediction at new points: the cross gram
    Xs = np.random.RandomState(7).randn(500, D)
    (mu, var), n_pred = launches(lambda: m.predict_y(Xs.astype(np.float32)))
    print(f"predict_y at 500 points: {n_pred[0]} gram and {n_pred[1]} gram_vjp launches, "
          f"mean range [{float(mu.min()):.4f}, {float(mu.max()):.4f}], "
          f"min variance {float(var.min()):.4e}")
    if not (bool(torch.isfinite(mu).all()) and bool(torch.isfinite(var).all())
            and bool((var >= 0).all()) and n_pred == (2, 0)):
        fail("predict_y: non-finite values, negative variances or wrong launches")
    main_launches = [a + b for a, b in zip(main_launches, n_pred)]

    # 8. times
    print(f"phase 8: times (own device time from torch.profiler; calls: median of 20 "
          f"CUDA-event runs), card {card}")
    gram_rows = gram_study.forward(dev)
    vjp_rows = phase_vjp_times(dev)
    backward_rows = gram_study.backward(dev)
    # before phase 16's profile of a whole outer iteration: torch.profiler
    # saw no kernel in a later profile of the same process (PERF.md §6)
    batched_rows = gram_study.batched(dev)
    cross_rows = fitc_study.cross_gram(dev)  # configuration #4's cross gram
    new_rows = gram_study.new_shapes(dev)  # configuration #5's and the elastic append's
    dist_rows = parallel_study.gram_rows(dev)  # the distributed strategy's cross grams

    mh = headline(np.float32, None)
    total = time_ms(mh.target_and_dtarget)
    kern = mh.kernel
    K = add_diag(kern.gram(mh.x), torch.exp(2 * mh.lognoise))
    L = torch.linalg.cholesky_ex(K)[0]
    Linv = tri_inv_lower(L)
    parts = {
        "gram": time_ms(lambda: kern.gram(mh.x)),
        "cholesky": time_ms(lambda: torch.linalg.cholesky_ex(K)),
        "tri_inv_lower": time_ms(lambda: tri_inv_lower(L)),
        "tri_syrk_lower": time_ms(lambda: tri_syrk_lower(Linv)),
    }
    split = ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
    print(f"  headline target_and_dtarget f32 n={N_HEAD}: {total:.4f} ms; {split}")
    host_ms = enqueue_ms(mh.target_and_dtarget)
    busy_ms, top_kernels, top_ops = device_profile(mh.target_and_dtarget)
    print(f"  headline evaluation: host enqueue {host_ms:.4f} ms; device busy "
          f"{busy_ms:.4f} ms per call under torch.profiler, "
          f"{100 * busy_ms / total:.1f}% of its {total:.4f} ms CUDA-event time")
    for title, rows in (("kernels", top_kernels), ("operators", top_ops)):
        print(f"  {title} by self device time per call:")
        for key, ms, calls in rows:
            print(f"    {ms:9.4f} ms  {calls:3d} x {key[:90]}")

    # 9. the study's kernels against their plain versions
    print("phase 9: Cholesky study kernels vs plain versions")
    study_errs = phase_study_vs_plain(dev)

    # 10. the study's path at full size, with its launch counts
    print(f"phase 10: the study's path at n = {N_STUDY}")
    study_launches = phase_study_path(dev)

    # 11. the study's timings
    print(f"phase 11: study timings, card {card}")
    study_rows = phase_study_times(dev, card)

    # 12. the batched kernels against their plain versions
    t0 = time.perf_counter()
    print("phase 12: batched gram and gram_vjp kernels vs vmapped plain versions")
    batched_worst = phase_batched_vs_plain(dev)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # 13. the GPA target, batched over chains
    t0 = time.perf_counter()
    print("phase 13: configuration #2's GPA target on the card")
    n_gpa = phase_gpa_target(dev)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")

    # 14. the samplers at full width
    t0 = time.perf_counter()
    print("phase 14: the samplers at configuration #2's width")
    samplers = phase_samplers(dev)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")

    # 15. the classification anchor
    t0 = time.perf_counter()
    print("phase 15: the classification anchor")
    anchor = phase_classification(dev)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    sampler_launches = [n_gpa, *(row["launches"] for row in samplers.values()),
                        anchor["launches"]]
    main_launches = [sum(col) for col in zip(main_launches, *sampler_launches)]

    # 16. the GPA study, and the batched kernels' times
    t0 = time.perf_counter()
    print(f"phase 16: perf/gpa_study.py at configuration #2, card {card}")
    gpa = phase_gpa_study(dev)
    print("gpa_study: " + json.dumps(gpa))
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")

    # 17-23. the sparse models, VI, cross-validation, the on-device L-BFGS
    # and the anchors
    new_launches = []
    for label, fn in (
            ("17: FITC at N = 10 000", lambda: phase_fitc_10k(dev)),
            (f"18: configuration #4, FITC at N = 100 000, card {card}",
             lambda: phase_fitc_100k(dev)),
            ("19: FSA with batched block grams", lambda: phase_fsa(dev)),
            (f"20: configuration #3, Poisson VI at n = 4096, card {card}",
             lambda: phase_vi(dev)),
            ("21: cross-validation on the headline", lambda: phase_cv(dev)),
            ("22: optimize(method='optax') on the headline", lambda: phase_optax(dev)),
            ("23: the notebook anchors", lambda: phase_anchors(dev)),
            (f"24: configuration #5 at 1024 chains, card {card}", lambda: phase_config5(dev)),
            ("25: the elastic GP across three capacity crossings", lambda: phase_elastic(dev)),
            ("26: the adapters", lambda: phase_adapters(dev))):
        t0 = time.perf_counter()
        print(f"phase {label}", flush=True)
        new_launches.append(fn())
        print(f"phase {label.split(':')[0]}: {time.perf_counter() - t0:.1f} s", flush=True)
    (n_fitc10k, fitc, (n_fsa, fsa_errs), vi_out, n_cv, (n_optax, optax_out),
     (anchor_rows, n_anchors, anchor_errs), config5, elastic, n_adapters) = new_launches
    print("method='optax', graph against eager: " + json.dumps(optax_out))

    # 27-30. the distributed dense and sparse paths, every launch kept
    dist = {}
    for key, label, fn in (
            ("dense", f"27: the distributed dense GPE, card {card}", phase_dist_dense),
            ("gpa", "28: the distributed GPA under vmap", phase_dist_gpa),
            ("fitc", f"29: configuration #4 through fitc_mll_sharded_fn, card {card}",
             phase_sharded_fitc),
            ("vi", f"30: configuration #3 through sharded_vi_train, card {card}",
             phase_sharded_vi)):
        t0 = time.perf_counter()
        print(f"phase {label}", flush=True)
        with captured_launches() as seen:
            dist[key] = fn(dev)
        dist[key]["max_abs_err"] = check_captured(f"phase {label.split(':')[0]}", seen)
        del seen
        print(f"phase {label.split(':')[0]}: {time.perf_counter() - t0:.1f} s", flush=True)
    dist_shapes = dist_by_shape(dist)
    dist_launches = [sum(col) for col in zip(
        dist["dense"]["launches"], dist["gpa"]["total_launches"], dist["fitc"]["launches"],
        *(dist["vi"][k] for k in ("train_launches", "restarts_launches", "ring_launches")))]
    if [sum(v for k, v in dist_shapes.items() if k.split()[0] == name)
            for name in ("gram", "gram_vjp")] != dist_launches:
        fail(f"phases 27-30: launches by shape {dict(dist_shapes)} do not sum to {dist_launches}")
    print("distributed dense and sparse paths: " + json.dumps(dist))
    main_launches = [sum(col) for col in zip(
        main_launches, n_fitc10k, fitc["launches"], n_fsa, vi_out["fit_launches"],
        vi_out["objective_launches"], vi_out["predict_launches"], n_cv, n_optax, n_anchors,
        config5["launches"], elastic["launches"], n_adapters, dist_launches)]
    # 31. the kernel table's compositions
    t0 = time.perf_counter()
    print("phase 31: the BASELINE kernel table's ten compositions at n = 3000", flush=True)
    n_table, table_errs = phase_compositions(dev)
    print(f"phase 31: {time.perf_counter() - t0:.1f} s", flush=True)
    main_launches = [a + b for a, b in zip(main_launches, n_table)]
    # 32. the CUDA graphs against eager
    t0 = time.perf_counter()
    print(f"phase 32: the CUDA graphs against eager, card {card}", flush=True)
    graphed = phase_graphs(dev)
    print("graphs against eager: " + json.dumps(graphed))
    print(f"phase 32: {time.perf_counter() - t0:.1f} s", flush=True)
    # 33. the fused leapfrog
    t0 = time.perf_counter()
    print("phase 33: the fused leapfrog of split HMC's block A", flush=True)
    leap = phase_leapfrog(dev)
    print(f"phase 33: {time.perf_counter() - t0:.1f} s", flush=True)
    # 34. FITC's float32 QR
    t0 = time.perf_counter()
    print(f"phase 34: FITC's float32 QR at 100 512 x 512, card {card}", flush=True)
    qr = phase_cholqr(dev)
    print(f"phase 34: {time.perf_counter() - t0:.1f} s", flush=True)
    dist_errs = {k: max(dist[p]["max_abs_err"][k] for p in dist) for k in ("gram", "gram_vjp")}
    for errs in (fitc["max_abs_err"], fsa_errs, vi_out["max_abs_err"], anchor_errs,
                 config5["max_abs_err"], dist_errs, table_errs, graphed["max_abs_err"]):
        worst32 = max(worst32, errs["gram"])
        vjp_worst32 = max(vjp_worst32, errs["gram_vjp"])
    print("sparse, VI and anchors: " + json.dumps({"fitc_100k": fitc, "vi": vi_out,
                                                   "anchors": anchor_rows}))
    print("configuration #5 and the elastic GP: " + json.dumps({"config5": config5,
                                                               "elastic": elastic}))

    split_launches = samplers["split"]["launches"]
    config5_by_shape = tuple(sum(config5[k]["by_shape"].get(f"{name} 60x60", 0) for k in
                                 ("sharded_hmc", "sharded_split_hmc", "sharded_ess"))
                             for name in ("gram", "gram_vjp"))
    elastic_by_shape = elastic["launches_by_shape"]
    fwd, vjp = gram_rows[N_HEAD], vjp_rows["SE dp"]
    table = {"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "gaussianprocesses_jl_tpu_torch/csrc/gram.cu",
        "replaces": "gaussianprocesses_jl_tpu/ops/pallas_gram.py:63",
        "launches": main_launches[0],
        "max_abs_err": worst32,
        "ms": fwd["own_ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": None,
        "call_ms": fwd["call_ms"],
        "enqueue_ms": fwd["enqueue_ms"],
        "cdist_ms": fwd["cdist_ms"],
        "by_n": gram_rows,
        "batched": {**batched_rows["forward"], "max_abs_err": batched_worst["gram"],
                    "launches": split_launches[0], "launches_per_outer_iteration": 17},
        "cross_512x100000": {**cross_rows["gram"], "launches": fitc["cross_launches"][0],
                             "max_abs_err": fitc["max_abs_err"]["gram"]},
        "batched_1024x60x60": {**new_rows["config5 gram C=1024 n=60"],
                               "launches": config5_by_shape[0],
                               "max_abs_err": config5["max_abs_err"]["gram"]},
        "elastic_cross_4096x64": {**new_rows["elastic cross gram 4096x64"],
                                  "launches": elastic_by_shape["cross"]},
        "elastic_block_64x64": {**new_rows["elastic block gram 64x64"],
                                "launches": elastic_by_shape["block"]},
        **{f"distributed_{key}": {**dist_rows[name], "launches": dist_shapes[shape],
                                  "max_abs_err": dist_errs["gram"]}
           for key, name, shape in dist_table_rows("gram")},
    }, {
        "name": "gram_vjp",
        "route": "cuda",
        "source": "gaussianprocesses_jl_tpu_torch/csrc/gram.cu",
        "replaces": "gaussianprocesses_jl_tpu/ops/pallas_gram.py:142",
        "launches": main_launches[1],
        "max_abs_err": vjp_worst32,
        "max_err_over_tol": vjp_ratio,
        "ms": vjp["own_ms"],
        "plain_ms": vjp["plain_ms"],
        "bound_ms": vjp["bound_ms"],
        "bound_by": vjp["bound_by"],
        "library_ms": None,
        "call_ms": vjp["call_ms"],
        "enqueue_ms": vjp["enqueue_ms"],
        "by_case": vjp_rows,
        "backward_by_gram": backward_rows,
        "batched": {**batched_rows["gram_vjp"], "max_abs_err": batched_worst["gram_vjp"],
                    "max_err_over_tol": batched_worst["vjp_ratio"],
                    "launches": split_launches[1], "launches_per_outer_iteration": 16},
        "cross_512x100000": {**cross_rows["gram_vjp"],
                             "launches": fitc["cross_launches"][1],
                             "max_abs_err": fitc["max_abs_err"]["gram_vjp"]},
        "batched_1024x60x60": {**new_rows["config5 gram_vjp dp C=1024 n=60"],
                               "launches": config5_by_shape[1],
                               "max_abs_err": config5["max_abs_err"]["gram_vjp"]},
        **{f"distributed_{key}": {**dist_rows[name], "launches": dist_shapes[shape],
                                  "max_abs_err": dist_errs["gram_vjp"]}
           for key, name, shape in dist_table_rows("gram_vjp")},
    }]}
    study_src = {
        "se_gram_study": ("csrc/gram.cu", "perf/pallas_cholesky_study.py:102"),
        "chol_inv_panel": ("csrc/cholesky.cu", "perf/pallas_cholesky_study.py:164"),
        "launch_probe": ("csrc/cholesky.cu", "perf/pallas_cholesky_study.py:257"),
        "single_launch_cholesky": ("csrc/cholesky.cu", "perf/pallas_cholesky_study.py:352"),
    }
    leap_times = leap["times"]
    table["kernels"].append({
        "name": "leapfrog",
        "route": "cuda",
        "source": "gaussianprocesses_jl_tpu_torch/csrc/leapfrog.cu",
        "replaces": "none: the graphed hmc_transition of split HMC's block A",
        "launches": leap_times["launches_per_outer_iteration"],
        "max_gap": {name: leap[name]["plain"] for name, *_ in leapfrog_study.CASES},
        "ms": leap_times["kernel_ms"],
        "plain_ms": leap_times["plain_ms"],
        "bound_ms": leap_times["bound_ms"],
        "bound_by": leap_times["bound_by"],
        "library_ms": None,
        "graphed_iteration_ms": leap_times["graphed_iteration_ms"],
        "fused_iteration_ms": leap_times["fused_iteration_ms"],
    })
    for name, (src, replaces) in study_src.items():
        ms, pl, (b_ms, b_by), lib, extra = study_rows[name]
        table["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"gaussianprocesses_jl_tpu_torch/{src}",
            "replaces": replaces,
            "launches": study_launches[name],
            "max_abs_err": study_errs[name],
            "ms": ms,
            "plain_ms": pl,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib,
            **extra,
        })
    table["qr"] = qr
    print(json.dumps(table))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
