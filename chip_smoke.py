"""Drive the PyTorch port's main path on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
device and the CUDA toolkit (nvcc); it builds the port's kernels from the
sources in the checkout at first use.

Phases, each of which exits non-zero on the first failure:
  1. the card: name and power limit (nvidia-smi), TF32 settings (both off);
  2. build every kernel (all nvcc processes at once), with ptxas's report;
  3. the gram kernel against its plain version on the card: every profile
     family, iso and ARD, symmetric and cross, f32 and f64, n = 300 and
     3000, d = 10;
  4. the headline main path: GPE target and gradient, SE, n = 3000, d = 10,
     f32 on the card, against the same model in f64 on the CPU (plain path)
     and in f64 on the card;
  5. the flagship composite SE + RQ*Matern32 with MeanConst at n = 3000;
  6. a few L-BFGS-B steps (`optimize(maxiter=10)`) on the headline model;
  7. prediction at 500 new points (the cross-gram path);
  8. times from CUDA events: the gram kernel beside its bound, its plain
     version and torch.cdist, and the headline evaluation split into its
     parts; the host's enqueue time of one evaluation; then five headline
     evaluations under torch.profiler (device time by kernel and by
     operator, and the device-busy share);
  9. the Cholesky study's kernels (csrc/cholesky.cu) and its SE gram against
     their plain versions on the card: the launch probe exactly, the study
     gram within f32 rounding, the panel (one cooperative launch over the
     card) at B = 256, 512, 1024 and on an indefinite panel (NaN where the
     plain version has it, no hang), the single launch at n = 2048 (and
     against an f64 factorization);
 10. the study's path at full size: the study gram (n = 3072), the probe,
     `cholesky_blocked_panels` at n = 10240, block = 1024 (10 panel
     launches) and the single launch at n = 10240 (1 launch), both against
     f32 `torch.linalg.cholesky_ex`;
 11. the study's timings (perf/cholesky_study.py, whose experiments check
     every size they time: the study gram up to n = 16384, the panel at
     B = 3072 on the headline's SE gram against its plain version and f64;
     the panel also on the largest cooperative grid, and the fit of its
     times to a per-step cost and a product rate), the plain versions'
     times, and the single launch at n = 10240 against its plain version.
The kernel launch counts are set to 0 before each main-path call and read
after it. The last three lines are the kernel table (JSON), the card, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.ops import cholesky_kernels as chol_op
from gaussianprocesses_jl_tpu_torch.ops import cuda, gram as gram_op
from gaussianprocesses_jl_tpu_torch.ops.linalg import (
    add_diag,
    tri_inv_lower,
    tri_syrk_lower,
)
from gaussianprocesses_jl_tpu_torch.perf import cholesky_study as study
from gaussianprocesses_jl_tpu_torch.utils.profiling import device_ms_by_name

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores
F64_FLOPS = 34e12

N_HEAD, D = 3000, 10


def fail(msg):
    raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def launches(fn):
    """(result, gram launches) of one main-path call, counted from 0."""
    gram_op.LAUNCHES["gram"] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, gram_op.LAUNCHES["gram"]


def time_ms(fn, reps=20, warmup=3) -> float:
    """Median milliseconds of fn() over `reps` runs, each between two CUDA
    events, after `warmup` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def enqueue_ms(fn, reps=20) -> float:
    """Median host milliseconds for fn() to return, without waiting for the
    card: near the CUDA-event time, the call is bound by the host."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def device_profile(fn, reps=5, top=10):
    """`reps` calls of fn under torch.profiler: (device-busy ms per call, the
    `top` device kernels and the `top` operators by self device time per
    call, each as (name, ms, calls)). Busy time sums the kernels alone: an
    operator's self device time is its kernels' time counted again."""
    kernels, ops = device_ms_by_name(fn, reps=reps)

    def ranked(rows):
        rows = sorted(rows.items(), key=lambda kv: -kv[1][0])
        return [(key, ms, int(calls)) for key, (ms, calls) in rows[:top]]

    busy_ms = sum(ms for ms, _ in kernels.values())
    return busy_ms, ranked(kernels), ranked(ops)


def gram_bound_ms(n1, n2, d, itemsize, sym):
    """Least time for one gram: inputs read once and the output written
    once at the memory rate, or ~3d + 4 operations per output at the
    non-tensor rate, whichever is larger."""
    nbytes = itemsize * (n1 * d + (0 if sym else n2 * d) + 3 + n1 * n2)
    ops = n1 * n2 * (3 * d + 4)
    peak = F32_FLOPS if itemsize == 4 else F64_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
                    d0 = float(k._r2profile(torch.zeros((), dtype=dtype, device=dev)))
                    if sym and float((K.diagonal() - d0).abs().max()) > tol * sig2:
                        fail(f"gram kernel diagonal is not profile(0): {name}")
                    if dtype == torch.float32:
                        worst32 = max(worst32, err)
    return worst32


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
    print(f"{name}: f32 card target {float(t):.6f}, {n_launch} gram launches")
    if n_launch != expect_launches:
        fail(f"{name}: expected {expect_launches} gram launches, got {n_launch}")
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
    gram_op.LAUNCHES["gram"] = 0
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
    L = chol_op.single_launch_cholesky(Ks, B=256, R=512)
    if not torch.equal(Ks, Ks_before):
        fail("single_launch_cholesky changed its input")
    if not bool((torch.triu(L, 1) == 0).all()):
        fail("single_launch_cholesky: nonzero above the diagonal")
    errs["single_launch_cholesky"] = check_rel(
        "single launch n=2048 vs plain", L,
        chol_op.single_launch_cholesky_plain(Ks, B=256, R=512), 1e-5)
    check_rel("single launch n=2048 vs f64 cholesky_ex", L,
              torch.linalg.cholesky_ex(Ks.double())[0], 1e-4)
    return errs


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
    probe_bytes_ms = bound(2 * 8 * 128 * 4, 0)[0]
    probe_bound = ((chain_ms[512], "operations") if chain_ms[512] >= probe_bytes_ms
                   else (probe_bytes_ms, "bytes"))
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
                         {"call_ms": probe[512][0],
                          "call_ms_by_n_iter": {n: v[0] for n, v in probe.items()},
                          "ms_by_n_iter": {n: v[1] for n, v in probe.items()},
                          "enqueue_ms": probe_enqueue_ms}),
        "single_launch_cholesky": (single["single"], plain["single_launch_cholesky"],
                                   bound(8 * n * n, n**3 / 3), full["cholesky_ex"],
                                   {"full_ms": full}),
    }
    for name, (ms, pl, (b_ms, b_by), lib, _) in rows.items():
        lib_s = "none" if lib is None else f"{lib:.4f} ms"
        print(f"  {name}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"plain {pl:.4f} ms, library {lib_s}")
    return rows


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
    logs = cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(cuda.SOURCES)}")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # 3. kernel against its plain version
    print("phase 3: gram kernel vs plain version")
    worst32 = phase_kernel_vs_plain(dev)

    # 4. headline: BASELINE's mll + gradient, SE, n = 3000, d = 10
    rng = np.random.RandomState(42)
    Xh, yh = rng.randn(N_HEAD, D), rng.randn(N_HEAD)

    def headline(dtype, device):
        return gp.GPE(Xh.astype(dtype), yh.astype(dtype), gp.MeanZero(),
                      gp.SE(0.0, 0.0), lognoise=-1.0, device=device)

    m, main_launches = phase_model("headline SE", headline, 1)

    # 5. flagship composite at full width
    rng0 = np.random.RandomState(0)
    Xf, yf = rng0.randn(N_HEAD, D), np.sin(rng0.randn(N_HEAD))

    def flagship(dtype, device):
        kern = gp.SE(0.2, 0.1) + gp.RQ(0.1, 0.0, -0.2) * gp.Matern(1.5, 0.3, 0.0)
        return gp.GPE(Xf.astype(dtype), yf.astype(dtype), gp.MeanConst(beta=0.0),
                      kern, lognoise=-1.0, device=device)

    _, n_flag = phase_model("flagship SE+RQ*Mat32", flagship, 3)
    main_launches += n_flag

    # 6. trainer
    t_start = float(m.target)
    res, n_opt = launches(lambda: m.optimize(maxiter=10))
    t_end = float(m.target)
    print(f"optimize(maxiter=10): target {t_start:.6f} -> {t_end:.6f}, "
          f"{res.n_iter} iterations, {n_opt} gram launches, {res.message}")
    if not (np.isfinite(t_end) and t_end >= t_start and n_opt >= 1):
        fail("optimize: target not finite, lower than at the start, or no launches")
    main_launches += n_opt

    # 7. prediction at new points: the cross gram
    Xs = np.random.RandomState(7).randn(500, D)
    (mu, var), n_pred = launches(lambda: m.predict_y(Xs.astype(np.float32)))
    print(f"predict_y at 500 points: {n_pred} gram launches, "
          f"mean range [{float(mu.min()):.4f}, {float(mu.max()):.4f}], "
          f"min variance {float(var.min()):.4e}")
    if not (bool(torch.isfinite(mu).all()) and bool(torch.isfinite(var).all())
            and bool((var >= 0).all()) and n_pred == 2):
        fail("predict_y: non-finite values, negative variances or wrong launches")
    main_launches += n_pred

    # 8. times
    print(f"phase 8: times (median of 20 CUDA-event runs), card {card}")
    gram_rows = {}
    for n in (N_HEAD, 16384):
        X = torch.as_tensor(np.random.RandomState(3).randn(n, D),
                            dtype=torch.float32, device=dev)
        k = gp.SE(0.0, 0.0).to(dtype=torch.float32, device=dev)
        p = k._gram_params()
        kern_ms = time_ms(lambda: gram_op.launch_gram(gram_op.SE, p, X))
        plain_ms = time_ms(lambda: gram_op.gram_plain(gram_op.SE, p, X))
        cdist_ms = time_ms(lambda: torch.cdist(X, X))
        bound_ms, bound_by = gram_bound_ms(n, n, D, 4, True)
        gram_rows[n] = (kern_ms, plain_ms, cdist_ms, bound_ms, bound_by)
        print(f"  gram SE f32 n={n} d={D}: kernel {kern_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), "
              f"plain {plain_ms:.4f} ms, torch.cdist {cdist_ms:.4f} ms")

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

    kern_ms, plain_ms, cdist_ms, bound_ms, bound_by = gram_rows[N_HEAD]
    table = {"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "gaussianprocesses_jl_tpu_torch/csrc/gram.cu",
        "replaces": "gaussianprocesses_jl_tpu/ops/pallas_gram.py:63",
        "launches": main_launches,
        "max_abs_err": worst32,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "cdist_ms": cdist_ms,
    }]}
    study_src = {
        "se_gram_study": ("csrc/gram.cu", "perf/pallas_cholesky_study.py:102"),
        "chol_inv_panel": ("csrc/cholesky.cu", "perf/pallas_cholesky_study.py:164"),
        "launch_probe": ("csrc/cholesky.cu", "perf/pallas_cholesky_study.py:257"),
        "single_launch_cholesky": ("csrc/cholesky.cu", "perf/pallas_cholesky_study.py:352"),
    }
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
    print(json.dumps(table))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
