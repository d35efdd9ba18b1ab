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
     operator, and the device-busy share).
The kernel launch counts are set to 0 before each main-path call and read
after it. The last three lines are the kernel table (JSON), the card, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.ops import cuda, gram as gram_op
from gaussianprocesses_jl_tpu_torch.ops.linalg import (
    add_diag,
    tri_inv_lower,
    tri_syrk_lower,
)

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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    ops = [e for e in rows if e.device_type != DeviceType.CUDA]

    def ranked(events):
        events = sorted(events, key=lambda e: -e.self_device_time_total)
        return [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
                for e in events[:top]]

    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
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
    print(json.dumps(table))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
