"""The JAX repo's `bench.py` tables, run through the port on one NVIDIA GPU.

    python -m gaussianprocesses_jl_tpu_torch.perf.bench_study micro|table16k|cholesky|chains
        [--device cpu] [--chains C]

Four parts, one a call (each prints one JSON line a row, the card's name and
power limit first):

* `micro` (`bench.py::bench_kernel_micro`): the ten compositions of the
  BASELINE kernel table (`bench.py::kernels`, the same hyperparameters) at
  n = 100 and 3000, d = 10, f32, on `GPEParams(lognoise=-1, MeanZero)` under
  `FullCovariance`, the data `RandomState(42)` (X = randn(n, 10), y =
  randn(n), drawn for n = 100 and then n = 3000). Each row: the gram's ms,
  the mll + gradient's ms, its host enqueue and device-busy ms, the gram
  and gram_vjp launches of one evaluation (which must equal the
  composition's stationary leaves: products and sums launch once a leaf),
  and the value and gradient against f64 on the same device within the
  headline's bar (1e-3 relative, 2e-2 max|g|). A time is the median of 20
  calls between CUDA events; the JAX bench takes the min over trials of a
  scan-amortized evaluation, another statistic.
* `table16k` (`bench.py::bench_kernel_table_16k`): the same ten at n =
  16384 (a fresh `RandomState(42)`), mll + gradient, median of 10 calls,
  with the peak memory of one evaluation (the memory live before it
  printed beside it), each held against f64 on the card.
  A row passes within the bar, or as -inf with the factor's `ok` False,
  the f64 value printed beside it: the masked 1-D SE gram of 16384 points
  is singular beyond f32. A finite f32 value outside the bar fails the run.
* `cholesky` (`bench.py::bench_cholesky`): f32 factorization of W W^T + n I
  (W: n x 256, a torch generator seeded 0) at n = 10000 by `cholesky_ex`
  (the library route of `safe_cholesky`) and by `blocked_cholesky` at
  block 512 (the bench's, with a true-size last panel of 272) and 1000
  (which divides n), each held within 1e-4 of an f64 factor; TFLOP/s at
  n^3/3 operations; and a measured f32 GEMM anchor (m = 4096, TF32 off)
  with each factor's fraction of it, beside the nominal 67 TFLOP/s.
* `chains` (`bench.py::bench_gpa_chains_scaling`): configuration #2 through
  `perf/gpa_study.py` at `--chains` (16, 64, 256 or 1024) chains over the
  bench's 400 outer iterations (100 dropped as warm-up): ESS/s median and
  min, R-hat, accept rates, wall time.

Every check that fails exits non-zero. Nothing here runs on the CPU unless
`--device cpu` asks for it (then times are the host's and launches are not
counted: the plain versions launch nothing).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.models.covariance import FullCovariance
from gaussianprocesses_jl_tpu_torch.models.gpe import GPEParams, gpe_mll
from gaussianprocesses_jl_tpu_torch.ops.linalg import blocked_cholesky
from gaussianprocesses_jl_tpu_torch.perf import gpa_study
from gaussianprocesses_jl_tpu_torch.perf.gram_study import F32_FLOPS, enqueue_ms, launches, time_ms
from gaussianprocesses_jl_tpu_torch.utils.params import Param
from gaussianprocesses_jl_tpu_torch.utils.profiling import card_line, device_profile

__all__ = ["compositions", "LEAVES", "D", "SEED", "MICRO_SIZES", "N_16K", "HEADLINE_BAR",
           "bench_data", "bench_params", "mll_and_grad", "gaps", "micro", "table16k",
           "cholesky", "chains", "main"]

D, SEED = 10, 42
MICRO_SIZES = (100, 3000)
N_16K = 16384
HEADLINE_BAR = (1e-3, 2e-2)  # value relative, gradient over max|g|
REPS, REPS_16K = 20, 10
N_CHOL, W_RANK, GEMM_M = 10000, 256, 4096
CHOL_BLOCKS = (512, 1000)
CHOL_BLOCK_WHY = {512: "the bench's block; the last panel is factored at its true size, 272",
                  1000: "a block that divides n = 10000"}
STATISTIC = ("the median of {reps} calls (CUDA events on the card); bench.py takes the min over "
             "trials of an evaluation amortized inside one compiled scan")
CHOL_TOL = 1e-4  # max|L - L64| / max|L64|, the Cholesky study's limit
CHAIN_COUNTS = (16, 64, 256, 1024)

# stationary leaves of each composition: its gram and gram_vjp launches an
# evaluation
LEAVES = {"fix(se)": 1, "mask(se)": 1, "se": 1, "mat12": 1, "rq": 1, "se+rq": 2,
          "mask(se)+mask(rq)": 2, "se*rq": 2, "se+se2+rq": 3, "(se+se2)*rq": 3}


def compositions(d: int = D) -> dict:
    """`bench.py::kernels` in the port: {name: kernel}."""
    se = gp.SE(0.0, 0.0)
    se2 = gp.SE(0.5, 0.2)
    rq = gp.RQ(0.0, 0.0, 0.0)
    return {
        "fix(se)": gp.fix(gp.SE(0.0, 0.0), "lsigma"),
        "mask(se)": gp.Masked(gp.SE(0.0, 0.0), active_dims=(0,)),
        "se": se,
        "mat12": gp.Matern(0.5, 0.0, 0.0),
        "rq": rq,
        "se+rq": se + rq,
        "mask(se)+mask(rq)": gp.Masked(gp.SE(0.0, 0.0), (0,))
        + gp.Masked(gp.RQ(0.0, 0.0, 0.0), tuple(range(1, d))),
        "se*rq": se * rq,
        "se+se2+rq": se + se2 + rq,
        "(se+se2)*rq": (se + se2) * rq,
    }


def bench_data(n: int, rng: np.random.RandomState) -> tuple:
    """(X (n, D), y (n,)) as `bench.py` draws them, f64 numpy."""
    return rng.randn(n, D), rng.randn(n)


def bench_params(kern, dtype, device) -> GPEParams:
    """`bench.py::bench_one`'s parameters: lognoise -1, zero mean."""
    return GPEParams(lognoise=Param(value=torch.tensor(-1.0)), mean=gp.MeanZero(),
                     kernel=kern).to(dtype=dtype, device=device)


def mll_and_grad(params: GPEParams, X: torch.Tensor, y: torch.Tensor) -> tuple:
    """(mll, its gradient over the flat parameters) under `FullCovariance`."""
    vec = params.flat_params().detach().requires_grad_()
    mll = gpe_mll(params.with_flat_params(vec), X, y, FullCovariance())[0]
    (g,) = torch.autograd.grad(mll, vec)
    return mll.detach(), g


def factor_ok(params: GPEParams, X: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether K + noise factors (the flag the mll gates on)."""
    with torch.no_grad():
        return bool(FullCovariance().quad_logdet(params.kernel,
                                                 torch.exp(2.0 * params.lognoise.value), X,
                                                 y)[2])


def gaps(got: tuple, ref: tuple) -> tuple:
    """(|v - v_ref| / |v_ref|, max|g - g_ref| / max|g_ref|)."""
    (v, g), (v0, g0) = [(float(a), b.double().cpu()) for a, b in (got, ref)]
    return abs(v - v0) / abs(v0), float((g - g0).abs().max() / g0.abs().max())


def _fail(msg: str) -> None:
    print(f"bench_study: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def _emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def _time_ms(fn, device: torch.device, reps: int, warmup: int = 2) -> float:
    """Median ms of fn() over `reps` calls: between CUDA events on the card,
    by the host's clock on the CPU."""
    if device.type == "cuda":
        return time_ms(fn, reps=reps, warmup=warmup)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _counted(name: str, fn, device: torch.device) -> tuple:
    """(fn(), its (gram, gram_vjp) launches), which on the card must equal
    the composition's stationary leaves; None on the CPU."""
    out, n = launches(fn)
    if device.type != "cuda":
        return out, None
    if n != (LEAVES[name], LEAVES[name]):
        _fail(f"{name}: {n} gram and gram_vjp launches an evaluation, expected "
              f"{LEAVES[name]} of each")
    return out, n


def _within(what: str, gap: tuple) -> None:
    if not (gap[0] <= HEADLINE_BAR[0] and gap[1] <= HEADLINE_BAR[1]):
        _fail(f"{what}: f32 from f64 {gap}, beyond the bar {HEADLINE_BAR}")


def micro(device, sizes=MICRO_SIZES, reps=REPS) -> list:
    """The micro suite's rows at each n of `sizes`."""
    device = torch.device(device)
    rng = np.random.RandomState(SEED)
    rows = []
    for n in sizes:
        X64, y64 = bench_data(n, rng)
        X, y = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (X64, y64))
        Xd, yd = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in (X64, y64))
        for name, kern in compositions().items():
            params = bench_params(kern, torch.float32, device)
            k32 = params.kernel
            call = lambda: mll_and_grad(params, X, y)  # noqa: E731
            got, n_launch = _counted(name, call, device)
            ref = mll_and_grad(bench_params(kern, torch.float64, device), Xd, yd)
            gap = gaps(got, ref)
            _within(f"micro n={n} {name}", gap)
            busy = device_profile(call, reps=5)[0] if device.type == "cuda" else None
            rows.append(_emit({
                "part": "micro", "n": n, "name": name,
                "gram_ms": _time_ms(lambda: k32.gram(X), device, reps),
                "mll_grad_ms": _time_ms(call, device, reps),
                "enqueue_ms": enqueue_ms(call, reps) if device.type == "cuda" else None,
                "busy_ms": busy,
                "gram_launches": None if n_launch is None else n_launch[0],
                "gram_vjp_launches": None if n_launch is None else n_launch[1],
                "stationary_leaves": LEAVES[name], "mll": float(got[0]),
                "mll_f64": float(ref[0]), "value_gap": gap[0], "grad_gap": gap[1],
                "statistic": STATISTIC.format(reps=reps)}))
    return rows


def table16k(device, n=N_16K, reps=REPS_16K) -> list:
    """The kernel table's rows at n = 16384."""
    device = torch.device(device)
    X64, y64 = bench_data(n, np.random.RandomState(SEED))
    X, y = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (X64, y64))
    Xd, yd = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in (X64, y64))
    rows = []
    for name, kern in compositions().items():
        params = bench_params(kern, torch.float32, device)
        call = lambda: mll_and_grad(params, X, y)  # noqa: E731
        live = None
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated() / 2**20
        got, n_launch = _counted(name, call, device)
        peak = torch.cuda.max_memory_allocated() / 2**20 if device.type == "cuda" else None
        ms = _time_ms(call, device, reps, warmup=1)
        p64 = bench_params(kern, torch.float64, device)
        ref = mll_and_grad(p64, Xd, yd)
        ok = factor_ok(params, X, y)
        row = {"part": "table16k", "n": n, "name": name, "mll_grad_ms": ms,
               "peak_mib": peak, "live_before_mib": live,
               "gram_launches": None if n_launch is None else n_launch[0],
               "gram_vjp_launches": None if n_launch is None else n_launch[1],
               "stationary_leaves": LEAVES[name], "mll": float(got[0]), "ok": ok,
               "mll_f64": float(ref[0]), "ok_f64": factor_ok(p64, Xd, yd),
               "statistic": STATISTIC.format(reps=reps)}
        if float(got[0]) == -np.inf and not ok:
            row["verdict"] = "-inf: the f32 factor failed (f64 value beside it)"
        else:
            row["value_gap"], row["grad_gap"] = gap = gaps(got, ref)
            _within(f"table16k {name}", gap)
            row["verdict"] = "within the bar of f64"
        rows.append(_emit(row))
    return rows


def _chol_check(what: str, L: torch.Tensor, L64: torch.Tensor) -> float:
    err = float((L.double() - L64).abs().max() / L64.abs().max())
    if not err <= CHOL_TOL:
        _fail(f"{what}: max|L - L64| / max|L64| = {err:.3e}, beyond {CHOL_TOL}")
    return err


def cholesky(device, n=N_CHOL, reps=REPS) -> list:
    """The factorization rows and the GEMM anchor."""
    device = torch.device(device)
    if torch.backends.cuda.matmul.allow_tf32:
        _fail("TF32 is on; the anchor and the factors are f32")
    gen = torch.Generator(device=device).manual_seed(0)
    W = torch.randn((n, W_RANK), generator=gen, dtype=torch.float32, device=device)
    K = W @ W.T + n * torch.eye(n, dtype=torch.float32, device=device)
    L64 = torch.linalg.cholesky(K.double())
    flops = n**3 / 3.0
    routes = {"cholesky_ex": (lambda: torch.linalg.cholesky_ex(K)[0],
                              "the library route of safe_cholesky"),
              **{f"blocked_cholesky(block={b})": ((lambda b=b: blocked_cholesky(K, block=b)[0]),
                                                  CHOL_BLOCK_WHY.get(b, ""))
                 for b in CHOL_BLOCKS}}
    rows = []
    for name, (fn, why) in routes.items():
        err = _chol_check(name, fn(), L64)
        ms = _time_ms(fn, device, reps)
        rows.append({"part": "cholesky", "n": n, "name": name, "why": why, "ms": ms,
                     "tflops": flops / (ms * 1e-3) / 1e12, "max_rel_err_vs_f64": err,
                     "statistic": STATISTIC.format(reps=reps)})
    del L64
    A = torch.randn((GEMM_M, GEMM_M), generator=gen, dtype=torch.float32, device=device)
    gemm_ms = _time_ms(lambda: A @ A, device, reps)
    gemm = 2.0 * GEMM_M**3 / (gemm_ms * 1e-3) / 1e12
    for row in rows:
        row["frac_gemm_anchor"] = row["tflops"] / gemm
        row["frac_nominal"] = row["tflops"] / (F32_FLOPS / 1e12)
        _emit(row)
    rows.append(_emit({"part": "cholesky", "name": "gemm_anchor", "m": GEMM_M, "ms": gemm_ms,
                       "tflops": gemm, "tf32": torch.backends.cuda.matmul.allow_tf32,
                       "statistic": STATISTIC.format(reps=reps)}))
    rows.append(_emit({"part": "cholesky", "name": "nominal_f32_peak",
                       "tflops": F32_FLOPS / 1e12,
                       "gemm_anchor_over_nominal": gemm / (F32_FLOPS / 1e12)}))
    return rows


def chains(device, count: int) -> dict:
    """Configuration #2 at `count` chains over the bench's depth, through
    `gpa_study.run`."""
    r = gpa_study.run(torch.device(device), chains=count)
    if not r["draws_finite"]:
        _fail(f"{count} chains: non-finite draws")
    return _emit({"part": "chains", **r})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("part", choices=("micro", "table16k", "cholesky", "chains"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--chains", type=int, choices=CHAIN_COUNTS, default=16)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_study: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _emit({"part": args.part, "card": card_line() if device.type == "cuda" else "cpu",
           "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"})
    t0 = time.perf_counter()
    if args.part == "chains":
        chains(device, args.chains)
    else:
        {"micro": micro, "table16k": table16k, "cholesky": cholesky}[args.part](device)
    _emit({"part": args.part, "done": True, "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
