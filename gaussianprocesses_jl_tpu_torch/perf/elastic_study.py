"""The elastic GP grown by appends, its maintained factor against a fresh
GPE's (`chip_smoke.py` phase 25).

Run on a machine with one NVIDIA GPU:

    python -m gaussianprocesses_jl_tpu_torch.perf.elastic_study

(`--f32-gap` runs on the CPU: the f32 and f64 elastic models' distance from
a fresh f64 GPE, from which phase 25 takes its tolerances.)

The configuration: 4096 points in d = 10 (`RandomState(25)`, y = sin(x_1)
+ 0.1 noise), an SE ARD kernel (log length scales from -0.2 to 0.3),
lognoise -2, `capacity=1024`, `stepsize=1024`. The points arrive in blocks
of k = 64, so the capacity is crossed after 1024, 2048 and 3072 points
(each crossing re-pads and rebuilds the factor; every other append extends
it by K(X, x_new) at n x 64 and K(x_new) at 64 x 64). At n = 1024, 2048,
3072 and 4096 the maintained factor's mll, alpha and factor are held
against a fresh f64 GPE on the CPU. Each append is timed by CUDA events
and its gram launches are counted; one full refit at n = 1024 and 4096 is
timed beside it. Last, the append at n = 4032 (capacity 4096) again and
again from the same factor (`append_again`), through its CUDA graph and
eager: CUDA-event, host enqueue and device-busy ms.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.models.elastic import ElasticGPE
from gaussianprocesses_jl_tpu_torch.models.gpe import gpe_factorize
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op

__all__ = ["data", "model", "reference", "gaps", "run", "append_again", "append_times",
           "f32_gap", "main"]

N, D, K, CAPACITY, STEPSIZE = 4096, 10, 64, 1024, 1024
LL = np.linspace(-0.2, 0.3, D)
CHECK_AT = (1024, 2048, 3072, 4096)  # the crossings and the end


def data(n=N):
    rng = np.random.RandomState(25)
    X = rng.randn(n, D)
    return X, np.sin(X[:, 0]) + 0.1 * rng.randn(n)


def model(device, dtype) -> ElasticGPE:
    return ElasticGPE(D, kernel=gp.SE(LL, 0.0), lognoise=-2.0, capacity=CAPACITY,
                      stepsize=STEPSIZE, device=device, dtype=dtype)


def reference(n) -> tuple:
    """(mll, alpha, L) of a fresh f64 GPE on the CPU over the first n points."""
    X, y = data()
    m = gp.GPE(X[:n], y[:n], gp.MeanZero(), gp.SE(LL, 0.0), lognoise=-2.0, device="cpu")
    with torch.no_grad():
        pd = gpe_factorize(m.params, m.x, m.covstrat)
        return float(m.mll), pd.solve(m.y), pd.L


def gaps(m: ElasticGPE, ref) -> list:
    """[mll relative, alpha / max|alpha|, L / max|L|]: the maintained
    factor's distance from the reference's."""
    mll, alpha, L = ref
    a = m.alpha.double().cpu()
    f = m.chol.double().cpu()
    return [abs(float(m.mll) - mll) / abs(mll),
            float((a - alpha).abs().max() / alpha.abs().max()),
            float((f - L).abs().max() / L.abs().max())]


def run(device, dtype, refs=None) -> dict:
    """Grow the model over the N points in blocks of K: each append's ms
    (CUDA events on the card) and its (gram, gram_vjp) launches, and the
    gaps at CHECK_AT (refs: {n: reference(n)}, made here if not given)."""
    X, y = data()
    m = model(device, dtype)
    cuda = torch.device(device).type == "cuda"
    refs = {} if refs is None else refs
    appends, checked = [], {}
    for i in range(0, N, K):
        cap = m.capacity
        before = dict(gram_op.LAUNCHES)
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        m.append(X[i:i + K], y[i:i + K])
        ms = None
        if cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        appends.append({"n": i, "ms": ms, "crossing": m.capacity != cap,
                        "launches": tuple(gram_op.LAUNCHES[k] - before[k]
                                          for k in ("gram", "gram_vjp"))})
        if m.nobs in CHECK_AT:
            if m.nobs not in refs:
                refs[m.nobs] = reference(m.nobs)
            checked[m.nobs] = gaps(m, refs[m.nobs])
    return {"model": m, "appends": appends, "gaps": checked, "capacity": m.capacity}


def refit_ms(m: ElasticGPE, n) -> float:
    """One full refit (gram and Cholesky) of the model's first n points,
    CUDA events, the median of 5 after one."""
    keep = m._n
    m._n = n
    try:
        times = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            m._rebuild()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    finally:
        m._n = keep
        m._rebuild()
    return statistics.median(times[1:])


def append_again(grown: ElasticGPE):
    """A call that appends the next K points to a model grown to n (< N),
    each time from the grown model's factor: a fresh model on the same
    buffers, its count and factor set back before each append (an append
    makes a new factor and writes the same rows of X and y)."""
    X, y = data()
    n0, L0 = grown.nobs, grown._L
    m = model(grown.device, grown.dtype)
    m.capacity, m._X, m._y = grown.capacity, grown._X.clone(), grown._y.clone()

    def call():
        m._n, m._L, m._fresh = n0, L0, True
        m.append(X[n0:n0 + K], y[n0:n0 + K])
        return m._L

    return call


def append_times(grown: ElasticGPE) -> dict:
    """The append at the grown model's n through its CUDA graph and eager:
    CUDA-event ms (median of 20), host enqueue ms and device-busy ms."""
    from gaussianprocesses_jl_tpu_torch.perf.gram_study import eagerly, enqueue_ms, time_ms
    from gaussianprocesses_jl_tpu_torch.utils.profiling import device_profile

    out = {"n": grown.nobs, "capacity": grown.capacity}
    for label, way in (("graph", lambda f: f), ("eager", eagerly)):
        call = way(append_again(grown))
        busy, kernels, _ = device_profile(call, reps=3)
        out[label] = {"event_ms": time_ms(call), "enqueue_ms": enqueue_ms(call),
                      "busy_ms": busy if kernels else None}
    print(f"append at n = {out['n']}, capacity {out['capacity']}: " + ", ".join(
        f"{k} {v['event_ms']:.4f} ms events, {v['enqueue_ms']:.4f} ms enqueue, "
        f"{v['busy_ms']} ms busy" for k, v in out.items() if k in ("graph", "eager")),
        flush=True)
    return out


def f32_gap() -> dict:
    """On the CPU: the f32 and the f64 elastic model's gaps from a fresh f64
    GPE at CHECK_AT (the f32 model's gram, above the plain version's size
    budget, by the expansion of r2; the card's kernel takes direct
    differences)."""
    refs = {}
    out = {}
    for dtype in (torch.float64, torch.float32):
        rows = run("cpu", dtype, refs)["gaps"]
        out[str(dtype)[6:]] = rows
        for n, g in rows.items():
            print(f"{str(dtype)[6:]} n={n}: mll {g[0]:.2e} relative, alpha {g[1]:.2e} of max, "
                  f"factor {g[2]:.2e} of max", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--f32-gap", action="store_true",
                        help="only the models' distance from f64, on the CPU")
    args = parser.parse_args(argv)
    if args.f32_gap:
        f32_gap()
        return 0
    if not torch.cuda.is_available():
        print("elastic_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    out = run(dev, torch.float32)
    ms = {a["n"]: a["ms"] for a in out["appends"]}
    grown = out["model"]
    grown._n = N - K  # the last append's start, its factor rebuilt
    grown._rebuild()
    result = {"gaps": out["gaps"], **{f"append_ms_at_{n}": ms[n] for n in (CAPACITY - K, N - K)},
              **{f"refit_ms_{n}": refit_ms(out["model"], n) for n in (CAPACITY, N)},
              "append_at_4032": append_times(grown)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
