"""`optimize(method='optax')` on the card: optax's L-BFGS with its zoom line
search (`inference/lbfgs.py`) through its CUDA graphs and eagerly, and the
loop it replaced (PyTorch's own L-BFGS optimizer with a strong-Wolfe
search, driven from Python).

Run on a machine with one NVIDIA GPU:

    python -m gaussianprocesses_jl_tpu_torch.perf.lbfgs_study [--parent DIR]

Two models, each from its start, `ITERS` iterations a call:

  * the headline (SE, n = 3000, d = 10, f32, `RandomState(42)`, as
    chip_smoke.py's phase 22 builds it), 3 free parameters;
  * configuration #2's GPA (`gpa_study.config2_model`: BernLik, Matern 3/2
    ARD, n = 200, d = 5, f32), its 200 latents and 6 hyperparameters free.

For each model and each trial block R in `ROUNDS` (the line search's
trials a graph replay, one host read a block), graphed and eager
(`graphs.eager()`): ms an iteration by CUDA events (median of 5 calls after
one), host ms an iteration until the call returns (the host reads one flag
a block, so it waits for the card), device-busy ms an iteration
(torch.profiler; None where it saw no kernel), the evaluations, line-search
trials and host reads an iteration, the synchronizing calls an iteration
(`torch.cuda.set_sync_debug_mode`), the gram and gram_vjp launches (one
each an evaluation), and whether graphed and eager gave the same iterates
and trial counts (equal bits, or the largest relative gap). Then the same
through `model.optimize(method='optax', maxiter=ITERS)` at `lbfgs.TRIAL_BLOCK`
(the user's call: the parameters set back before each call), graphed and
eager, in a process of its own (`--loop-only`, run by this script with
the package's checkout first on the path).

With `--parent DIR`, DIR holding the package as it was before this loop (a
`git archive` of the earlier commit), the same `optimize` call's numbers
for that earlier loop, in a process of its own on the same card.
The last line is every number as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.perf import gpa_study
from gaussianprocesses_jl_tpu_torch.perf.gram_study import enqueue_ms, launches, time_ms
from gaussianprocesses_jl_tpu_torch.utils.profiling import card_line, device_profile

ITERS = 10
ROUNDS = (1, 2, 4)


def headline(dev):
    rng = np.random.RandomState(42)
    return gp.GPE(rng.randn(3000, 10).astype(np.float32), rng.randn(3000).astype(np.float32),
                  gp.MeanZero(), gp.SE(0.0, 0.0), lognoise=-1.0, device=dev)


MODELS = {"headline": headline, "config2": gpa_study.config2_model}


def syncs(fn) -> int:
    """The synchronizing CUDA calls (host reads) of one call of fn."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in seen)


def timed(call, iters: int) -> dict:
    """ms an iteration of `call` (which runs `iters` iterations) by CUDA
    events, host and device-busy, and its synchronizing calls an iteration."""
    row = {"event_ms": time_ms(call, reps=5, warmup=1) / iters,
           "host_ms": enqueue_ms(call, reps=5) / iters,
           "syncs": syncs(call) / iters}
    busy, kernels, _ = device_profile(call, reps=1)
    row["busy_ms"] = busy / iters if kernels else None
    return row


def optimize_row(model, way=lambda f: f) -> dict:
    """`model.optimize(method='optax', maxiter=ITERS)` from the model's
    start, through `way` (`eagerly`, or as it is): its evaluations,
    launches and times an iteration."""
    p0 = model.get_params().clone()

    def call():
        model.set_params(p0)
        return model.optimize(method="optax", maxiter=ITERS)

    call = way(call)
    res, n = launches(call)
    evals = int(res.message.split()[0])
    row = {"n_iter": res.n_iter, "evaluations": evals / res.n_iter, "launches": n,
           "launches_ok": n == (evals, evals), "target": -res.fun, **timed(call, res.n_iter)}
    model.set_params(p0)
    return row


def gap(a, b) -> float:
    """0 for equal bits, else max|a - b| / max|b|."""
    if torch.equal(a, b):
        return 0.0
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def sweep(model, rounds=ROUNDS) -> dict:
    """For each R: the graphed and the eager run of `ITERS` iterations, their
    numbers, and the gap between their iterates."""
    from gaussianprocesses_jl_tpu_torch.inference import lbfgs
    from gaussianprocesses_jl_tpu_torch.perf.gram_study import eagerly

    vg, x0, _, _ = model.make_objective()
    out = {}
    for R in rounds:
        runs = {}
        for label, way in (("graph", lambda f: f), ("eager", eagerly)):
            trace = []

            def call(trace=trace):
                trace.clear()
                return lbfgs.minimize(vg, x0, ITERS, rounds=R, trace=trace)

            call = way(call)
            res, n = launches(call)
            counts = [int(step.search.count) for _, step in trace]
            runs[label] = (res, list(trace), counts)
            out[f"R{R}_{label}"] = {
                "n_iter": res.n_iter, "evaluations": res.evaluations / res.n_iter,
                "trials": int(res.trials) / res.n_iter, "host_reads": res.host_reads / res.n_iter,
                "launches": n, "launches_ok": n == (res.evaluations, res.evaluations),
                "counts": counts, "value": float(res.value), **timed(call, res.n_iter)}
        (rg, tg, cg), (re, te, ce) = runs["graph"], runs["eager"]
        gaps = [gap(xg, xe) for (xg, _), (xe, _) in zip(tg, te)] + [gap(rg.x, re.x)]
        out[f"R{R}_graph"]["vs_eager"] = {"same_counts": cg == ce, "gap": max(gaps)}
    return out


def loop_numbers(dev) -> dict:
    """`optimize(method='optax')` on each model, as the package on the path
    runs it, through its graphs and eagerly."""
    from gaussianprocesses_jl_tpu_torch.perf.gram_study import eagerly

    out = {}
    for name, make in MODELS.items():
        model = make(dev)
        out[name] = optimize_row(model)
        out[f"{name}_eager"] = optimize_row(model, eagerly)
    return out


def process_numbers(root: str) -> dict:
    """`loop_numbers` of the package under `root`, in a process of its own
    (a fresh process for each package, so that the two are measured
    alike)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(root), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--loop-only"], env=env,
                         stdout=subprocess.PIPE, text=True, check=True)
    print(out.stdout, end="")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a directory holding the package before this loop")
    ap.add_argument("--loop-only", action="store_true",
                    help="only optimize(method='optax') of the package on the path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lbfgs_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if args.loop_only:
        print(json.dumps(loop_numbers(dev)))
        return 0
    print(f"card: {card_line()}", flush=True)
    out = {}
    for name, make in MODELS.items():
        out[f"{name}_sweep"] = rows = sweep(make(dev))
        for key, row in rows.items():
            print(f"{name} {key}: " + json.dumps(row), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for label, root in (("port", here), ("parent", args.parent)):
        if root:
            out[label] = process_numbers(root)
            print(f"{label} optimize(method='optax'): " + json.dumps(out[label]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
