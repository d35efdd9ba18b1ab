"""Traffic kind "fit": closed-loop multi-start fitting.

One caller fits the configuration's model again and again, each restart
the optimizer for `maxiter` iterations from a start: latents `latent_std`
standard normals, hyperparameters uniform in `hyper`. The restarts take
the `pool` starts that `pool_seed` draws, every one once in each run of
`pool` restarts, in an order drawn from the run's seed, and the window
ends with the first such run that ends after `--seconds`: every seed does
the same work. The configuration's data set (`data_seed`) serves the
whole run. Set-up makes the data and the model, then runs
`warmup_restarts` restarts of `maxiter` iterations from starts drawn from
the run's seed: they build the kernels and capture the optimizer's
graphs.

End to end: the metric the mix names under "metric" (`fit_iters_per_s`,
`map_iters_per_s`): the optimizer iterations completed in the window over
the window's seconds.

Correct: every restart of the window hands the loop's iterates x_k, as
the timed call runs them, to the window; it keeps those of
`check_restarts` restarts drawn from the seed (a reservoir over the whole
window) and of the last one. The reference (float64, its own L-BFGS)
follows each kept restart from its own state, one iteration at a time
(`reference/lbfgs.py::follow`): at x_k, the direction from the memory of
the restart's last ten pairs, against the restart's step x_k+1 - x_k. A
free-running float64 search parts from the float32 one by rounding
within tens of iterations, so the reference does not run on from its
own steps. Iterations whose reference gradient is under GTOL of the
start's are left out: there the float32 gradient is rounding.
`lbfgs_dir_gap` is the largest angle gap |s_k/|s_k| - d_k/|d_k|| over
the kept iterations; `lbfgs_rise`, over every step of the kept restarts,
the tail's too, the largest rise of the reference's value from one
iterate to the next over the restart's whole descent (so an end point
moved off the path shows). The mix's `limits` name the numbers that its
cell compares: those that the control fails. A window's restart that
raised or ended at a non-finite point counts in `failed`.
"""
from __future__ import annotations

import math
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from gpbench.reference import lbfgs as ref_lbfgs

__all__ = ["setup", "window", "end_to_end", "check", "starts", "data", "follow_gaps", "spread"]

# the share of the start's gradient under which an iteration is not compared: below it the
# float32 gradient of the headline fit is rounding (at 1e-3 the program's directions read 2.3e-3)
GTOL = 1e-2


def starts(cfg: dict, traffic: dict, count: int, gen: torch.Generator) -> torch.Tensor:
    """`count` start vectors (count, latents + hyperparameters), float32 on
    the generator's device."""
    lay, st = cfg["layout"], traffic["start"]
    lo, hi = st["hyper"]
    hyper = lo + (hi - lo) * torch.rand((count, lay["hyper"]), generator=gen, device=gen.device)
    if lay["latent"] == 0:
        return hyper
    latent = st["latent_std"] * torch.randn((count, lay["latent"]), generator=gen,
                                            device=gen.device)
    return torch.cat([latent, hyper], 1)


def _n(cell) -> int:
    return cell.traffic.get("n", cell.config.get("n"))


def data(cell):
    """The configuration's data set, the same in every run."""
    gen = torch.Generator(device=cell.device).manual_seed(cell.config["data_seed"])
    return cell.builder.make_data(cell.config, _n(cell), gen)


def _order(cell):
    """The pool's indices, every one once in each run of `pool`, in an order
    drawn from the seed."""
    rng = np.random.default_rng(cell.seed)
    while True:
        yield from rng.permutation(cell.traffic["pool"]).tolist()


def setup(cell):
    cfg, tr = cell.config, cell.traffic
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        if cell.device.type == "cuda":
            torch.cuda.synchronize(cell.device)
        parts[name], t = round(time.perf_counter() - t, 4), time.perf_counter()

    gen = torch.Generator(device=cell.device).manual_seed(cell.seed)
    X, y = data(cell)
    program = cell.make_program(cfg, X, y)
    pool = starts(cfg, tr, tr["pool"],
                  torch.Generator(device=cell.device).manual_seed(tr["pool_seed"]))
    lap("data_s")
    for x0 in starts(cfg, tr, tr["warmup_restarts"], gen):
        program.fit(x0, tr["maxiter"])
    lap("warmup_s")
    return SimpleNamespace(X=X, y=y, pool=pool, program=program, setup_parts=parts)


def window(cell, state, tracer):
    tr = cell.traffic
    failed, iterations, evaluations, cycle_s = 0, 0, 0, []
    kept, last, rng = [], None, np.random.default_rng([cell.seed, 2])
    t0 = tc = time.perf_counter()
    for r, i in enumerate(_order(cell)):
        x0, xs = state.pool[i], []
        traced = tracer.begin()
        try:
            with torch.profiler.record_function("gpbench.fit.restart"):
                x, n_iter, evals = state.program.fit(x0, tr["maxiter"], xs)
        except Exception:  # a restart that raised is a failed request; the loop goes on
            traceback.print_exc()
            x, n_iter, evals = None, 0, 0
        if x is None or not bool(torch.isfinite(x).all()):
            failed += 1
        else:  # the restart's iterates x_0 ... x_m, in a seeded reservoir and as the last
            last = (r, xs + [x])
            if len(kept) < tr["check_restarts"]:
                kept.append(last)
            elif (j := rng.integers(r + 1)) < tr["check_restarts"]:
                kept[j] = last
        if traced:
            tracer.end({"iterations": n_iter, "evaluations": evals})
        iterations, evaluations = iterations + n_iter, evaluations + evals
        if (r + 1) % tr["pool"]:
            continue
        now = time.perf_counter()
        cycle_s, tc = cycle_s + [now - tc], now
        if tracer.elapsed(t0) >= cell.seconds and not tracer.open:
            break
    tracer.close()
    window_s = tracer.elapsed(t0)
    if last is not None and all(last[0] != k[0] for k in kept):
        kept.append(last)
    return SimpleNamespace(window_s=window_s, attempted=r + 1, failed=failed, kept=kept,
                           iterations=iterations, evaluations=evaluations,
                           diagnostics={"pool_run_s": spread(cycle_s),
                                        "setup_parts": state.setup_parts})


def spread(times) -> str:
    """min / median / max of a list of seconds, their count, and how many
    take over 1.1 times the median, for the log."""
    t = sorted(times)
    med = t[len(t) // 2]
    slow = sum(x > 1.1 * med for x in t)
    return f"{t[0]:.4f} / {med:.4f} / {t[-1]:.4f} s ({len(t)}; {slow} over 1.1 x the median)"


def end_to_end(cell, state, record) -> dict:
    return {cell.traffic["metric"]: record.iterations / record.window_s}


def follow_gaps(cell, X, y, kept) -> dict:
    """{lbfgs_dir_gap, lbfgs_rise}: the largest over the kept restarts
    (`reference/lbfgs.py::follow`)."""
    vg = cell.reference.objective(cell.config, X.double(), y.double(), "f64")
    dir_gap = rise = 0.0
    counted = 0
    for r, xs in kept:
        rows, up, values = ref_lbfgs.follow(vg, [x.to(X.device, torch.float64) for x in xs],
                                            GTOL)
        d = max((row[2] for row in rows), default=0.0)
        counted += len(rows)
        dir_gap, rise = max(dir_gap, d), max(rise, up)
        print(f"restart {r}: {len(rows)} of {len(xs) - 1} iterations counted; direction {d}; "
              f"rise {up}; f(x_0) {values[0]}, least f {values.min()}", file=sys.stderr)
    if not counted:  # nothing compared is no pass
        return {"lbfgs_dir_gap": math.inf, "lbfgs_rise": math.inf}
    return {"lbfgs_dir_gap": dir_gap, "lbfgs_rise": rise}


def check(cell, state, record) -> list:
    """The numbers that the mix's `limits` name, each beside its limit."""
    lim = cell.traffic["limits"]
    numbers = follow_gaps(cell, state.X, state.y, record.kept)
    for name in sorted(set(numbers) - set(lim)):
        print(f"{name} {numbers[name]} (not compared in this cell)", file=sys.stderr)
    return [(name, v, lim[name]) for name, v in numbers.items() if name in lim] + [
        ("failed", float(record.failed), 0.0)]
