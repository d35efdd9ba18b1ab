"""Traffic kind "hmc": a batch of MCMC chains run by the split sampler.

Set-up makes the data (the configuration's, the same in every run) and
the model, starts `chains` chains
`start_std` standard normals around the model's initial state (latents
and kernel parameters 0), and runs `burn_in` outer iterations, which also
build the kernels and capture the sampler's graphs. The window then runs
chunks of `chunk` outer iterations, continuing the chains from one sampler
call to the next, until `--seconds` is up. One torch.Generator on the
device, seeded from the run's seed, makes the starts and every draw of
the sampler.

End to end: `hmc_draws_per_s`, every chain's draws (one an A update)
recorded in the window over the window's seconds. Beside it, the
per-layer `hmc.ess_per_s`: the median over the parameters of the
multi-chain effective sample size of all the window's draws (the
benchmark's own copy of the estimator) over the window's seconds. It
follows how far the chains have mixed: on this configuration their
kernel hyperparameters still read R-hat 1.3 after 1000 outer iterations,
and one seed's ESS swings threefold from one window to the next.

Correct: the reference (float64) follows outer iterations of the program
one update at a time, each update from the program's state before it
and with the same draws (made again from the generator's state that the
benchmark kept, skipped ahead to the iteration): the first of the
burn-in, from the starts, and in each of `check_chunks` of the window's
chunks, drawn from the seed, one outer iteration drawn from the seed. A
chain's gap after an update is the largest difference of its parameters
from the reference's, over max(1, the reference's largest); `hmc_gap` is
the largest over the chains and updates, leaving out the updates whose
accept test the reference finds within its accept band of the threshold
(|m| = |H(start) - H(end) - log u|): there float32 and float64 may decide
either way, and a chain's gap is the size of a move. The band is
ACCEPT_BAND, and in an outer iteration that holds a suspect (a gap over the
limit, |m| outside ACCEPT_BAND) it is set at each update by float32's own
error at that state, as the reference measures it (`band`).
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from gpbench.reference import precision
from gpbench.reference.diagnostics import effective_sample_size, split_rhat

from .fit import data, spread

__all__ = ["setup", "window", "end_to_end", "check", "band", "band_of", "iteration_args", "summary",
           "ess_per_s"]

# the margin |H(start) - H(end) - log u| under which float32 and float64 may decide an accept
# test either way at any state: the band's floor
ACCEPT_BAND = 0.01
# a suspect's band: KAPPA times the largest change of the margin over PERTURBATIONS evaluations
# perturbed at float32's error (`band`)
KAPPA = 2.0
PERTURBATIONS = 4


def setup(cell):
    cfg, tr = cell.config, cell.traffic
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed)
    X, y = data(cell)
    program = cell.make_program(cfg, X, y)
    p = cfg["layout"]["latent"] + cfg["layout"]["hyper"]
    x = tr["start_std"] * torch.randn((tr["chains"], p), generator=gen, dtype=X.dtype,
                                      device=X.device)
    n, k = cfg["layout"]["latent"], cfg["sampler"]["a_iters"]
    first = (x[:, :n].clone(), x[:, n:].clone(), gen.get_state())
    draws, final, _ = program.sweep(x[:, :n], x[:, n:], gen, tr["burn_in"])
    first += (draws[:, :k + 1].clone(), final.clone() if tr["burn_in"] == 1 else None)
    del draws
    return SimpleNamespace(X=X, y=y, gen=gen, program=program, a=final[:, :n], b=final[:, n:],
                           first=first)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(cell, state, tracer):
    k = cell.traffic["chunk"]
    chunks, draws, accept, chunk_s = [], [], [], []
    a, b = state.a, state.b
    t0 = time.perf_counter()
    while True:
        before = (a, b, state.gen.get_state())
        traced = tracer.begin()
        tc = time.perf_counter()
        with torch.profiler.record_function("gpbench.hmc.chunk"):
            samples, final, acc = state.program.sweep(a, b, state.gen, k)
        with torch.profiler.record_function("gpbench.hmc.sync"):
            _sync(samples.device)
        chunk_s.append(time.perf_counter() - tc)
        if traced:
            tracer.end({"outer_iterations": k})
        n = a.shape[1]
        a, b = final[:, :n], final[:, n:]
        draws.append(samples)
        accept.append(acc)
        chunks.append(before + (final,))
        if tracer.elapsed(t0) >= cell.seconds and not tracer.open:
            break
    tracer.close()
    window_s = tracer.elapsed(t0)
    return SimpleNamespace(window_s=window_s, attempted=len(chunks) * k, failed=0, chunks=chunks,
                           draws=draws, accept_rate=float(torch.stack(accept).mean()),
                           diagnostics={"chunk_s": spread(chunk_s)})


def summary(record) -> dict:
    """ESS min and median, and R-hat max, of the window's draws (float64)."""
    samples = torch.cat(record.draws, 1).double()
    ess = effective_sample_size(samples)
    out = {"ess_median": float(ess.median()), "ess_min": float(ess.min()),
           "rhat_max": float(split_rhat(samples).max()), "draws": int(samples.shape[1])}
    del samples
    return out


def end_to_end(cell, state, record) -> dict:
    draws = sum(d.shape[0] * d.shape[1] for d in record.draws)
    return {"hmc_draws_per_s": draws / record.window_s}


def ess_per_s(record) -> float:
    """The window's ESS median over its seconds (its ESS min and R-hat max
    go to the log)."""
    if "ess_median" not in record.diagnostics:
        record.diagnostics.update(summary(record))
    return record.diagnostics["ess_median"] / record.window_s


def _gaps(cell, state, a_in, b_in, gen_state, skip, rows, b_out, perturb=None, mode="f64"):
    """The gaps and the reference's accept margins (a_iters + 1, C) of one
    outer iteration of the program: its input (a_in, b_in), the
    generator's state `skip` outer iterations before it, its draws' rows
    (C, a_iters, p) and its b after the B update. `perturb`: the
    reference's, on every matrix it factors (`precision.Float32Error`);
    `mode`: the reference's precision."""
    cfg = cell.config
    n, k = cfg["layout"]["latent"], cfg["sampler"]["a_iters"]
    dt = precision.dtype_of(mode)
    gen = torch.Generator(device=state.X.device)
    gen.set_state(gen_state)
    cell.reference.skip(gen, a_in.shape[0], n, b_in.shape[1], cfg, skip)
    given = rows[:, :k, :n].transpose(0, 1).double()
    ref_a, ref_b, _, margin = cell.reference.outer_iteration(
        a_in.to(dt), b_in.to(dt), gen, state.X.to(dt), state.y.to(dt), cfg, mode,
        given_a=given.to(dt), perturb=perturb)

    def gap(prog, ref):
        ref = ref.double()
        return (prog - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1.0)

    return torch.cat([gap(given, ref_a), gap(b_out.double(), ref_b)[None]], 0), margin.double()


def iteration_args(cell, a_in, b_in, gen_state, draws, final, j: int) -> tuple:
    """`_gaps`'s arguments for outer iteration j of a sampler call from
    (a_in, b_in) with the generator at `gen_state`, given the call's draws
    (C, its outer iterations x a_iters, p) and final state."""
    n, k = cell.config["layout"]["latent"], cell.config["sampler"]["a_iters"]
    if j:  # the state after outer iteration j - 1: its last A update, its B update
        a_in, b_in = draws[:, j * k - 1, :n], draws[:, j * k, n:]
    b_out = draws[:, (j + 1) * k, n:] if (j + 1) * k < draws.shape[1] else final[:, n:]
    return a_in, b_in, gen_state, j, draws[:, j * k:(j + 1) * k], b_out


def _inputs(cell, state, record) -> list:
    """[(outer iteration, `_gaps`'s arguments)] of the outer iterations that
    the reference follows: the burn-in's first, and one in each of
    `check_chunks` of the window's chunks, all drawn from the seed."""
    tr = cell.traffic
    a0, b0, st0, rows0, final0 = state.first
    out = [(0, iteration_args(cell, a0, b0, st0, rows0, final0, 0))]
    rng = np.random.default_rng([cell.seed, 1])
    for i in sorted(rng.choice(len(record.chunks), size=min(tr["check_chunks"],
                                                             len(record.chunks)),
                               replace=False)):
        a_in, b_in, st, final = record.chunks[i]
        j = int(rng.integers(tr["chunk"]))
        out.append((tr["burn_in"] + i * tr["chunk"] + j,
                    iteration_args(cell, a_in, b_in, st, record.draws[i], final, j)))
    return out


def band_of(margin, perturbed):
    """Each update's accept band: max(ACCEPT_BAND, KAPPA s), s the largest
    change of the margin (a_iters + 1, C) over the perturbed evaluations'
    margins (draws, a_iters + 1, C); ACCEPT_BAND where the margin, or any
    perturbed one, is not finite in float32 (a path that blew up, which
    float32 reads as not finite): that update rejects whatever the
    rounding."""
    def finite(x):
        return x.abs() <= torch.finfo(torch.float32).max

    s = (perturbed - margin).abs().amax(0)
    return torch.where(finite(margin) & finite(perturbed).all(0),
                       (KAPPA * s).clamp_min(ACCEPT_BAND), torch.full_like(margin, ACCEPT_BAND))


def band(cell, state, iteration: int, args, margin):
    """`band_of` one followed outer iteration (`_gaps`'s arguments `args`,
    its margins `margin`) over PERTURBATIONS evaluations from the same
    starts and draws, each with every matrix it factors perturbed at
    float32's backward-error size (`precision.Float32Error`, keyed by the
    run's seed, the iteration and the draw). It reads the reference's inputs
    alone (with the program's states before each update), never what the
    program made of them."""
    return band_of(margin, torch.stack([
        _gaps(cell, state, *args, perturb=precision.Float32Error((cell.seed, iteration, r),
                                                                 state.X.device))[1]
        for r in range(PERTURBATIONS)]))


def check(cell, state, record) -> list:
    """`hmc_gap`: the largest gap over the followed updates whose margin
    lies outside their band. Bands wider than ACCEPT_BAND are worked out
    only in the outer iterations that hold a suspect, an update whose gap
    is over the limit and whose margin is outside ACCEPT_BAND. What the
    band did goes to standard error and to `cell.notes["hmc_band"]`."""
    limit = cell.traffic["limits"]["hmc_gap"]
    gaps, margins, bands = [], [], []
    t0 = time.perf_counter()
    for iteration, args in _inputs(cell, state, record):
        g, m = _gaps(cell, state, *args)
        gaps.append(g)
        margins.append(m)
        suspect = (g > limit) & (m.abs() > ACCEPT_BAND)
        bands.append(band(cell, state, iteration, args, m) if bool(suspect.any())
                     else torch.full_like(m, ACCEPT_BAND))
    gaps, margins, bands = (torch.cat(x).flatten() for x in (gaps, margins, bands))
    outside = margins.abs() > ACCEPT_BAND
    kept = gaps[margins.abs() > bands]
    fixed = gaps[outside]

    def largest(x):
        return float(x.max()) if x.numel() else float("inf")

    notes = {"checked": gaps.numel(), "kept": kept.numel(),
             "excused": int((outside & (margins.abs() <= bands)).sum()),
             "largest_band": float(bands.max()), "fixed_band_gap": largest(fixed),
             "check_s": time.perf_counter() - t0}
    cell.notes["hmc_band"] = notes
    print(f"hmc_gap over {kept.numel()} of {gaps.numel()} chain updates (the rest within their "
          f"accept band); median {float(kept.median()) if kept.numel() else float('nan')}; "
          f"the band excused {notes['excused']} beyond {ACCEPT_BAND}, largest band "
          f"{notes['largest_band']}; with the fixed {ACCEPT_BAND} band hmc_gap would read "
          f"{notes['fixed_band_gap']}; check {notes['check_s']:.2f} s", file=sys.stderr)
    return [("hmc_gap", largest(kept), limit)]
