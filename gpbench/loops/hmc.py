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
accept test the reference finds within ACCEPT_BAND of its threshold
(|H(start) - H(end) - log u|): there float32 and float64 may decide
either way, and a chain's gap is the size of a move.
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from gpbench.reference.diagnostics import effective_sample_size, split_rhat

from .fit import data, spread

__all__ = ["setup", "window", "end_to_end", "check", "followed", "summary", "ess_per_s"]

# the margin |H(start) - H(end) - log u| under which float32 and float64 may decide an accept
# test either way
ACCEPT_BAND = 0.01


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


def _gaps(cell, state, a_in, b_in, gen_state, skip, rows, b_out):
    """The gaps and the reference's accept margins (a_iters + 1, C) of one
    outer iteration of the program: its input (a_in, b_in), the
    generator's state `skip` outer iterations before it, its draws' rows
    (C, a_iters, p) and its b after the B update."""
    cfg = cell.config
    n, k = cfg["layout"]["latent"], cfg["sampler"]["a_iters"]
    dev = state.X.device
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    cell.reference.skip(gen, a_in.shape[0], n, b_in.shape[1], cfg, skip)
    given = rows[:, :k, :n].transpose(0, 1).double()
    ref_a, ref_b, _, margin = cell.reference.outer_iteration(
        a_in.double(), b_in.double(), gen, state.X.double(), state.y.double(), cfg, "f64",
        given_a=given)

    def gap(prog, ref):
        return (prog - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1.0)

    return torch.cat([gap(given, ref_a), gap(b_out.double(), ref_b)[None]], 0), margin


def followed(cell, state, record) -> list:
    """[(gaps, margins)] of the outer iterations that the reference follows."""
    tr = cell.traffic
    n, k = cell.config["layout"]["latent"], cell.config["sampler"]["a_iters"]
    a0, b0, st0, rows0, final0 = state.first
    b_out0 = rows0[:, k, n:] if final0 is None else final0[:, n:]
    gaps = [_gaps(cell, state, a0, b0, st0, 0, rows0, b_out0)]
    rng = np.random.default_rng([cell.seed, 1])
    for i in sorted(rng.choice(len(record.chunks), size=min(tr["check_chunks"],
                                                             len(record.chunks)),
                               replace=False)):
        a_in, b_in, st, final = record.chunks[i]
        draws, j = record.draws[i], int(rng.integers(tr["chunk"]))
        if j:  # the state after outer iteration j - 1: its last A update, its B update
            a_in, b_in = draws[:, j * k - 1, :n], draws[:, j * k, n:]
        b_out = draws[:, (j + 1) * k, n:] if j + 1 < tr["chunk"] else final[:, n:]
        gaps.append(_gaps(cell, state, a_in, b_in, st, j, draws[:, j * k:(j + 1) * k], b_out))
    return gaps


def check(cell, state, record) -> list:
    tr = cell.traffic
    pairs = followed(cell, state, record)
    gaps = torch.cat([g for g, _ in pairs]).flatten()
    margins = torch.cat([m for _, m in pairs]).flatten()
    kept = gaps[margins.abs() > ACCEPT_BAND]
    print(f"hmc_gap over {kept.numel()} of {gaps.numel()} chain updates (the rest within the "
          f"accept band); median {float(kept.median()) if kept.numel() else float('nan')}",
          file=sys.stderr)
    return [("hmc_gap", float(kept.max()) if kept.numel() else float("inf"),
             tr["limits"]["hmc_gap"])]
