"""Every update of a long run of the split sampler followed by the float64
reference: the readings behind the accept band of the "hmc" check
(`loops/hmc.py`'s KAPPA and PERTURBATIONS, `precision.Float32Error`'s GAMMA).

    python3 -m gpbench.scan --seeds 21 22 --iterations 1250 [--sample 125] [--draws 8]
                            [--gammas 1 4 16] [--save DIR]

For each seed, the cell's data, model and starts as its set-up makes them;
the program runs `iterations` outer iterations from the starts, in calls of
the cell's chunk, and the reference follows every outer iteration from the
program's states with the same draws. The outer iterations that hold a
"flip" (an update that the program decided the other way from the reference,
its margin m outside ACCEPT_BAND) or a suspect (the check's), and every
`sample`-th, are studied: the reference's margins again, `draws` times for
each perturbation size gamma (in units of 2^-24, keyed as the check keys its
draws), once in plain float32 (m32), and PERTURBATIONS times in float32 at
the smallest gamma. One JSON line a flip (m, its gap, m32, and for each
gamma s = max |m_r - m| over the check's PERTURBATIONS draws and over all,
and the draws that were not finite); one line a studied iteration with how
many updates the check's own band excused beyond ACCEPT_BAND; a summary line
a seed. With `--save DIR`, DIR/<seed>.pt holds each studied iteration's
margins and their changes (bfloat16). Needs the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

from . import harness
from .loops import hmc
from .loops.fit import data
from .reference import precision

__all__ = ["scan", "main"]

CELL = "gpa_bern.hmc128"
UNIT = 2.0 ** -24


def _margins(cell, state, iteration, args, draws: int, mode: str, gamma: float) -> torch.Tensor:
    """The reference's margins (draws, a_iters + 1, C) in `mode`, each draw r
    with every factored matrix perturbed at `gamma`, keyed as the check keys
    them (its draws are the first PERTURBATIONS)."""
    return torch.stack([hmc._gaps(cell, state, *args, mode=mode, perturb=precision.Float32Error(
        (cell.seed, iteration, r), state.X.device, gamma))[1] for r in range(draws)])


def _decided(cell, args):
    """The program's accept decisions (a_iters + 1, C): whether each update
    moved its block."""
    n, k = cell.config["layout"]["latent"], cell.config["sampler"]["a_iters"]
    a_in, b_in, _, _, rows, b_out = args
    a = torch.cat([a_in[:, None, :n], rows[:, :k, :n]], 1)
    moved_a = (a[:, 1:] != a[:, :-1]).any(-1).T
    return torch.cat([moved_a, (b_out != b_in).any(-1)[None]])


def _s(d: torch.Tensor) -> dict:
    """The study of one update's changes d (draws,) of the margin."""
    p = min(hmc.PERTURBATIONS, d.numel())
    return {"s": float(d[:p].max()), "s_all": float(d.max()),
            "nonfinite": int((~torch.isfinite(d)).sum())}


def scan(seed: int, iterations: int, sample: int, draws: int, gammas, device, overrides=None,
         out=print, save=None) -> dict:
    """One seed's scan (its summary)."""
    spec = harness.load_spec()
    cell = harness.resolve(spec, CELL, seed, 0.0, False, device, overrides)
    cfg, tr = cell.config, cell.traffic
    limit = tr["limits"]["hmc_gap"]
    gen = torch.Generator(device=device).manual_seed(cell.seed)
    X, y = data(cell)
    program = cell.make_program(cfg, X, y)
    n = cfg["layout"]["latent"]
    x = tr["start_std"] * torch.randn((tr["chains"], n + cfg["layout"]["hyper"]), generator=gen,
                                      dtype=X.dtype, device=X.device)
    a, b = x[:, :n], x[:, n:]
    state = SimpleNamespace(X=X, y=y)
    total = {"seed": seed, "iterations": 0, "updates": 0, "flips": 0, "suspects": 0,
             "fixed_band_false": 0, "band_false": 0, "excused": 0, "follow_s": 0.0,
             "study_s": 0.0}
    kept = []
    t_start = time.perf_counter()
    it = 0
    while it < iterations:
        calls = min(tr["chunk"], iterations - it)
        st = gen.get_state()
        rows, final, _ = program.sweep(a, b, gen, calls)
        for j in range(calls):
            t0 = time.perf_counter()
            args = hmc.iteration_args(cell, a, b, st, rows, final, j)
            g, m = hmc._gaps(cell, state, *args)
            total["follow_s"] += time.perf_counter() - t0
            decided = _decided(cell, args)
            flip = (decided != (torch.isfinite(m) & (m > 0))) & (m.abs() > hmc.ACCEPT_BAND)
            suspect = (g > limit) & (m.abs() > hmc.ACCEPT_BAND)
            total["iterations"] += 1
            total["updates"] += m.numel()
            total["flips"] += int(flip.sum())
            total["suspects"] += int(suspect.sum())
            total["fixed_band_false"] += int(bool(suspect.any()))
            if not (bool(suspect.any()) or bool(flip.any()) or (it + j) % sample == 0):
                continue
            t0 = time.perf_counter()
            bands = hmc.band(cell, state, it + j, args, m)
            d = {c: (_margins(cell, state, it + j, args, draws, "f64", c * UNIT) - m).abs()
                 for c in gammas}
            m32 = hmc._gaps(cell, state, *args, mode="f32")[1]
            d32 = (_margins(cell, state, it + j, args, hmc.PERTURBATIONS, "f32",
                            min(gammas) * UNIT) - m).abs()
            total["study_s"] += time.perf_counter() - t0
            outside = m.abs() > hmc.ACCEPT_BAND
            excused = int((outside & (m.abs() <= bands)).sum())
            if bool(suspect.any()):
                total["excused"] += excused
                total["band_false"] += int(bool((suspect & (m.abs() > bands)).any()))
            for u, c in flip.nonzero().tolist():
                out(json.dumps({"seed": seed, "flip": it + j, "update": u, "chain": c,
                                "m": float(m[u, c]), "gap": float(g[u, c]),
                                "band": float(bands[u, c]), "m32": float(m32[u, c]),
                                "f32": _s(d32[:, u, c]),
                                **{f"gamma{k:g}": _s(v[:, u, c]) for k, v in d.items()}}))
            out(json.dumps({"seed": seed, "studied": it + j, "suspect": bool(suspect.any()),
                            "excused": excused, "outside": int(outside.sum()),
                            "largest_band": float(bands.max())}))
            if save is not None:
                kept.append({"iteration": it + j, "m": m.cpu(), "gap": g.float().cpu(),
                             "decided": decided.cpu(), "m32": m32.cpu(),
                             "d32": d32.bfloat16().cpu(), "sample": (it + j) % sample == 0,
                             **{f"gamma{k:g}": v.bfloat16().cpu() for k, v in d.items()}})
                torch.save(kept, save)
        a, b = final[:, :n], final[:, n:]
        it += calls
        del rows
    total["seconds"] = time.perf_counter() - t_start
    out(json.dumps(total))
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--iterations", type=int, default=1250)
    ap.add_argument("--sample", type=int, default=125)
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--gammas", type=float, nargs="+", default=[1.0, 4.0, 16.0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", help="a directory: each seed's studied iterations, <seed>.pt")
    args = ap.parse_args(argv)
    harness.cache_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        scan(seed, args.iterations, args.sample, args.draws, args.gammas,
             torch.device(args.device), out=lambda line: print(line, flush=True),
             save=None if args.save is None else f"{args.save}/{seed}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
