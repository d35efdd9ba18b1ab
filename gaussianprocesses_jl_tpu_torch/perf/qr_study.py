"""FITC's float32 QR on the card: the mixed-precision shifted Cholesky QR
(`models/sparse._CholQR3`) against `torch.linalg.qr`, at configuration #4's
shape, 100 512 x 512.

    python -m gaussianprocesses_jl_tpu_torch.perf.qr_study           # on the card
    python -m gaussianprocesses_jl_tpu_torch.perf.qr_study --no-cond # without the survey

Run from the repository's root: the cell is read from the benchmark's own
files (`gpbench/configs/fitc_se_n100k.json` and `.py`, `gpbench/traffic/
fit100k.json`). On the card it prints, each as one JSON line:

  * `card_check` - on the stacked matrix [Lambda^-1/2 Kfu; Luu^T] of
    configuration #4 at the benchmark pool's first start: the route's
    forward and `torch.linalg.qr`'s times (CUDA events, median of REPS),
    each VJP's time on one random cotangent, the forward's peak memory
    above its input and output, and each route's gaps against float64
    Householder (R's diagonal made positive): ||Q^T Q - I||_2,
    ||QR - A||_2 / ||A||_2 and ||R - R64||_F / ||R64||_F; then the QRs that
    a 3-iteration `optimize(method='optax')` from that start counts by
    shape and by route (`routes_of_a_fit`, through the model's graphs).
    chip_smoke's phase 34 runs it.
  * `parts` - the forward's pieces alone: the float64 Gram A^T A as one
    product and as `torch.bmm` over row slabs summed (SLABS), the n-side
    product by an m x m matrix, one m x m float64 Cholesky factor with its
    inverse as the route takes them (`sparse._chol_inv_t`), the factor
    alone, and the inverse alone as one triangular solve against the
    identity and as `tri_inv_lower`, and a float64 matrix cast to float32
    and back; the products with their TFLOP/s.
  * `conditioning` - cond(A) of the stacked float32 matrix, from the
    singular values of its float64 Householder R: at the eight corners of
    the traffic's start box and at every iterate of
    `optimize(method='optax')` from the pool's starts, as the timed loop
    runs them; and each start's fit on both routes, each on a fresh model:
    its evaluations, seconds, and the line search's trials and the value
    at each iteration.

The pool, its seed, the iteration cap and the start box are the traffic
file's; the pool's starts are drawn by `gpbench/loops/fit.py::starts`, the
data by the configuration's `make_data` and the model by its `Program`.
The study swaps a route or records a call only inside `_patched`.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch

__all__ = ["REPS", "SLABS", "cell", "cell_model", "pool_starts", "stacked", "gaps",
           "card_check", "routes_of_a_fit", "parts", "conditioning"]

REPS = 20
SLABS = (1, 4, 8, 16, 32, 64)
_GPBENCH = Path(__file__).resolve().parents[2] / "gpbench"


def cell() -> tuple:
    """(configuration, traffic) of the benchmark's `fitc_se.fit100k`, as its
    files hold them."""
    return tuple(json.loads((_GPBENCH / sub).read_text())
                 for sub in ("configs/fitc_se_n100k.json", "traffic/fit100k.json"))


def cell_model(device):
    """Configuration #4's FITC on its data, as the benchmark's `Program`
    builds it."""
    from gpbench.configs import fitc_se_n100k as conf

    cfg, _ = cell()
    X, y = conf.make_data(cfg, cfg["n"], torch.Generator(device=device))
    return conf.Program(cfg, X, y).model


def pool_starts(device) -> torch.Tensor:
    """(pool, 3): the benchmark pool's starts [log noise, log l, log sigma]."""
    from gpbench.loops.fit import starts

    cfg, tr = cell()
    gen = torch.Generator(device=device).manual_seed(tr["pool_seed"])
    return starts(cfg, tr, tr["pool"], gen)


@contextlib.contextmanager
def _patched(record: list | None = None, library: bool = False, trace: list | None = None):
    """Within it: each stacked matrix the model factors appended to `record`;
    `torch.linalg.qr` in `_CholQR3.apply`'s place (the parent's route) if
    `library`; `lbfgs.minimize` tracing its iterations into `trace`. Every
    swap is undone on leaving."""
    from gaussianprocesses_jl_tpu_torch.inference import lbfgs
    from gaussianprocesses_jl_tpu_torch.models import sparse

    qr, minimize = sparse._qr, lbfgs.minimize
    if record is not None:
        def recording(A):
            record.append(A.detach().clone())
            return qr(A)

        sparse._qr = recording
    if library:
        sparse._CholQR3.apply = _library  # shadows the inherited classmethod
    if trace is not None:
        lbfgs.minimize = functools.partial(minimize, trace=trace)
    try:
        yield
    finally:
        sparse._qr, lbfgs.minimize = qr, minimize
        if library:
            del sparse._CholQR3.apply


def stacked(model, theta) -> torch.Tensor:
    """The stacked matrix that the model's QR factors at `theta`."""
    from gaussianprocesses_jl_tpu_torch.models import gpe

    seen = []
    model.set_params(np.asarray(theta, dtype=np.float64))
    with _patched(record=seen), torch.no_grad():
        gpe.gpe_factorize(model.params, model.x, model.covstrat)
    return seen[0]


def _positive(Q, R):
    s = torch.sign(R.diagonal())
    s = torch.where(s == 0, torch.ones_like(s), s)
    return Q * s, s[:, None] * R


def gaps(Q, R, A64, R64) -> dict:
    """Orthogonality, residual and R's gap of (Q, R) in float64."""
    Q, R = _positive(Q.double(), R.double())
    eye = torch.eye(R.shape[0], dtype=torch.float64, device=R.device)
    two = functools.partial(torch.linalg.matrix_norm, ord=2)
    return {"orth": float(two(Q.mT @ Q - eye)),
            "residual": float(two(Q @ R - A64) / two(A64)),
            "r_gap": float(torch.linalg.matrix_norm(R - R64) / torch.linalg.matrix_norm(R64))}


def _events_ms(fn, reps=REPS, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def card_check(device) -> dict:
    """The two routes on the cell's matrix at the pool's first start."""
    from gaussianprocesses_jl_tpu_torch.models import sparse

    model, start = cell_model(device), pool_starts(device)[0].tolist()
    A = stacked(model, start)
    A64 = A.double()
    _, R64 = _positive(*torch.linalg.qr(A64))
    routes = {"cholqr3": lambda a: sparse._CholQR3.apply(a)[:2],
              "library": lambda a: torch.linalg.qr(a)}
    gen = torch.Generator(device=device).manual_seed(34)
    dQ = torch.randn(A.shape, generator=gen, device=device)
    dR = torch.triu(torch.randn((A.shape[1],) * 2, generator=gen, device=device))
    out = {"rows": A.shape[0], "cols": A.shape[1]}
    for name, qr in routes.items():
        with torch.no_grad():
            Q, R = qr(A)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        with torch.no_grad():
            qr(A)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) - base
        with torch.no_grad():
            fwd = _events_ms(lambda: qr(A))
        Ag = A.clone().requires_grad_()
        Qg, Rg = qr(Ag)
        vjp = _events_ms(lambda: torch.autograd.grad((Qg, Rg), Ag, (dQ, dR), retain_graph=True),
                         reps=REPS // 2)
        out[name] = {"forward_ms": fwd, "vjp_ms": vjp, "forward_peak_bytes": peak,
                     **gaps(Q, R, A64, R64)}
        del Ag, Qg, Rg
    out["library_ms"] = out["library"]["forward_ms"]
    out["cholqr3"]["ok"] = bool(sparse._CholQR3.apply(A)[2])
    out["fit"] = routes_of_a_fit(model, start)
    print("card_check: " + json.dumps(out), flush=True)
    return out


def routes_of_a_fit(model, start, maxiter=3) -> dict:
    """`optimize(method='optax', maxiter)` from `start` through its graphs:
    its evaluations and the QRs it counted by shape and by route."""
    from gaussianprocesses_jl_tpu_torch.models import sparse

    sparse.QR_SHAPES.clear()
    sparse.QR_ROUTES.clear()
    model.set_params(np.asarray(start, dtype=np.float64))
    res = model.optimize(method="optax", maxiter=maxiter)
    return {"evaluations": int(res.message.split()[0]),
            "qr_shapes": {" ".join(map(str, k)): v for k, v in sparse.QR_SHAPES.items()},
            "qr_routes": {" ".join(map(str, k)): v for k, v in sparse.QR_ROUTES.items()}}


def parts(device, rows=100_512, cols=512) -> dict:
    """The forward's pieces at (rows, cols) in float64, each timed alone."""
    from gaussianprocesses_jl_tpu_torch.models import sparse
    from gaussianprocesses_jl_tpu_torch.ops.linalg import tri_inv_lower

    gen = torch.Generator(device=device).manual_seed(3)
    A = torch.randn((rows, cols), generator=gen, device=device, dtype=torch.float64)
    gram_flops = 2.0 * rows * cols ** 2
    out = {"gram": {}}
    for s in SLABS:
        r = rows // s

        def slabbed(s=s, r=r):
            a = A[:s * r].view(s, r, cols)
            g = torch.bmm(a.mT, a).sum(0)
            return g if s * r == rows else g + A[s * r:].mT @ A[s * r:]

        ms = _events_ms(slabbed if s > 1 else lambda: A.mT @ A)
        out["gram"][s] = {"ms": ms, "tflops": gram_flops / ms / 1e9}
    X = torch.randn((cols, cols), generator=gen, device=device, dtype=torch.float64)
    ms = _events_ms(lambda: A @ X)
    out["product"] = {"ms": ms, "tflops": gram_flops / ms / 1e9}
    G = A[:4 * cols].mT @ A[:4 * cols]
    L = torch.linalg.cholesky_ex(G)[0]
    eye = torch.eye(cols, dtype=torch.float64, device=device)
    out["cholesky_inverse_ms"] = _events_ms(lambda: sparse._chol_inv_t(G))
    out["cholesky_ms"] = _events_ms(lambda: torch.linalg.cholesky_ex(G))
    out["tri_inv_lower_ms"] = _events_ms(lambda: tri_inv_lower(L))
    out["solve_triangular_ms"] = _events_ms(
        lambda: torch.linalg.solve_triangular(L, eye, upper=False))
    out["cast_ms"] = _events_ms(lambda: A.float().double())
    print("parts: " + json.dumps(out), flush=True)
    return out


def _cond(A) -> float:
    s = torch.linalg.svdvals(torch.linalg.qr(A.double(), mode="r")[1])
    return float(s[0] / s[-1])


def _library(A):
    """`torch.linalg.qr` in `_CholQR3.apply`'s place (the parent's route)."""
    return (*torch.linalg.qr(A), torch.ones((), dtype=torch.bool, device=A.device))


def _fit(device, x0, route) -> tuple:
    """One `optimize(method='optax')` from x0 to the traffic's iteration cap
    on a fresh model (its own graphs), the float32 QR on `route`: (its
    iterates x_k and the end, as float64 numpy arrays; {evaluations,
    seconds, trials a iteration, the value a iteration})."""
    import time

    model, trace = cell_model(device), []
    with _patched(library=route == "library", trace=trace):
        model.set_params(np.asarray(x0, dtype=np.float64))
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = model.optimize(method="optax", maxiter=cell()[1]["maxiter"])
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    xs = [x.detach().double().cpu().numpy() for x, _ in trace] + [np.asarray(res.x)]
    return model, xs, {"evaluations": int(res.message.split()[0]), "seconds": seconds,
                       "trials": [1 + int(step.ran) for _, step in trace],
                       "values": [float(step.value) for _, step in trace]}


def conditioning(device) -> dict:
    """cond(A) at the box's corners and along the pool's fits on the float32
    route; each start's fit on both routes (evaluations, seconds, trials and
    values by iteration)."""
    model = cell_model(device)
    box = cell()[1]["start"]["hyper"]
    corners = [list(c) for c in itertools.product(box, repeat=3)]
    out = {"corners": [{"theta": c, "cond": _cond(stacked(model, c))} for c in corners]}
    everything = list(out["corners"])
    for k, x0 in enumerate(pool_starts(device).tolist()):
        fitted, xs, out[f"fit{k}"] = _fit(device, x0, "cholqr3")
        out[f"start{k}"] = [{"theta": x.tolist(), "cond": _cond(stacked(fitted, x))}
                            for x in xs]
        everything += out[f"start{k}"]
        del fitted
        out[f"fit{k}_library"] = _fit(device, x0, "library")[2]
    out["largest"] = max(everything, key=lambda row: row["cond"])
    print("conditioning: " + json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-cond", action="store_true", help="skip the conditioning survey")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qr_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    from gaussianprocesses_jl_tpu_torch.utils.profiling import card_line

    print(f"card: {card_line()}", flush=True)
    result = {"card_check": card_check(dev), "parts": parts(dev)}
    if not args.no_cond:
        result["conditioning"] = conditioning(dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
