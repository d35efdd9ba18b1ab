"""The headline's explicit K^-1 on the card: which route builds it fastest.

    python -m gaussianprocesses_jl_tpu_torch.perf.kinv_study [parts|headline]

The backward of `ops/linalg.dense_quad_logdet` forms K^-1 = L^-T L^-1 from
the factor L, as the JAX package's does (`ops/linalg.py:336-358` there).
The JAX package builds L^-1 by a recursive doubling of GEMMs because XLA's
triangular solve serializes on a TPU; this script measures that choice and
its alternatives on the card. Two parts, each printing one JSON line a row
and the card's name and power limit first:

* `parts`: at n = 3000 and 16384, f32 and f64, on the headline's K (SE(0, 0),
  d = 10, `RandomState(42)`, noise variance e^-2) and its `cholesky_ex`
  factor: L^-1 by the recursion at blocks 128, 256 and 512 and by one
  `torch.linalg.solve_triangular(L, I)`; L^-T L^-1 by `tri_syrk_lower` at
  blocks 512, 1024, 2048 and 4096 and by one plain product; K^-1 whole by
  `torch.cholesky_inverse(L)` and by `torch.cholesky_solve(I, L)`; then
  each whole route; and L^-1 alone at n = 512 and 1000 in f32, the sizes
  of `blocked_cholesky`'s diagonal blocks. Each time is the median of 20 calls (5 at 16384)
  between CUDA events, once called eagerly (`ms`: the host's dispatch
  where it is the slower) and once replayed as a CUDA graph (`graph_ms`:
  the card's time, as inside the graphed headline). Each route's K^-1 is
  held against the f64 one (`cholesky_inverse` of the f64 factor):
  max|K^-1 - ref| / max|ref|.
* `headline`: the headline's target and gradient (f32 and f64, n = 3000,
  through `GPE.target_and_dtarget` and so its CUDA graph) with the backward's
  route (`ops/linalg.explicit_kinv`) swapped for each whole route in turn:
  the time a call by CUDA events, graphed and eager, and the value and
  gradient beside the route the port keeps. A route through L^-1 forms
  alpha = K^-1 r as L^-T w, one that forms K^-1 whole by a triangular
  solve against L^T.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.ops import linalg
from gaussianprocesses_jl_tpu_torch.ops.linalg import add_diag, tri_inv_lower, tri_syrk_lower
from gaussianprocesses_jl_tpu_torch.perf.gram_study import eagerly, time_ms
from gaussianprocesses_jl_tpu_torch.utils import graphs
from gaussianprocesses_jl_tpu_torch.utils.profiling import card_line

__all__ = ["SIZES", "ROUTES", "headline_factor", "parts", "headline", "main"]

SIZES = (3000, 16384)
# `blocked_cholesky`'s diagonal blocks (the bench's block 512, and 1000)
BLOCK_SIZES = (512, 1000)
D, SEED = 10, 42
INV_BLOCKS = (128, 256, 512)
SYRK_BLOCKS = (512, 1024, 2048, 4096)


def _eye(L):
    return torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)


def _trsm(L):
    return torch.linalg.solve_triangular(L, _eye(L), upper=False)


def _gemm(W):
    return W.T @ W


def _via_linv(inverse, product):
    """A route through L^-1: (product(L^-1), L^-T w), as the reference
    forms alpha."""
    def route(L, w):
        Linv = inverse(L)
        return product(Linv), Linv.T @ w
    return route


def _whole(kinv):
    """A route that forms K^-1 whole: alpha = L^-T w by one triangular
    solve."""
    return lambda L, w: (kinv(L), linalg.solve_upper(L, w))


# whole routes from (L, w = L^-1 r) to (K^-1, K^-1 r); the first is the JAX
# package's blocks
ROUTES = {
    "recursion 256 + syrk 2048": _via_linv(tri_inv_lower, lambda W: tri_syrk_lower(W, 2048)),
    "recursion 256 + syrk 1024": _via_linv(tri_inv_lower, lambda W: tri_syrk_lower(W, 1024)),
    "recursion 256 + syrk 512": _via_linv(tri_inv_lower, lambda W: tri_syrk_lower(W, 512)),
    "recursion 512 + syrk 1024": _via_linv(lambda L: tri_inv_lower(L, 512),
                                           lambda W: tri_syrk_lower(W, 1024)),
    "trsm + syrk 1024": _via_linv(_trsm, lambda W: tri_syrk_lower(W, 1024)),
    "trsm + syrk 2048": _via_linv(_trsm, lambda W: tri_syrk_lower(W, 2048)),
    "trsm + gemm": _via_linv(_trsm, _gemm),
    "cholesky_inverse": _whole(torch.cholesky_inverse),
    "cholesky_solve(I)": _whole(lambda L: torch.cholesky_solve(_eye(L), L)),
}
# the parts: L^-1 from L, and L^-T L^-1 from L^-1
INVERSES = {**{f"tri_inv_lower block {b}": functools.partial(tri_inv_lower, block=b)
               for b in INV_BLOCKS}, "solve_triangular(L, I)": _trsm}
PRODUCTS = {**{f"tri_syrk_lower block {b}": functools.partial(tri_syrk_lower, block=b)
               for b in SYRK_BLOCKS}, "Linv.T @ Linv": _gemm}


def headline_factor(n, dtype, device):
    """(L, w, L64): the `cholesky_ex` factor of the headline's K at n in
    `dtype`, w = L^-1 y, and the f64 factor."""
    rng = np.random.RandomState(SEED)
    X, y = rng.randn(n, D), rng.randn(n)
    out = []
    for dt in (dtype, torch.float64):
        k = gp.SE(0.0, 0.0).to(dtype=dt, device=device)
        Xt = torch.as_tensor(X, dtype=dt, device=device)
        K = add_diag(k.gram(Xt), float(np.exp(-2.0)))
        L, info = torch.linalg.cholesky_ex(K)
        if int(info) != 0:
            raise SystemExit(f"kinv_study: the headline's K does not factor at n = {n}, {dt}")
        out.append(L)
    w = linalg.solve_lower(out[0], torch.as_tensor(y, dtype=dtype, device=device))
    return out[0], w, out[1]


def _err(Kinv, ref) -> float:
    return float((Kinv.double() - ref).abs().max() / ref.abs().max())


def _emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def _times(fn, args, reps) -> dict:
    """fn(*args)'s median ms by CUDA events, eager and replayed as a graph
    (dropped after, with the memory it holds)."""
    out = {"ms": time_ms(lambda: fn(*args), reps=reps),
           "graph_ms": time_ms(lambda: graphs.run(fn, fn, *args), reps=reps)}
    graphs.clear()
    return out


def parts(device, sizes=SIZES) -> list:
    rows = []
    for n in sizes:
        reps = 20 if n <= 4096 else 5
        for dtype in (torch.float32, torch.float64):
            L, w, L64 = headline_factor(n, dtype, device)
            ref = torch.cholesky_inverse(L64)
            base = {"part": "parts", "n": n, "dtype": str(dtype).removeprefix("torch."),
                    "reps": reps}
            Linv = _trsm(L)
            for name, fn in INVERSES.items():
                rows.append(_emit({**base, "name": name, **_times(fn, (L,), reps),
                                   "linv_gap": float((fn(L) - Linv).abs().max()
                                                     / Linv.abs().max())}))
            for name, fn in PRODUCTS.items():
                rows.append(_emit({**base, "name": name, **_times(fn, (Linv,), reps)}))
            for name, route in ROUTES.items():
                rows.append(_emit({**base, "name": f"route: {name}",
                                   **_times(route, (L, w), reps),
                                   "kinv_err_vs_f64": _err(route(L, w)[0], ref)}))
            del L, w, L64, ref, Linv
            torch.cuda.empty_cache()
    for n in BLOCK_SIZES:
        L = headline_factor(n, torch.float32, device)[0]
        for name, fn in INVERSES.items():
            rows.append(_emit({"part": "parts", "n": n, "dtype": "float32", "reps": 20,
                               "name": name, **_times(fn, (L,), 20)}))
    return rows


def headline(device, n=3000) -> list:
    """The headline's target and gradient through its graph, the backward's
    K^-1 route swapped for each whole route in turn."""
    X = np.random.RandomState(SEED).randn(n, D)
    y = np.random.RandomState(SEED + 1).randn(n)
    kept = linalg.explicit_kinv
    rows = []
    try:
        for dtype in (np.float32, np.float64):
            m = gp.GPE(X.astype(dtype), y.astype(dtype), gp.MeanZero(), gp.SE(0.0, 0.0),
                       lognoise=-1.0, device=device)
            t0, g0 = m.target_and_dtarget()
            for name, route in {"kept": kept, **ROUTES}.items():
                linalg.explicit_kinv = route
                graphs.clear()  # the route is baked into a captured graph
                t, g = m.target_and_dtarget()
                rows.append(_emit({
                    "part": "headline", "n": n, "dtype": np.dtype(dtype).name, "route": name,
                    "ms": time_ms(m.target_and_dtarget),
                    "eager_ms": time_ms(eagerly(m.target_and_dtarget)),
                    "value_gap_vs_kept": abs(float(t) - float(t0)) / abs(float(t0)),
                    "grad_gap_vs_kept": float((g - g0).abs().max() / g0.abs().max())}))
    finally:
        linalg.explicit_kinv = kept
        graphs.clear()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("part", nargs="*", default=["parts", "headline"],
                        choices=["parts", "headline"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kinv_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"card: {card_line()}", flush=True)
    for part in args.part:
        {"parts": parts, "headline": headline}[part](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
