"""The error budget of reduced-precision products in a blocked Cholesky of GP
grams, on one NVIDIA GPU (the port of the JAX repo's
`perf/chol_precision_study.py`).

    python -m gaussianprocesses_jl_tpu_torch.perf.chol_precision_study [--device cpu]

The data are the JAX study's: n = 4096 points uniform on (0, 4) in 4-D
(`RandomState(0)`), the SE gram with unit parameters, y = randn(n), and a
noise variance of 1e-1, 1e-2 and 1e-3 on the diagonal. The truth is numpy's
f64 factor on the host. For each noise, five f32 factors of the same K:

* `cholesky_ex`: the library's factor (the row `jnp.linalg.cholesky`
  plays in the JAX study);
* `single_launch_cholesky`: the Cholesky study's kernel (`csrc/cholesky.cu`);
* `blocked_f32`, `blocked_tf32`, `blocked_3xtf32`: the left-looking blocked
  factor of `ops/linalg.py::blocked_cholesky` (block 512), its trailing
  products P P^T run in full f32 with TF32 off, in TF32, and in 3xTF32
  (a = hi + lo with hi holding TF32's 10-bit mantissa, a b ~ hi hi + hi lo +
  lo hi, each product in TF32).

Each row gives `finite`, max|L - L64|, the log-det's absolute error and the
quadratic form y^T K^-1 y's relative error, as the JAX study does. TF32 is
switched on only inside the TF32 products (`tf32()`, which restores the
flag), and a TF32 row carries a plain product check beside it: the relative
error of one 1024 x 1024 f32 product made under the flag, against f64. If
that error is f32's rather than TF32's, the flag did not take and the run
fails. After the rows the flag must be off again.

On the CPU (`--device cpu`) the TF32 rows are not measured: the CPU has no
TF32, and the product check would fail by design.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from gaussianprocesses_jl_tpu_torch.ops import cholesky_kernels as chol_op
from gaussianprocesses_jl_tpu_torch.ops.linalg import chol_logdet, tri_inv_lower
from gaussianprocesses_jl_tpu_torch.utils.profiling import card_line

__all__ = ["N", "BLOCK", "NOISES", "tf32", "tf32_round", "mm_f32", "mm_tf32", "mm_3xtf32",
           "blocked_cholesky_with", "product_error", "gp_gram", "row_errors", "run", "main"]

N, BLOCK, D_X = 4096, 512, 4
NOISES = (1e-1, 1e-2, 1e-3)
N_CHECK = 1024  # the product check's size
# a product's relative error above this is TF32's (2^-11 a rounding), not
# f32's: 2.91e-4 and 1.18e-6 at n = 1024 on an NVIDIA H100 80GB HBM3, 700 W
TF32_SEEN = 1e-5


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 matmuls on (or off) inside the block; the flag as it was after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """a (f32) rounded to TF32's 10-bit mantissa, to nearest (the low 13 bits
    of the significand cleared after adding half their range)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_f32(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    with tf32(False):
        return A @ B


def mm_tf32(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    with tf32(True):
        return A @ B


def mm_3xtf32(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A B from three TF32 products of the hi/lo split (lo lo dropped)."""
    Ah, Bh = tf32_round(A), tf32_round(B)
    Al, Bl = A - Ah, B - Bh
    with tf32(True):
        return Ah @ Bh + (Ah @ Bl + Al @ Bh)


def blocked_cholesky_with(K: torch.Tensor, mm, block: int = BLOCK) -> torch.Tensor:
    """`ops/linalg.py::blocked_cholesky`'s left-looking loop with its
    cross-panel product P P^T made by `mm(P, P^T)`: L."""
    n = K.shape[-1]
    nb = -(-n // block)
    sizes = [block] * (nb - 1) + [n - (nb - 1) * block]
    cols = []
    for k in range(nb):
        bk, off = sizes[k], k * block
        Acol = K[off:, off:off + bk]
        if k > 0:
            P = torch.cat([cols[j][(k - j) * block:, :] for j in range(k)], dim=1)
            Acol = Acol - mm(P, P[:bk, :].T)
        lkk = torch.linalg.cholesky_ex(Acol[:bk, :bk])[0]
        if k + 1 < nb:
            cols.append(torch.cat([torch.tril(lkk), Acol[bk:, :] @ tri_inv_lower(lkk).T], dim=0))
        else:
            cols.append(torch.tril(lkk))
    rows = []
    for i in range(nb):
        bi = sizes[i]
        parts = [cols[j][(i - j) * block:(i - j) * block + bi, :] for j in range(i + 1)]
        pad = n - (i * block + bi)
        if pad:
            parts.append(K.new_zeros((bi, pad)))
        rows.append(torch.cat(parts, dim=1))
    return torch.cat(rows, dim=0)


def product_error(mm, device, n: int = N_CHECK) -> float:
    """max|mm(A, B) - A B| / max|A B| against f64, A, B standard normal f32
    (`RandomState(1)`)."""
    rng = np.random.RandomState(1)
    A64, B64 = rng.randn(n, n), rng.randn(n, n)
    ref = A64 @ B64
    A, B = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (A64, B64))
    got = mm(A, B).double().cpu().numpy()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def gp_gram(n: int = N) -> tuple:
    """(K without noise, y), f64 numpy, as the JAX study makes them."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 4, (n, D_X))
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2), rng.randn(n)


def row_errors(L: torch.Tensor, y: torch.Tensor, L64: np.ndarray, ld64: float,
               quad64: float) -> dict:
    """The JAX study's columns for one f32 factor."""
    Lh = L.double().cpu().numpy()
    if not np.all(np.isfinite(Lh)):
        return {"finite": False}
    w = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0].double().cpu().numpy()
    quad = float(w @ w)
    return {"finite": True, "max_dL": float(np.max(np.abs(Lh - L64))),
            "logdet_abs_err": abs(float(chol_logdet(L.double())) - ld64),
            "quad_rel_err": abs(quad - quad64) / quad64}


def _fail(msg: str) -> None:
    print(f"chol_precision_study: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def run(device, n: int = N, block: int = BLOCK, noises=NOISES) -> dict:
    """Every row of every noise, with the product checks; raises SystemExit
    on a TF32 row whose flag did not take or a flag left on."""
    device = torch.device(device)
    K0, y64 = gp_gram(n)
    routes = {"cholesky_ex": lambda K: torch.linalg.cholesky_ex(K)[0],
              "single_launch_cholesky": chol_op.single_launch_cholesky,
              "blocked_f32": lambda K: blocked_cholesky_with(K, mm_f32, block)}
    checks = {"blocked_f32": {"product_rel_err": product_error(mm_f32, device)}}
    if device.type == "cuda":
        routes["blocked_tf32"] = lambda K: blocked_cholesky_with(K, mm_tf32, block)
        routes["blocked_3xtf32"] = lambda K: blocked_cholesky_with(K, mm_3xtf32, block)
        plain_tf32 = product_error(mm_tf32, device)
        if not plain_tf32 > TF32_SEEN:
            _fail(f"TF32 did not engage: a product under the flag is {plain_tf32:.3e} from "
                  f"f64, f32's error (TF32's is above {TF32_SEEN:g})")
        checks["blocked_tf32"] = {"product_rel_err": plain_tf32}
        checks["blocked_3xtf32"] = {"product_rel_err": product_error(mm_3xtf32, device),
                                    "tf32_product_rel_err": plain_tf32}
    out = {"n": n, "block": block, "device": str(device), "product_checks": checks,
           "not_measured": [] if device.type == "cuda" else ["blocked_tf32", "blocked_3xtf32"]}
    y = torch.as_tensor(y64, dtype=torch.float32, device=device)
    for nv in noises:
        K64 = K0 + nv * np.eye(n)
        L64 = np.linalg.cholesky(K64)
        ld64 = 2.0 * float(np.log(np.diag(L64)).sum())
        w64 = np.linalg.solve(L64, y64)
        quad64 = float(w64 @ w64)
        Kf = torch.as_tensor(K64, dtype=torch.float32, device=device)
        rows = {"cond_est": (1.0 + nv) / nv}
        for name, fn in routes.items():
            row = {**row_errors(fn(Kf), y, L64, ld64, quad64), **checks.get(name, {})}
            rows[name] = row
            print(json.dumps({"noise": nv, "row": name, **row}), flush=True)
        out[f"nugget_{nv:g}"] = rows
    if torch.backends.cuda.matmul.allow_tf32:
        _fail("TF32 is still on after the study")
    out["tf32_after"] = torch.backends.cuda.matmul.allow_tf32
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("chol_precision_study: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(f"card: {card_line()}", flush=True)
    t0 = time.perf_counter()
    out = run(device)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
