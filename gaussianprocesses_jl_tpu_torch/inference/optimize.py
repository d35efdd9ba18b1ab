"""Type-II ML / MAP hyperparameter optimization (counterpart of
`gaussianprocesses_jl_tpu/inference/optimize.py`).

Two methods over the selected parameter blocks:
  * 'lbfgs' (default): scipy's L-BFGS-B on the host drives the model's
    value and gradient on the model's device, with optional box bounds; a
    non-finite target (failed Cholesky) reads as a loss of 1e100 with a
    zero gradient, so that the line search backs off without an exception;
  * 'optax' (the JAX package's on-device `optax.lbfgs()` loop): optax's
    L-BFGS with its zoom line search (`inference/lbfgs.py`), iterate for
    iterate; on the card each iteration replays CUDA graphs, with one host
    read a block of line-search trials. No bounds. A non-finite value
    reaches the line search as it is, as optax sees it. It stops after the
    iteration whose ||g_k|| < tol, or at maxiter, and reports the value at
    the last x_k and the point after its step; the message counts the
    objective's evaluations (masked line-search trials included, each one
    evaluation on the device).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import lbfgs

__all__ = ["optimize", "OptimizeResult"]


@dataclass
class OptimizeResult:
    success: bool
    fun: float  # final -target (minimized)
    target: float  # final target
    x: np.ndarray
    n_iter: int
    message: str = ""


def _assemble_bounds(active_blocks, bounds_per_block):
    lb, ub = [], []
    any_bound = False
    for (name, size), b in zip(active_blocks, bounds_per_block):
        if b is None:
            lb.extend([-np.inf] * size)
            ub.extend([np.inf] * size)
        else:
            any_bound = True
            blo, bhi = b
            lb.extend(np.broadcast_to(np.asarray(blo, dtype=float), (size,)).tolist())
            ub.extend(np.broadcast_to(np.asarray(bhi, dtype=float), (size,)).tolist())
    if not any_bound:
        return None
    return list(zip(lb, ub))


def optimize(gp, method: str = "lbfgs", maxiter: int = 200, tol: float = 1e-8,
             verbose: bool = False, **kwargs) -> OptimizeResult:
    """Optimize the model's target (mll + log prior) in place.

    Keyword flags select parameter blocks (GPE: noise / domean / kern, with
    noisebounds / meanbounds / kernbounds). method='optax' is the on-device
    L-BFGS without bounds."""
    flag_names = gp.block_flag_names()
    flags = {n: bool(kwargs.pop(n, True)) for n in flag_names}
    bounds_map = {n: kwargs.pop(f"{n.replace('domean', 'mean')}bounds", None)
                  for n in flag_names}
    if kwargs:
        raise TypeError(f"unknown optimize() arguments: {sorted(kwargs)}")

    vg, x0, embed, active_blocks = gp.make_objective(**flags)
    bounds = _assemble_bounds(active_blocks,
                              [bounds_map.get(name) for name, _ in active_blocks])

    if x0.shape[0] == 0:
        t = float(gp.target)
        return OptimizeResult(True, -t, t, np.zeros(0), 0, "no free parameters")

    if method in ("lbfgs", "lbfgsb"):
        res = _scipy_lbfgsb(vg, x0, bounds, maxiter, tol, verbose)
    elif method == "optax":
        if bounds is not None:
            raise ValueError("bounds require method='lbfgs'")
        res = _optax_lbfgs(vg, x0, maxiter, tol)
    else:
        raise ValueError(f"unknown method {method!r}")

    gp.set_params(res.x, **flags)
    res.target = -res.fun
    return res


def _scipy_lbfgsb(vg, x0, bounds, maxiter, tol, verbose) -> OptimizeResult:
    from scipy.optimize import minimize

    def fun(x):
        v, g = vg(torch.as_tensor(x).to(dtype=x0.dtype, device=x0.device))
        v = float(v)
        g = g.cpu().numpy().astype(np.float64)
        if verbose:
            print(f"optimize: -target {v:.6g}")
        if not np.isfinite(v):
            # non-PD / non-finite proposals count as +inf; L-BFGS-B backtracks
            return np.float64(1e100), np.zeros_like(g)
        g = np.where(np.isfinite(g), g, 0.0)
        return np.float64(v), g

    options = {"maxiter": maxiter, "ftol": tol, "gtol": 1e-12}
    out = minimize(fun, x0.detach().cpu().numpy().astype(np.float64), jac=True,
                   method="L-BFGS-B", bounds=bounds, options=options)
    return OptimizeResult(bool(out.success), float(out.fun), -float(out.fun),
                          np.asarray(out.x), int(out.nit), str(out.message))


def _optax_lbfgs(vg, x0, maxiter, tol) -> OptimizeResult:
    """optax's L-BFGS as the JAX package's loop drives it (`lbfgs.minimize`)."""
    r = lbfgs.minimize(vg, x0, maxiter, tol)
    value = float(r.value)
    return OptimizeResult(True, value, -value, r.x.cpu().numpy(), r.n_iter,
                          f"{r.evaluations} evaluations")
