"""optax 0.2.6's `lbfgs()` (memory 10, the zoom line search with its
defaults), frozen here as plain code: one Python branch for each of the
search's cases, its scalars as numpy floats of the working precision, its
vectors as tensors.

One iteration: the objective's value and gradient at x_k; the two-loop
direction from the memory of (s, y) pairs (the scaled identity
<s, y>/<y, y> of the newest pair; at the first iteration the gradient
scaled by min(1, 1/|g|)); then Nocedal and Wright's interval search and
zoom (algorithms 3.5 and 3.6) along it, from a trial step of 1, with
cubic, quadratic and bisection interpolation, Hager and Zhang's
approximate decrease criterion, at most 20 trials, and the safe step when
the search fails. It stops after the iteration whose |g_k| < tol, or
after `maxiter` iterations, and returns the point after the last step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

__all__ = ["minimize", "follow", "MEMORY", "MAX_TRIALS"]

MEMORY = 10
MAX_TRIALS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
INCREASE_FACTOR = 2.0


@dataclass
class _Search:
    count: int
    stepsize: float
    value: float
    grad: torch.Tensor
    slope: float
    decrease_error: float
    interval_found: bool
    done: bool
    failed: bool
    low: float
    value_low: float
    slope_low: float
    high: float
    value_high: float
    slope_high: float
    cubic_ref: float
    value_cubic_ref: float
    safe_stepsize: float
    safe_value: float
    safe_grad: torch.Tensor


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v1 = fb - fa - C * db
    v2 = fc - fa - C * dc
    A = ((dc * dc) * v1 - (db * db) * v2) / denom
    B = (-(dc * dc * dc) * v1 + (db * db * db) * v2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _errors(stepsize, value, slope, value_init, slope_init):
    """(decrease error, curvature error): 0 when met, inf for NaN."""
    dec = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    approx = np.maximum(approx, value - value_init - APPROX_DEC_RTOL * np.abs(value_init))
    dec = np.maximum(np.minimum(approx, dec), 0.0)
    curv = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init), 0.0)
    return (np.inf if np.isnan(dec) else dec), (np.inf if np.isnan(curv) else curv)


def _search(fg, x, u, value0, g0, real):
    """The zoom line search from x along u: (stepsize, evaluations)."""
    slope0 = real(float(torch.dot(u, g0)))
    s = _Search(0, real(0.0), value0, g0, slope0, real(np.inf), False, False, False,
                real(0.0), value0, slope0, real(0.0), value0, slope0, real(0.0), value0,
                real(0.0), value0, g0)
    while not (s.done or s.failed):
        delta = np.abs(s.high - s.low)
        if s.interval_found:
            left, right = np.minimum(s.high, s.low), np.maximum(s.high, s.low)
            cubic = _cubicmin(s.low, s.value_low, s.slope_low, s.high, s.value_high,
                              s.cubic_ref, s.value_cubic_ref)
            quad = _quadmin(s.low, s.value_low, s.slope_low, s.high, s.value_high)
            if left + 0.2 * delta < cubic < right - 0.2 * delta:
                step = cubic
            elif left + 0.1 * delta < quad < right - 0.1 * delta:
                step = quad
            else:
                step = (s.low + s.high) / 2.0
        else:
            step = real(1.0) if s.count == 0 else INCREASE_FACTOR * s.stepsize
        value, grad = fg(x + float(step) * u)
        slope = real(float(torch.dot(grad, u)))
        dec, curv = _errors(step, value, slope, value0, slope0)
        done = max(dec, curv) <= 0.0
        count = s.count + 1
        if s.interval_found:  # the zoom
            safe = ((step, value, grad) if dec <= 0.0 and value < s.safe_value
                    else (s.safe_stepsize, s.safe_value, s.safe_grad))
            high_to_step = dec > 0.0 or value >= s.value_low
            high_to_low = slope * (s.high - s.low) >= 0.0 and not high_to_step
            high = (step, value, slope) if high_to_step else (s.high, s.value_high, s.slope_high)
            high = (s.low, s.value_low, s.slope_low) if high_to_low else high
            low = (s.low, s.value_low, s.slope_low) if high_to_step else (step, value, slope)
            ref = ((s.high, s.value_high) if high_to_step or high_to_low
                   else (s.low, s.value_low))
            gave_up = count >= MAX_TRIALS or (delta <= INTERVAL_THRESHOLD and safe[0] > 0.0)
            found = True
        else:  # the interval search
            safe = ((step, value, grad) if dec <= 0.0
                    else (s.safe_stepsize, s.safe_value, s.safe_grad))
            high_to_step = dec > 0.0 or (value >= s.value and s.count > 0)
            low_to_step = slope >= 0.0 and not high_to_step
            if low_to_step:
                low, high = (step, value, slope), (s.stepsize, s.value, s.slope)
            else:
                low, high = (s.stepsize, s.value, s.slope), (step, value, slope)
            ref = low[:2]
            gave_up = count >= MAX_TRIALS
            found = high_to_step or low_to_step or done
        s = replace(s, count=count, stepsize=step, value=value, grad=grad, slope=slope,
                    decrease_error=dec, interval_found=found, done=done,
                    failed=gave_up and not done, low=low[0], value_low=low[1],
                    slope_low=low[2], high=high[0], value_high=high[1], slope_high=high[2],
                    cubic_ref=ref[0], value_cubic_ref=ref[1], safe_stepsize=safe[0],
                    safe_value=safe[1], safe_grad=safe[2])
        if s.failed and (s.safe_stepsize > 0.0 or np.isinf(s.decrease_error)):
            s = replace(s, stepsize=s.safe_stepsize)
    return s.stepsize, s.count


def _direction(pairs, g, gnorm, real):
    """The two-loop direction at gradient g from the memory's (s, y, rho)
    pairs, oldest first; with no pair, -g scaled by min(1, 1/|g|)."""
    if not pairs:
        gamma = np.minimum(real(1.0) / gnorm, real(1.0))
    else:
        sv, yv = pairs[-1][:2]
        sy, yy = real(float(torch.dot(sv, yv))), real(float(torch.dot(yv, yv)))
        gamma = sy / yy if yy > 0.0 else real(1.0)
    q, alphas = g.clone(), []
    for sv, yv, rho in reversed(pairs):
        alpha = rho * real(float(torch.dot(sv, q)))
        alphas.append(alpha)
        q = q - float(alpha) * yv
    r = float(gamma) * q
    for (sv, yv, rho), alpha in zip(pairs, reversed(alphas)):
        beta = rho * real(float(torch.dot(yv, r)))
        r = r + float(alpha - beta) * sv
    return -r


def _pair(sv, yv, real):
    sy = real(float(torch.dot(sv, yv)))
    return sv, yv, real(0.0) if sy == 0.0 else real(1.0) / sy


def minimize(vg, x0: torch.Tensor, maxiter: int, tol: float = 1e-8, trace: list | None = None):
    """L-BFGS from x0: (x after the last step, iterations, evaluations).
    vg(x) -> (value, gradient) as tensors of x0's dtype. `trace`, if a
    list, gets each iteration's x_k."""
    real = np.float64 if x0.dtype == torch.float64 else np.float32

    def fg(x):
        value, grad = vg(x)
        return real(value.item()), grad

    x = x0.detach().clone()
    pairs: list = []  # (s, y, rho), oldest first
    prev = None
    evaluations = it = 0
    for it in range(maxiter):
        if trace is not None:
            trace.append(x)
        value, g = fg(x)
        evaluations += 1
        gnorm = real(float(torch.linalg.vector_norm(g)))
        if prev is not None:
            pairs = (pairs + [_pair(x - prev[0], g - prev[1], real)])[-MEMORY:]
        u = _direction(pairs, g, gnorm, real)
        prev = (x, g)
        with np.errstate(all="ignore"):  # interpolations that fail read NaN and are not taken
            step, trials = _search(fg, x, u, value, g, real)
        evaluations += trials
        x = x + float(step) * u
        if gnorm < tol:
            break
    return x, it + 1, evaluations


def follow(vg, xs: list, gtol: float) -> tuple:
    """Judge another L-BFGS run by its iterates xs (x_0, ..., x_m; float64).
    At each iteration k < m whose gradient |g(x_k)| is at least `gtol`
    |g(x_0)|, from that run's own state (its iterates, their gradients
    worked out here), the reference's direction d_k at x_k with the memory
    of the pairs (x_j - x_j-1, g_j - g_j-1), j = k - 9 ... k, against the
    run's step s_k = x_k+1 - x_k. Returns (rows, rise, values): rows
    [(k, |g(x_k)| / |g(x_0)|, dir_gap)], dir_gap = |s_k/|s_k| - d_k/|d_k||
    (1 where s_k = 0); rise, over every step, the largest f(x_k+1) - f(x_k)
    over the run's whole descent f(x_0) - min f(x_k) (0 where no step
    rises); values, f(x_k) for every k."""
    real = np.float64
    fg = [(real(v.item()), g) for v, g in map(vg, xs)]
    values = np.array([v for v, _ in fg])
    g0 = float(torch.linalg.vector_norm(fg[0][1]))
    rows = []
    for k in range(len(xs) - 1):
        g = fg[k][1]
        gnorm = real(float(torch.linalg.vector_norm(g)))
        ratio = float(gnorm) / g0
        if not ratio >= gtol:
            continue
        pairs = [_pair(xs[j] - xs[j - 1], fg[j][1] - fg[j - 1][1], real)
                 for j in range(max(1, k - MEMORY + 1), k + 1)]
        d = _direction(pairs, g, gnorm, real)
        s = xs[k + 1] - xs[k]
        snorm = float(torch.linalg.vector_norm(s))
        if snorm == 0.0 or not math.isfinite(snorm):
            rows.append((k, ratio, 1.0))
            continue
        rows.append((k, ratio, float(torch.linalg.vector_norm(
            s / snorm - d / torch.linalg.vector_norm(d)))))
    with np.errstate(all="ignore"):
        rise = float(max(np.max(np.diff(values)), 0.0) / (values[0] - np.min(values)))
    if not math.isfinite(rise):
        rise = 0.0 if np.all(np.diff(values) <= 0.0) else math.inf
    return rows, rise, values
