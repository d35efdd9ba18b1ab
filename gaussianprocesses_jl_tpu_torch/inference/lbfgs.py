"""optax's L-BFGS on torch tensors: the port's `optimize(method='optax')`.

The JAX package jits one step of `optax.lbfgs()` (optax 0.2.6) around the
model's value and gradient and runs it until ||g|| < tol. optax is a JAX
library, so this module carries its own copy of the algorithm, with
optax's defaults:

  * the direction (`scale_by_lbfgs` and `_precondition_by_lbfgs`): a memory
    of `MEMORY` pairs (s, y) of parameter and gradient differences, weights
    rho = 1/<s, y> (0 where <s, y> = 0), the two-loop recursion from the
    scaled identity gamma = <s, y>/<y, y> of the newest pair, and at the
    first iteration the gradient scaled by min(1, 1/||g||); then `scale(-1)`;
  * the step (`scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy='one')`): Nocedal and Wright's interval search
    and zoom (algorithms 3.5 and 3.6) with cubic, quadratic and bisection
    interpolation, Hager and Zhang's approximate decrease criterion, a
    trial stepsize of 1 at every iteration, and, when the search fails, the
    safe step: the best stepsize that met the decrease criterion, if any.

The memory keeps its pairs oldest first and shifts one in each iteration
where optax writes a circular buffer at count % MEMORY: the two loops
visit the same pairs in the same order. Every branch on a value is a
`torch.where`, so a CUDA graph can hold it.

optax's `while_loop` over the search's trials becomes blocks of `rounds`
masked trials: a trial after the search has stopped leaves every tensor of
its state as it was, so a block runs a fixed number of trials (each one
evaluation of the objective) whatever the search needs. One iteration, as
the JAX package's loop drives it: the evaluation at x_k, the direction,
the search's start and its first block (`_start`), then further blocks
(`_finish`) while the search runs and fewer than `MAX_TRIALS` trials have
run; the host reads one flag a block, the first with ||g_k||. The search
stops itself at `MAX_TRIALS`, so the iterates do not depend on `rounds`.

On the card each of the two parts replays a CUDA graph (`utils/graphs.py`)
kept for the objective's owner, the counterpart of the JAX package's
`jax.jit(step)`; the objective is then a `graphs.Bound`, whose function
and arguments the graphs take as their own (the model's data are inputs of
the graphs, not constants in them). `graphs.eager()` runs the same blocks
eagerly. A distributed strategy over more than one process runs inside
`graphs.eager()`, as its other paths do.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..utils import graphs
from ..utils.profiling import span

__all__ = ["minimize", "iteration", "LBFGSResult", "Iteration", "Memory", "Search", "direction",
           "init_memory", "init_search", "trial", "cubicmin", "quadmin", "MEMORY", "MAX_TRIALS",
           "TRIAL_BLOCK"]

MEMORY = 10  # (s, y) pairs
MAX_TRIALS = 20  # line-search trials an iteration
# trials a block (a graph replay, one host read): the shortest iteration of
# R = 1, 2 and 4 on an H100, on the headline and on configuration #2's GPA
# (`perf/lbfgs_study.py`'s sweep, PERF.md §5)
TRIAL_BLOCK = 1

# the zoom line search's defaults in optax
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0
STEPSIZE_GUESS = 1.0


class Memory(NamedTuple):
    """`ScaleByLBFGSState`: the iteration count, the last parameters and
    gradient, the pairs' differences (MEMORY, p), oldest first, and their
    weights (MEMORY,)."""
    count: torch.Tensor
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor
    diff_updates: torch.Tensor
    weights: torch.Tensor


class Search(NamedTuple):
    """`ZoomLinesearchState` (its stepsize guess is the constant 1)."""
    count: torch.Tensor
    params: torch.Tensor
    updates: torch.Tensor
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    value_init: torch.Tensor
    slope_init: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


def _scalar(x, like):
    return torch.full((), x, dtype=like.dtype, device=like.device)


def init_memory(x) -> Memory:
    """`scale_by_lbfgs`'s init at the parameters x (p,)."""
    zeros = torch.zeros((MEMORY, x.numel()), dtype=x.dtype, device=x.device)
    return Memory(torch.zeros((), dtype=torch.int64, device=x.device), torch.zeros_like(x),
                  torch.zeros_like(x), zeros, zeros.clone(),
                  torch.zeros(MEMORY, dtype=x.dtype, device=x.device))


def direction(g, x, mem: Memory):
    """The update -P_k g_k at x_k and the new memory (`scale_by_lbfgs`
    followed by `scale(-1)`)."""
    first = mem.count == 0
    dw = x - mem.params
    du = g - mem.updates
    sy = torch.dot(du, dw)
    weight = torch.where(sy == 0.0, 0.0, 1.0 / sy)
    # the differences are not defined at the first iteration: kept at 0
    dw = torch.where(first, 0.0, dw)
    du = torch.where(first, 0.0, du)
    weight = torch.where(first, 0.0, weight)
    S = torch.cat([mem.diff_params[1:], dw[None]])
    Y = torch.cat([mem.diff_updates[1:], du[None]])
    rho = torch.cat([mem.weights[1:], weight[None]])

    denominator = torch.sum(du * du)
    gamma = torch.where(denominator > 0.0, sy / denominator, 1.0)
    # the first step: the gradient scaled by a capped reciprocal of its norm
    capped_inv_norm = torch.clamp_max(1.0 / torch.sqrt(torch.sum(g * g)), 1.0)
    gamma = torch.where(first, capped_inv_norm, gamma)

    vec, alphas = g, [None] * MEMORY
    for i in reversed(range(MEMORY)):  # newest first
        alphas[i] = rho[i] * torch.dot(S[i], vec)
        vec = vec + (-alphas[i]) * Y[i]
    vec = gamma * vec
    for i in range(MEMORY):
        beta = rho[i] * torch.dot(Y[i], vec)
        vec = vec + (alphas[i] - beta) * S[i]
    return -vec, Memory(mem.count + 1, x, g, S, Y, rho)


def cubicmin(a, fa, fpa, b, fb, c, fc):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax's `_cubicmin`); NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v1 = fb - fa - C * db
    v2 = fc - fa - C * dc
    A = ((dc * dc) * v1 + (-(db * db)) * v2) / denom
    B = ((-(dc * (dc * dc))) * v1 + (db * (db * db)) * v2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax's `_quadmin`)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


def init_search(x, u, value, g) -> Search:
    """The zoom line search's state at x_k along u, value and gradient at x_k."""
    slope = torch.dot(u, g)
    zero, inf, no = _scalar(0.0, value), _scalar(math.inf, value), torch.zeros(
        (), dtype=torch.bool, device=value.device)
    return Search(
        count=torch.zeros((), dtype=torch.int64, device=value.device),
        params=x, updates=u, stepsize=zero, value=value, grad=g, slope=slope,
        value_init=value, slope_init=slope,
        decrease_error=inf, curvature_error=inf, error=inf,
        interval_found=no, done=no, failed=no,
        low=zero, value_low=value, slope_low=slope,
        high=zero, value_high=value, slope_high=slope,
        cubic_ref=zero, value_cubic_ref=value,
        safe_stepsize=zero, safe_value=value, safe_grad=g)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's criterion or Hager and Zhang's approximate one, whichever
    is smaller; 0 when met, inf for NaN."""
    decrease_error = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    approx = torch.maximum(approx, delta_values)
    decrease_error = torch.minimum(approx, decrease_error)
    decrease_error = torch.clamp_min(decrease_error, 0.0)
    return torch.where(torch.isnan(decrease_error), math.inf, decrease_error)


def _curvature_error(slope, slope_init):
    curvature_error = torch.abs(slope) - CURV_RTOL * torch.abs(slope_init)
    curvature_error = torch.clamp_min(curvature_error, 0.0)
    return torch.where(torch.isnan(curvature_error), math.inf, curvature_error)


def _where(cond, new: tuple, old: tuple) -> list:
    return [torch.where(cond, a, b) for a, b in zip(new, old)]


def _middle(s: Search):
    """The zoom's next stepsize: the cubic's minimizer, else the
    quadratic's, else the bisection."""
    delta = torch.abs(s.high - s.low)
    left = torch.minimum(s.high, s.low)
    right = torch.maximum(s.high, s.low)
    cubic_chk = 0.2 * delta
    quad_chk = 0.1 * delta
    middle_cubic = cubicmin(s.low, s.value_low, s.slope_low, s.high, s.value_high,
                            s.cubic_ref, s.value_cubic_ref)
    use_cubic = (middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk)
    middle_quad = quadmin(s.low, s.value_low, s.slope_low, s.high, s.value_high)
    use_quad = (~use_cubic) & (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk)
    use_bisection = (~use_cubic) & (~use_quad)
    middle = torch.where(use_cubic, middle_cubic, s.cubic_ref)
    middle = torch.where(use_quad, middle_quad, middle)
    return torch.where(use_bisection, (s.low + s.high) / 2.0, middle), delta


def _interval_step(s: Search, new, value, grad, slope, dec, curv, error) -> Search:
    """`_search_interval` after its evaluation at `new`."""
    safe = _where(dec <= TOL, (new, value, grad), (s.safe_stepsize, s.safe_value, s.safe_grad))
    set_high_to_new = (dec > 0.0) | ((value >= s.value) & (s.count > 0))
    set_low_to_new = (slope >= 0.0) & (~set_high_to_new)
    low, value_low, slope_low, high, value_high, slope_high = _where(
        set_low_to_new, (new, value, slope, s.stepsize, s.value, s.slope),
        (s.stepsize, s.value, s.slope, new, value, slope))
    done = error <= TOL
    return s._replace(
        count=s.count + 1, stepsize=new, value=value, grad=grad, slope=slope,
        decrease_error=dec, curvature_error=curv, error=error,
        interval_found=set_high_to_new | set_low_to_new | done, done=done,
        failed=(s.count + 1 >= MAX_TRIALS) & ~done,
        low=low, value_low=value_low, slope_low=slope_low,
        high=high, value_high=value_high, slope_high=slope_high,
        cubic_ref=low, value_cubic_ref=value_low,
        safe_stepsize=safe[0], safe_value=safe[1], safe_grad=safe[2])


def _zoom_step(s: Search, middle, delta, value, grad, slope, dec, curv, error) -> Search:
    """`_zoom_into_interval` after its evaluation at `middle`."""
    safe = _where((dec <= TOL) & (value < s.safe_value), (middle, value, grad),
                  (s.safe_stepsize, s.safe_value, s.safe_grad))
    done = error <= TOL
    set_high_to_middle = (dec > 0.0) | (value >= s.value_low)
    set_high_to_low = (slope * (s.high - s.low) >= 0.0) & (~set_high_to_middle)
    set_low_to_middle = ~set_high_to_middle
    high = _where(set_high_to_middle, (middle, value, slope),
                  (s.high, s.value_high, s.slope_high))
    high = _where(set_high_to_low, (s.low, s.value_low, s.slope_low), high)
    low = _where(set_low_to_middle, (middle, value, slope), (s.low, s.value_low, s.slope_low))
    cubic_ref = _where(set_high_to_middle | set_high_to_low, (s.high, s.value_high),
                       (s.low, s.value_low))
    # stop once the interval is below the threshold and a stepsize with
    # sufficient decrease is known
    presumably_failed = (s.count + 1 >= MAX_TRIALS) | (
        (delta <= INTERVAL_THRESHOLD) & (safe[0] > 0.0))
    return s._replace(
        count=s.count + 1, stepsize=middle, value=value, grad=grad, slope=slope,
        decrease_error=dec, curvature_error=curv, error=error,
        done=done, failed=presumably_failed & ~done,
        low=low[0], value_low=low[1], slope_low=low[2],
        high=high[0], value_high=high[1], slope_high=high[2],
        cubic_ref=cubic_ref[0], value_cubic_ref=cubic_ref[1],
        safe_stepsize=safe[0], safe_value=safe[1], safe_grad=safe[2])


def trial(fn: Callable, args: tuple, s: Search) -> Search:
    """One masked trial of the search (optax's `step_fn`): the interval
    search's next stepsize, or the zoom's, one evaluation of fn there, the
    state updated, and the safe step taken if the search has just failed.
    A search that had stopped is returned as it was."""
    active = ~(s.done | s.failed)
    zoom = s.interval_found
    middle, delta = _middle(s)
    larger = torch.where(s.count == 0, STEPSIZE_GUESS, INCREASE_FACTOR * s.stepsize)
    stepsize = torch.where(zoom, middle, larger)
    value, grad = fn(s.params + stepsize * s.updates, *args)
    slope = torch.dot(grad, s.updates)
    dec = _decrease_error(stepsize, value, slope, s.value_init, s.slope_init)
    curv = _curvature_error(slope, s.slope_init)
    error = torch.maximum(dec, curv)
    zoomed = _zoom_step(s, stepsize, delta, value, grad, slope, dec, curv, error)
    searched = _interval_step(s, stepsize, value, grad, slope, dec, curv, error)
    new = Search(*_where(zoom, zoomed, searched))
    # the safe step (`_try_safe_step`)
    take_safe = new.failed & ((new.safe_stepsize > 0.0) | torch.isinf(new.decrease_error))
    stepsize, value, grad = _where(take_safe, (new.safe_stepsize, new.safe_value, new.safe_grad),
                                   (new.stepsize, new.value, new.grad))
    new = new._replace(stepsize=stepsize, value=value, grad=grad)
    return Search(*_where(active, new, s))


def _finish(fn, args, s: Search, rounds: int):
    """`rounds` masked trials from s: (the state, x_{k+1} were the search
    to stop here, whether it runs on)."""
    for _ in range(rounds):
        s = trial(fn, args, s)
    return s, s.params + s.stepsize * s.updates, ~(s.done | s.failed)


def _start(fn, rounds, x, mem, args):
    """The iteration's start: the value and gradient at x_k, the direction,
    the search's state and its first `rounds` trials. Returns (value at x_k,
    [runs on, ||g_k||], memory, search, x_{k+1} were it to stop here)."""
    value, g = fn(x, *args)
    gnorm = torch.linalg.vector_norm(g)
    u, mem = direction(g, x, mem)
    s, x_next, more = _finish(fn, args, init_search(x, u, value, g), rounds)
    return value, torch.stack([more.to(g.dtype), gnorm]), mem, s, x_next


def _parts(vg):
    if isinstance(vg, graphs.Bound):
        return vg.owner, vg.fn, vg.args
    return vg, vg, ()


class Iteration(NamedTuple):
    value: torch.Tensor  # the objective at x_k
    gnorm: float  # ||g_k||, read with the first block's flag
    memory: Memory  # after the direction at x_k
    search: Search  # the line search's final state
    x: torch.Tensor  # x_{k+1}
    ran: int  # trials run, masked ones included
    reads: int  # host reads: one a block


def iteration(vg: Callable, x: torch.Tensor, mem: Memory, rounds: int = TRIAL_BLOCK) -> Iteration:
    """One L-BFGS iteration from x_k and the memory, as one step of the
    JAX package's jitted loop: the start graph, then a block graph while
    the line search runs (`vg` as in `minimize`)."""
    owner, fn, args = _parts(vg)
    value, status, mem, s, x_next = graphs.run(
        owner, lambda *a: _start(fn, rounds, *a), x, mem, args, static=("lbfgs_start", rounds))
    more, gnorm = status.tolist()
    ran, reads = rounds, 1
    while more and ran < MAX_TRIALS:
        s, x_next, more = graphs.run(
            owner, lambda *a: _finish(fn, a[1], a[0], rounds), s, args,
            static=("lbfgs_block", rounds))
        more = bool(more)
        ran, reads = ran + rounds, reads + 1
    return Iteration(value, gnorm, mem, s, x_next, ran, reads)


class LBFGSResult(NamedTuple):
    x: torch.Tensor  # the point after the last step
    value: torch.Tensor  # the objective at the last x_k
    n_iter: int
    evaluations: int  # the objective's evaluations, masked trials included
    trials: torch.Tensor  # the line search's trials, summed over the iterations
    host_reads: int


def minimize(vg: Callable, x0: torch.Tensor, maxiter: int = 200, tol: float = 1e-8,
             rounds: int = TRIAL_BLOCK, trace: list | None = None) -> LBFGSResult:
    """Minimize vg's value from x0 as the JAX package's `_optax_lbfgs` does:
    each iteration evaluates (value, g) at x_k, takes the L-BFGS step, and
    stops after it when ||g_k|| < tol, or after maxiter iterations. `vg`:
    x -> (value, gradient), a `graphs.Bound` to hold it inside the graphs;
    `rounds`: trials a block. `trace`, if a list, gets each iteration's
    (x_k, `Iteration`)."""
    x = x0.detach().clone()
    mem = init_memory(x)
    value = torch.full((), math.inf, dtype=x.dtype, device=x.device)
    trials = torch.zeros((), dtype=torch.int64, device=x.device)
    it = evaluations = reads = 0
    for it in range(maxiter):
        with span("gp.lbfgs.iteration"):
            step = iteration(vg, x, mem, rounds)
        if trace is not None:
            trace.append((x, step))
        value, mem, x = step.value, step.memory, step.x
        evaluations += 1 + step.ran
        reads += step.reads
        trials = trials + step.search.count
        if step.gnorm < tol:
            break
    return LBFGSResult(x, value, it + 1, evaluations, trials, reads)
