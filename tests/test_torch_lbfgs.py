"""The port's L-BFGS (`inference/lbfgs.py`) against `optax.lbfgs()` as the
JAX package's `_optax_lbfgs` drives it, on the CPU, on pure functions made
from seeded numpy inputs.

Each function has its gradient written out, the same operations in JAX (a
custom VJP, which optax's line search differentiates) and in torch, so the
two sides evaluate the same floating-point operations.

* Iteration by iteration: at each of 30 iterations the port takes one
  iteration from optax's own state (x_k and its memory, converted), and
  x_{k+1}, the value at x_k, the stepsize (rtol 1e-10), the new memory
  (`_close_memory`, at 1e-10) and the number of line-search trials
  (equal) must be optax's. Held this way
  because XLA's CPU backend fuses a + b * c into one rounding (an FMA)
  where torch rounds twice: on Rosenbrock at d = 2 the two free-running
  trajectories part by 1.9e-8 relative by iteration 30 with every trial
  count still equal.
* Free-running: `minimize` against the JAX package's `_optax_lbfgs` itself
  over 30 iterations (the same iteration count and trial counts at every
  iteration, x at rtol 1e-6), the mirror of its loop used above checked
  against it bit for bit.
* `cubicmin` and `quadmin` against optax's on seeded and degenerate inputs;
  the masked blocks at R = 1, 2 and 4 (equal bits); an f32 lane.

The functions: an ill-conditioned quadratic (cond 1e4, d = 8), Rosenbrock at
d = 2 (from (-1.2, 1)) and d = 10, and a tilted quadratic that is +inf
outside a ball just short of its minimizer (gradient NaN there, as a failed
Cholesky gives): its searches meet +inf and bisect, one fails and takes the
safe step, and from there every trial of 20 lands outside and the iterate
stays at the boundary. Such a stuck run is chaotic on some balls:
steps of 1e-9 make weights of 1e17, and there optax's own jitted step and
the same step run eagerly part (trial counts of 20 against 1). The ball
here is one where they agree over the 30 iterations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.linesearch import _cubicmin, _quadmin

from gaussianprocesses_jl_tpu.inference.optimize import _optax_lbfgs
from gaussianprocesses_jl_tpu_torch.inference import lbfgs
from gaussianprocesses_jl_tpu_torch.inference.lbfgs import Memory

ITERS = 30
FUNCTIONS = ["quadratic", "rosenbrock2", "rosenbrock10", "ball"]


def _quadratic(m, A, b):
    return (lambda x: 0.5 * m.sum(x * (A @ x)) - m.sum(b * x)), (lambda x: A @ x - b)


def _rosenbrock(m):
    cat = jnp.concatenate if m is jnp else torch.cat

    def f(x):
        t = x[1:] - x[:-1] * x[:-1]
        return m.sum(100.0 * t * t + (1.0 - x[:-1]) * (1.0 - x[:-1]))

    def g(x):
        t = x[1:] - x[:-1] * x[:-1]
        z = m.zeros(1, dtype=x.dtype)
        return cat([-400.0 * x[:-1] * t - 2.0 * (1.0 - x[:-1]), z]) + cat([z, 200.0 * t])

    return f, g


def _ball(m, f, g, r):
    """f inside the ball |x| < r, +inf (gradient NaN) outside."""
    def F(x):
        return m.where(m.sum(x * x) < r * r, f(x), m.inf)

    def G(x):
        return m.where(m.sum(x * x) < r * r, g(x), m.nan)

    return F, G


def _pieces(m, name, dtype):
    rng = np.random.RandomState(1)
    if name == "quadratic":
        Q, _ = np.linalg.qr(rng.randn(8, 8))
        A, b = Q @ np.diag(np.logspace(0, 4, 8)) @ Q.T, rng.randn(8)
        x0 = rng.randn(8)
        return _quadratic(m, *(m.asarray(v.astype(dtype)) for v in (A, b))), x0
    if name == "rosenbrock2":
        return _rosenbrock(m), np.array([-1.2, 1.0])
    if name == "rosenbrock10":
        return _rosenbrock(m), np.random.RandomState(2).randn(10)
    a, b = np.array([1.0, 10.0]), np.array([2.0, 0.3])
    r = 0.98 * np.linalg.norm(b / a)  # the minimizer -b / a lies outside
    a, b = (m.asarray(v.astype(dtype)) for v in (a, b))
    f = (lambda x: 0.5 * m.sum(a * x * x) + m.sum(b * x), lambda x: a * x + b)
    return _ball(m, *f, r), np.array([0.5, -1.5])


def _jax_vg(f, g):
    F = jax.custom_vjp(f)
    F.defvjp(lambda x: (f(x), x), lambda x, ct: (ct * g(x),))
    return jax.value_and_grad(F)


def functions(name, dtype=np.float64):
    """(JAX value_and_grad, torch vg, x0) of one test function."""
    (fj, gj), x0 = _pieces(jnp, name, dtype)
    (ft, gt), _ = _pieces(torch, name, dtype)
    return _jax_vg(fj, gj), (lambda x: (ft(x), gt(x))), x0.astype(dtype)


def optax_step(vg):
    """One step of the JAX package's `_optax_lbfgs`, jitted as it jits it."""
    opt = optax.lbfgs()

    def loss(x):
        return vg(x)[0]

    @jax.jit
    def step(carry):
        x, state = carry
        value, grad = vg(x)
        updates, state = opt.update(grad, state, x, value=value, grad=grad, value_fn=loss)
        x = optax.apply_updates(x, updates)
        return (x, state), (value, jnp.linalg.norm(grad))

    return opt, step


def to_memory(st) -> Memory:
    """optax's `ScaleByLBFGSState` as the port's memory: optax writes pair k
    at slot (k - 1) % 10 of a circular buffer, the port keeps the pairs
    oldest first (the slot the next pair overwrites first)."""
    k = int(st.count)
    order = (k - 1 + np.arange(lbfgs.MEMORY)) % lbfgs.MEMORY

    def t(a):
        return torch.tensor(np.asarray(a))

    return Memory(torch.tensor(k), t(st.params), t(st.updates),
                  t(np.asarray(st.diff_params_memory)[order]),
                  t(np.asarray(st.diff_updates_memory)[order]),
                  t(np.asarray(st.weights_memory)[order]))


def optax_rows(vg, x0, maxiter=ITERS, tol=1e-8):
    """`_optax_lbfgs`'s loop, each iteration's ((x_k, state), value,
    (x_{k+1}, state)) kept; returns (rows, the final x, the iteration
    count)."""
    opt, step = optax_step(vg)
    x = jnp.asarray(x0)
    state = opt.init(x)
    rows = []
    for it in range(maxiter):
        before = (x, state)
        (x, state), (value, gnorm) = step((x, state))
        rows.append((before, value, (x, state)))
        if float(gnorm) < tol:
            break
    return rows, np.asarray(x), it + 1


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


def _close_normwise(got, want, rtol, scale=0.0):
    """max |got - want| <= rtol max(max |want|, scale): a difference of two
    points or gradients cancels, and one rounding of either (XLA's FMA)
    is then large beside an entry near 0."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert np.abs(got - want).max(initial=0.0) <= rtol * max(np.abs(want).max(initial=0.0),
                                                              scale)


def _close_memory(got: Memory, want: Memory, rtol=1e-10):
    """The memories agree: the count exactly; x_k, g_k and the differences
    s = x_k - x_{k-1}, y = g_k - g_{k-1} norm-wise, on the scale of |x_k|
    and |g_k| whose rounding they carry (a search stuck at a boundary
    takes steps of 1e-9, and y is then a few roundings of g); each weight
    1/<s, y> through <s, y>, within rtol |s| max(|y|, |g_k|)."""
    assert int(got.count) == int(want.count)
    x, g = (np.abs(t.numpy()).max() for t in (want.params, want.updates))
    for a, b, scale in zip(got[1:5], want[1:5], (x, g, x, g)):
        _close_normwise(a, b, rtol, scale)
    S, Y = want.diff_params.numpy(), want.diff_updates.numpy()
    wg, ww = got.weights.numpy(), want.weights.numpy()
    on = ww != 0
    assert np.array_equal(wg != 0, on)
    g = np.linalg.norm(want.updates.numpy())
    bound = rtol * np.linalg.norm(S, axis=1) * np.maximum(np.linalg.norm(Y, axis=1), g)
    assert (np.abs(1 / wg[on] - 1 / ww[on]) <= bound[on]).all()


@pytest.mark.parametrize("name", FUNCTIONS)
def test_each_iteration_is_optaxs(name):
    """From optax's x_k and memory, one port iteration gives optax's
    x_{k+1}, value, stepsize, trial count and memory, at each of 30
    iterations."""
    vgj, vgt, x0 = functions(name)
    rows, _, n = optax_rows(vgj, x0)
    assert n == ITERS
    counts, safe_steps = [], 0
    for (xj, state), value, (x_next, after) in rows:
        r = lbfgs.iteration(vgt, torch.tensor(np.asarray(xj)), to_memory(state[0]))
        safe_steps += int(bool(r.search.failed) and float(r.search.stepsize) > 0)
        zoom = after[2]
        counts.append(int(zoom.info.num_linesearch_steps))
        assert int(r.search.count) == counts[-1]
        _close(r.x, x_next, 1e-10)
        _close(r.value, value, 1e-10)
        _close(r.search.stepsize, zoom.learning_rate, 1e-10)
        _close_memory(r.memory, to_memory(after[0]))
    if name == "ball":  # the search met +inf: bisected, failed, took a safe step
        assert max(counts) == lbfgs.MAX_TRIALS and min(counts) == 1 and safe_steps


@pytest.mark.parametrize("name", FUNCTIONS)
def test_minimize_follows_optax_lbfgs(name):
    """`minimize` against `_optax_lbfgs` over 30 iterations: the same
    iteration count, trial count at each iteration and, within the FMA
    drift, the same x; the mirror above is `_optax_lbfgs` bit for bit."""
    vgj, vgt, x0 = functions(name)
    rows, xj, n = optax_rows(vgj, x0)
    ref = _optax_lbfgs(vgj, jnp.asarray(x0), ITERS, 1e-8)
    assert ref.n_iter == n and np.array_equal(ref.x, xj)
    trace = []
    res = lbfgs.minimize(vgt, torch.tensor(x0), ITERS, 1e-8, trace=trace)
    assert res.n_iter == n and len(trace) == n
    assert [int(step.search.count) for _, step in trace] == [
        int(after[2].info.num_linesearch_steps) for _, _, (_, after) in rows]
    assert int(res.trials) == sum(int(step.search.count) for _, step in trace)
    _close(res.x, xj, 1e-6)
    for (xt, _), ((xk, _), _, _) in zip(trace, rows):
        _close(xt, xk, 1e-6)


def test_cubicmin_and_quadmin_are_optaxs():
    """Seeded inputs, and degenerate ones: coincident points (a zero
    denominator), negative radicals, a flat quadratic (NaN where optax has
    it; a coincident quadratic gives a)."""
    rng = np.random.RandomState(3)
    P = rng.randn(200, 7)
    P[:20, 3] = P[:20, 0]  # b = a
    P[20:40, 5] = P[20:40, 0]  # c = a
    P[40:60, 5] = P[40:60, 3]  # c = b
    P[60:80, 2] = 0.0
    P[60:80, 4] = P[60:80, 1]  # fpa = 0, fb = fa: B = 0 in the quadratic
    cols = [torch.tensor(P[:, i]) for i in range(7)]
    want = np.asarray(jax.vmap(_cubicmin)(*(jnp.asarray(P[:, i]) for i in range(7))))
    got = lbfgs.cubicmin(*cols).numpy()
    assert np.isnan(want).any() and np.isnan(want[:20]).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, equal_nan=True)
    want = np.asarray(jax.vmap(_quadmin)(*(jnp.asarray(P[:, i]) for i in range(5))))
    got = lbfgs.quadmin(*cols[:5]).numpy()
    assert np.array_equal(want[:20], P[:20, 0]) and np.isnan(want[60:80]).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, equal_nan=True)


@pytest.mark.parametrize("name", ["rosenbrock10", "ball"])
def test_trial_blocks_do_not_change_the_iterates(name):
    """R = 1, 2 and 4 trials a block give the same bits at every iteration;
    a block ends where the search stops, so the evaluations are 1 + R
    ceil(trials / R) an iteration and the host reads ceil(trials / R)."""
    _, vgt, x0 = functions(name)
    runs = {}
    for R in (1, 2, 4):
        trace = []
        res = lbfgs.minimize(vgt, torch.tensor(x0), ITERS, 1e-8, rounds=R, trace=trace)
        counts = [int(step.search.count) for _, step in trace]
        blocks = [-(-c // R) for c in counts]
        assert res.evaluations == sum(1 + R * b for b in blocks)
        assert res.host_reads == sum(blocks)
        runs[R] = (res, trace)
    res1, trace1 = runs[1]
    for R in (2, 4):
        res, trace = runs[R]
        assert torch.equal(res.x, res1.x) and torch.equal(res.value, res1.value)
        for (x, s), (x1, s1) in zip(trace, trace1):
            assert torch.equal(x, x1) and torch.equal(s.search.stepsize, s1.search.stepsize)
            assert all(torch.equal(a, b) for a, b in zip(s.memory, s1.memory))


@pytest.mark.f32
@pytest.mark.parametrize("name", ["quadratic", "rosenbrock10"])
def test_f32_iterations_follow_optax_in_f32(name):
    """The f32 lane: the port in f32 against optax with x64 off (as the
    JAX package runs on the chip), iteration by iteration from optax's
    state for 10 iterations: equal trial counts, x_{k+1} and the stepsize
    at rtol 1e-4 (f32 rounds at 6e-8; the quadratic's cond 1e4 scales a
    rounding of the direction up to 1e-4 relative)."""
    with jax.enable_x64(False):
        vgj, vgt, x0 = functions(name, np.float32)
        rows, _, _ = optax_rows(vgj, x0, maxiter=10)
        for (xj, state), value, (x_next, after) in rows:
            r = lbfgs.iteration(vgt, torch.tensor(np.asarray(xj)), to_memory(state[0]))
            assert r.x.dtype == torch.float32
            assert int(r.search.count) == int(after[2].info.num_linesearch_steps)
            _close(r.value, value, 1e-6)
            _close(r.search.stepsize, after[2].learning_rate, 1e-4)
            _close(r.x, x_next, 1e-4)
