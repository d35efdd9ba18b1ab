"""The port's variational inference (inference/vi.py) against the JAX
package on the same numpy inputs made from a seed, in f64.

Tolerances, stated at each assertion: the ELBO and the negative ELBO's value
rtol 1e-10 and gradient rtol 1e-9 (atol 1e-12), the same algebra on the same
factor; three Adam steps iterate for iterate at rtol 1e-10 (`adam_update`
is optax's `adam` written out), and the update alone against optax's step
for step at 1e-10; the predictive atol
1e-9. The L-BFGS-B optimum: the same scipy run on values equal to rounding,
but the ELBO is flat in log v, so rounding steers the two runs apart and
scipy's ftol stops each at its own point (774 and 824 iterations here): the
ELBO there within rtol 1e-5, m within atol 5e-3 and v within rtol 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.inference import vi as jvi
from gaussianprocesses_jl_tpu_torch.convert import load_approx
from gaussianprocesses_jl_tpu_torch.inference import vi as tvi


def _data():
    rng = np.random.RandomState(3)
    X = rng.uniform(-2, 2, size=(25, 1))
    y = rng.poisson(np.exp(1.0 + 0.8 * np.sin(2 * X[:, 0]))).astype(float)
    return X, y


def _pair(lik="poisson"):
    X, y = _data()
    liks = {"poisson": (gj.PoisLik(), gt.PoisLik()),
            "studentt": (gj.StuTLik(lsigma=jnp.asarray(-0.5), nu=3),
                         gt.StuTLik(lsigma=-0.5, nu=3))}[lik]
    mj = gj.GPA(X, y, gj.MeanConst(beta=np.array(0.3)), gj.Matern(1.5, 0.1, 0.2), liks[0])
    mt = gt.GPA(X, y, gt.MeanConst(beta=0.3), gt.Matern(1.5, 0.1, 0.2), liks[1], device="cpu")
    return mj, mt


@pytest.mark.parametrize("lik", ["poisson", "studentt"])
def test_elbo_and_neg_elbo_value_and_gradient(lik):
    mj, mt = _pair(lik)
    fj, th0j, n = jvi.make_neg_elbo(mj)
    ft, th0t, nt = tvi.make_neg_elbo(mt)
    assert nt == n
    np.testing.assert_allclose(th0t.numpy(), np.asarray(th0j), rtol=1e-12)
    rng = np.random.RandomState(4)
    for theta in (np.asarray(th0j), np.asarray(th0j) + 0.3 * rng.randn(2 * n)):
        vj, gj_ = jax.value_and_grad(fj)(jnp.asarray(theta))
        vt, gt_ = tvi._value_and_grad(ft, torch.tensor(theta))
        np.testing.assert_allclose(float(vt), float(vj), rtol=1e-10)
        np.testing.assert_allclose(gt_.numpy(), np.asarray(gj_), rtol=1e-9, atol=1e-12)
        m, v = theta[:n], np.exp(2 * theta[n:])
        np.testing.assert_allclose(float(gt.elbo(mt, m, v)),
                                   float(gj.elbo(mj, jnp.asarray(m), jnp.asarray(v))),
                                   rtol=1e-10)


def test_three_adam_steps_iterate_for_iterate():
    mj, mt = _pair()
    fj, th0, _ = jvi.make_neg_elbo(mj)
    opt = optax.adam(0.05)
    theta, state = th0, opt.init(th0)
    ref = []
    for _ in range(3):
        g = jax.grad(fj)(theta)
        upd, state = opt.update(g, state, theta)
        theta = optax.apply_updates(theta, upd)
        ref.append(np.asarray(theta))
    for k in range(1, 4):
        Q = gt.vi(mt, nits=k, method="adam", lr=0.05)
        n = Q.m.shape[0]
        np.testing.assert_allclose(Q.m.numpy(), ref[k - 1][:n], rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(Q.v.numpy(), np.exp(2 * ref[k - 1][n:]), rtol=1e-10)


def test_adam_update_matches_optax_step_for_step():
    """`adam_update` and `adam` against `optax.adam(0.05)` on a quadratic
    with gradients of mixed scales over 30 steps: every iterate, moment and
    step count at rtol 1e-10, f64."""
    A = np.diag(np.logspace(-2, 2, 6))
    b = np.random.RandomState(8).randn(6)

    def fj(x):
        return 0.5 * x @ jnp.asarray(A) @ x - jnp.asarray(b) @ x

    def ft(x):
        return 0.5 * x @ torch.as_tensor(A) @ x - torch.as_tensor(b) @ x

    opt = optax.adam(0.05)
    xj = jnp.asarray(np.linspace(-1.0, 1.0, 6))
    state = opt.init(xj)
    xt = torch.as_tensor(np.asarray(xj))
    m, v, t = torch.zeros(6, dtype=torch.float64), torch.zeros(6, dtype=torch.float64), \
        torch.zeros((), dtype=torch.float64)
    iterates = []
    for _ in range(30):
        upd, state = opt.update(jax.grad(fj)(xj), state, xj)
        xj = optax.apply_updates(xj, upd)
        _, g = tvi._value_and_grad(ft, xt)
        xt, m, v, t = tvi.adam_update(xt, g, m, v, t, 0.05)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(m.numpy(), np.asarray(state[0].mu), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(v.numpy(), np.asarray(state[0].nu), rtol=1e-10, atol=1e-14)
        assert float(t) == int(state[0].count)
        iterates.append(xt)
    x_fit, values = tvi.adam(ft, torch.as_tensor(np.linspace(-1.0, 1.0, 6)), 30, 0.05)
    assert torch.equal(x_fit, iterates[-1]) and values.shape == (30,)
    assert torch.equal(values[1], ft(iterates[0]))


def test_lbfgs_optimum_matches_jax_and_raises_the_elbo():
    mj, mt = _pair()
    Qj = gj.vi(mj, nits=2000)
    Qt = gt.vi(mt, nits=2000)
    np.testing.assert_allclose(float(gt.elbo(mt, Qt.m, Qt.v)), float(gj.elbo(mj, Qj.m, Qj.v)),
                               rtol=1e-5)
    np.testing.assert_allclose(Qt.m.numpy(), np.asarray(Qj.m), atol=5e-3)
    np.testing.assert_allclose(Qt.v.numpy(), np.asarray(Qj.v), rtol=3e-2)
    e0 = float(gt.elbo(mt, mt.mean.mean(mt.x), mt.kernel.diag(mt.x)))
    assert float(gt.elbo(mt, Qt.m, Qt.v)) > e0
    with pytest.raises(ValueError, match="unknown vi method"):
        gt.vi(mt, method="sgd")


@pytest.mark.parametrize("full_cov", [False, True])
def test_vi_predict_matches_jax(full_cov):
    """vi_predict_f (variance or covariance) and vi_predict_y at 7 new
    points from the same Q, carried across by load_approx: the mean atol
    1e-9, the variance or covariance atol 1e-8 (A = K^-1 Kxs carries the
    rounding of a K whose condition number is ~1e7 at the f64 nugget);
    vi_predict_y rtol 1e-8 (its variance is a quadrature's second moment
    less the squared mean, which cancels where the rate is large)."""
    mj, mt = _pair()
    rng = np.random.RandomState(8)
    m, v = 1.0 + 0.3 * rng.randn(25), np.exp(-1.0 + 0.2 * rng.randn(25))
    Qj = gj.Approx(m=jnp.asarray(m), v=jnp.asarray(v))
    Qt = load_approx(mt, Qj.m, Qj.v)
    xs = np.linspace(-2, 2, 7)[:, None]
    muj, cj = gj.vi_predict_f(mj, Qj, jnp.asarray(xs), full_cov=full_cov)
    mut, ct = gt.vi_predict_f(mt, Qt, xs, full_cov=full_cov)
    np.testing.assert_allclose(mut.numpy(), np.asarray(muj), atol=1e-9)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-8)
    if not full_cov:
        for a, b in zip(gt.vi_predict_y(mt, Qt, xs), gj.vi_predict_y(mj, Qj, jnp.asarray(xs))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8)
    with pytest.raises(ValueError, match="must be"):
        load_approx(mt, m[:3], v)


def test_nugget_option_defaults_to_the_one_vi_fits_with():
    """make_neg_elbo and vi_predict_f with `nugget` given as the dtype's own
    are the defaults, bit for bit; the f64 model at the f32 nugget (1e-4) is
    the function the f32 model computes: the f32 model's negative ELBO
    within rtol 1e-3 of it (3.1e-4 here: f32 rounding of diag(K^-1), whose
    entries reach ~1/nugget), and at the f64 nugget (1e-6) it is another
    function (more than 10x the f32 model's distance away)."""
    from gaussianprocesses_jl_tpu_torch.models.gpa import gpa_nugget

    _, mt = _pair()
    X, y = _data()
    m32 = gt.GPA(X.astype(np.float32), y.astype(np.float32), gt.MeanConst(beta=0.3),
                 gt.Matern(1.5, 0.1, 0.2), gt.PoisLik(), device="cpu")
    f, theta0, _ = tvi.make_neg_elbo(mt)
    f_own = tvi.make_neg_elbo(mt, nugget=gpa_nugget(torch.float64))[0]
    assert float(f(theta0)) == float(f_own(theta0))
    Q = tvi.Approx(m=theta0[:25], v=torch.exp(2.0 * theta0[25:]))
    xs = np.linspace(-2, 2, 7)[:, None]
    for a, b in zip(gt.vi_predict_f(mt, Q, xs), gt.vi_predict_f(mt, Q, xs, nugget=1e-6)):
        assert torch.equal(a, b)
    f4 = tvi.make_neg_elbo(mt, nugget=gpa_nugget(torch.float32))[0]
    f32 = tvi.make_neg_elbo(m32)[0]
    v4, v32 = float(f4(theta0)), float(f32(theta0.float()))
    np.testing.assert_allclose(v32, v4, rtol=1e-3)
    assert abs(float(f(theta0)) - v4) > 10 * abs(v32 - v4)


def test_vi_study_gap_measurements_at_a_small_size(monkeypatch):
    """`perf/vi_study.py --f32-gap` at n = 200 (its card run needs CUDA):
    the f64 objective and predictive move by rounding alone on the
    observations permuted and with the gram by direct differences (under
    1e-8 of their scale here), the f32 objective and predictive hold the
    f64 ones to f32 rounding (under 1e-1), the nugget moves the
    predictive's variance far more, and the plain gram's size budget is
    given back."""
    from gaussianprocesses_jl_tpu_torch.ops import distance
    from gaussianprocesses_jl_tpu_torch.perf import vi_study

    monkeypatch.setattr(vi_study, "N", 200)
    monkeypatch.setattr(vi_study, "NITS", 5)
    budget = distance._EXACT_BROADCAST_BUDGET
    out = vi_study.f32_gap()
    assert distance._EXACT_BROADCAST_BUDGET == budget
    assert isinstance(out["cpu_f32_factor_ok"], bool)
    assert out["cpu_f32_factor_ok_direct"]
    for k, v in out.items():
        if k.startswith(("objective_f64", "predictive_f64")) and k.endswith(
                ("_permuted", "_direct")):
            assert max(v) < 1e-8, (k, v)
        elif k.startswith(("objective_f32", "predictive_f32")):
            assert max(v) < 1e-1, (k, v)  # f32 rounding at n = 200
    assert out["predictive_f64_1e-4_vs_f64_1e-6"][1] > 1e-4


def _nonpd_pair(dtype):
    """The Poisson GPA under Const(20): K = e^40 11^T, whose factor with the
    nugget fails at either precision."""
    X, y = _data()
    mj = gj.GPA(X, y, gj.MeanZero(), gj.Const(20.0), gj.PoisLik())
    mt = gt.GPA(X.astype(dtype), y, gt.MeanZero(), gt.Const(20.0), gt.PoisLik(), device="cpu")
    return mj, mt


_NONPD_ENTRIES = {
    "vi_lbfgs": lambda m: gt.vi(m, nits=3),
    "vi_adam": lambda m: gt.vi(m, nits=3, method="adam"),
    "elbo": lambda m: gt.elbo(m, torch.zeros(m.x.shape[0]), torch.ones(m.x.shape[0])),
    "make_neg_elbo": tvi.make_neg_elbo,
    "vi_predict_f": lambda m: gt.vi_predict_f(
        m, tvi.Approx(m=m.x.new_zeros(m.x.shape[0]), v=m.x.new_ones(m.x.shape[0])), m.x),
    "sharded_vi": lambda m: gt.sharded_vi(m, gt.make_mesh({"chains": 1}, device="cpu"),
                                          nits=2),
    "sharded_vi_train": lambda m: gt.sharded_vi_train(m, gt.make_mesh({"data": 1},
                                                                      device="cpu"), nits=2),
    "sharded_elbo": lambda m: gt.sharded_elbo(m, torch.zeros(m.x.shape[0]),
                                              torch.ones(m.x.shape[0]),
                                              gt.make_mesh({"data": 1}, device="cpu")),
    "gpa_predict_f": lambda m: m.predict_f(m.x),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("entry", sorted(_NONPD_ENTRIES))
def test_failed_prior_factor_raises(entry, dtype):
    """A prior whose factor fails raises ValueError in every VI entry point
    (and the latent predictive), where the JAX package fits K = I: its
    factor's flag is False there and its objective finite at m = 0, v = 1."""
    mj, mt = _nonpd_pair(dtype)
    with pytest.raises(ValueError, match="not positive definite"):
        _NONPD_ENTRIES[entry](mt)
    if entry == "make_neg_elbo" and dtype == np.float64:
        assert not bool(mj.covstrat.build(mj.params.kernel, 1e-6, mj.x).ok)
        fj, th0j, _ = jvi.make_neg_elbo(mj)
        assert np.isfinite(float(fj(jnp.zeros_like(th0j))))
