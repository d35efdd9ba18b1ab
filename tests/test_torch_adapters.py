"""The port's GPRegressor (sklearn.py) against the JAX package's on the same
numpy data, and its plot helpers (plot.py): predictions, standard
deviations and the log marginal likelihood agree after fit(optimize=False)
(rtol 1e-10) and after fit to the optimum (rtol 1e-6); the estimator
protocol and its errors before fit; the plots draw (matplotlib's Agg)."""
import numpy as np
import pytest

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.sklearn import GPRegressor as JRegressor
from gaussianprocesses_jl_tpu_torch.sklearn import GPRegressor


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(30, 2)
    return X, np.sin(X[:, 0]) + 0.1 * rng.randn(30), rng.randn(7, 2)


@pytest.mark.parametrize("optimize,rtol", [(False, 1e-10), (True, 1e-6)])
def test_predictions_and_mll_match_jax(optimize, rtol):
    X, y, Xs = _data()
    jr = JRegressor(kernel=gj.SE(0.0, 0.0), lognoise=-1.0, optimize=optimize,
                    maxiter=200).fit(X, y)
    tr = GPRegressor(kernel=gt.SE(0.0, 0.0), lognoise=-1.0, optimize=optimize, maxiter=200,
                     device="cpu").fit(X, y)
    for got, ref in zip(tr.predict(Xs, return_std=True), jr.predict(Xs, return_std=True)):
        assert isinstance(got, np.ndarray) and got.shape == (7,)
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())
    np.testing.assert_allclose(tr.log_marginal_likelihood(), jr.log_marginal_likelihood(),
                               rtol=rtol)
    np.testing.assert_allclose(tr.score(X, y), jr.score(X, y), rtol=rtol)
    if optimize:
        assert tr.score(X, y) > 0.8


def test_the_estimator_protocol():
    est = GPRegressor(lognoise=-1.0, maxiter=60, device="cpu")
    assert est.get_params()["lognoise"] == -1.0 and est.get_params()["device"] == "cpu"
    est2 = est.clone().set_params(maxiter=40)
    assert est2.get_params()["maxiter"] == 40 and est.maxiter == 60
    X, y, _ = _data()
    pred = est.fit(X, y).predict(X)
    assert pred.shape == (30,) and pred.dtype == np.float64


def test_errors_before_fit():
    est = GPRegressor(device="cpu")
    with pytest.raises(RuntimeError):
        est.predict(np.zeros((2, 1)))
    with pytest.raises(RuntimeError):
        est.log_marginal_likelihood()
    with pytest.raises(ValueError):
        est.set_params(bogus=1)


def test_plot_helpers():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    from gaussianprocesses_jl_tpu_torch.plot import plot_gp, plot_gp_2d

    rng = np.random.RandomState(0)
    x = rng.rand(15)
    m = gt.GPE(x, np.sin(4 * x), kernel=gt.SE(0.0, 0.0), lognoise=-2.0, device="cpu")
    ax = plot_gp(m)
    assert len(ax.lines) == 1 and len(ax.collections) == 2
    X2 = rng.randn(20, 2)
    m2 = gt.GPE(X2, X2[:, 0] * X2[:, 1], kernel=gt.SE(0.0, 0.0), lognoise=-2.0, device="cpu")
    _, im = plot_gp_2d(m2, n_grid=10, ax=plt.figure().gca())
    assert im.get_array().size == 100
    with pytest.raises(ValueError):
        plot_gp(m2)
    with pytest.raises(ValueError):
        plot_gp_2d(m)
    plt.close("all")
