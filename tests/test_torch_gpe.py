"""The slice as a whole: the port's GPE against the JAX package's GPE.

Target and gradient (f64: target rtol 1e-10; gradient rtol 1e-8, atol 1e-10,
because the triangular-inverse recursion rounds differently), an f32 lane,
heteroscedastic noise, a failed factorization, prediction, the parameter
surface and the L-BFGS-B optimizer (same start, same optimum, rtol 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.utils import priors as jpriors
from gaussianprocesses_jl_tpu_torch.inference import lbfgs
from gaussianprocesses_jl_tpu_torch.utils import priors as tpriors

from test_torch_lbfgs import optax_rows


def _flagship_data(n=256, d=4):
    rng = np.random.RandomState(0)
    return rng.randn(n, d), np.sin(rng.randn(n))


def _flagship(g, X, y, **kw):
    kern = g.SE(0.2, 0.1) + g.RQ(0.1, 0.0, -0.2) * g.Matern(1.5, 0.3, 0.0)
    return g.GPE(X, y, g.MeanConst(beta=np.array(0.0)), kern, lognoise=-1.0, **kw)


def _se10_data(n=300, d=10):
    rng = np.random.RandomState(42)
    return rng.randn(n, d), rng.randn(n)


def _se10(g, X, y, **kw):
    return g.GPE(X, y, g.MeanZero(), g.SE(0.0, 0.0), lognoise=-1.0, **kw)


def _pair(make, data):
    X, y = data()
    return make(gj, X, y), make(gt, X, y, device="cpu")


def _check_target_grad(mj, mt):
    tj, gj_ = mj.target_and_dtarget()
    tt, gt_ = mt.target_and_dtarget()
    assert gt_.dtype == torch.float64
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-10)
    np.testing.assert_allclose(gt_.numpy(), np.asarray(gj_), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("model", ["flagship", "se10"])
def test_target_and_gradient_match_jax(model):
    make, data = {"flagship": (_flagship, _flagship_data), "se10": (_se10, _se10_data)}[model]
    mj, mt = _pair(make, data)
    assert mt.get_params().numpy().tolist() == np.asarray(mj.get_params()).tolist()
    _check_target_grad(mj, mt)
    np.testing.assert_allclose(float(mt.mll), float(mj.mll), rtol=1e-10)
    np.testing.assert_allclose(float(mt.target), float(mj.target), rtol=1e-10)
    np.testing.assert_allclose(mt.dtarget.numpy(), np.asarray(mj.dtarget),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.f32
def test_f32_lane():
    """The port in f32 on the CPU against the JAX package in f64: target
    rtol 1e-4, gradient atol 5e-3 max|g| (as tests/test_f32_lane.py)."""
    X, y = _flagship_data()
    mj = _flagship(gj, X, y)
    mt = _flagship(gt, X.astype(np.float32), y.astype(np.float32), device="cpu")
    assert mt.params.flat_params().dtype == torch.float32
    tj, g_j = mj.target_and_dtarget()
    tt, g_t = mt.target_and_dtarget()
    assert tt.dtype == torch.float32
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-4)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=5e-3 * np.abs(g_j).max())


def _hetero(g, X, y, **kw):
    ln = np.linspace(-1.5, -0.5, len(y))
    return g.GPE(X, y, g.MeanZero(), g.Matern(2.5, 0.2, 0.1), lognoise=ln, **kw)


def test_heteroscedastic_noise():
    mj, mt = _pair(_hetero, lambda: _flagship_data(60, 2))
    assert mt.params.lognoise.shape == (60,)
    _check_target_grad(mj, mt)
    X = mt.x.numpy()
    mu, var = mt.predict_y(X)
    muj, varj = mj.predict_y(X)
    np.testing.assert_allclose(mu.numpy(), np.asarray(muj), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var.numpy(), np.asarray(varj), rtol=1e-9, atol=1e-11)
    _, cov = mt.predict_y(X, full_cov=True)
    _, covj = mj.predict_y(X, full_cov=True)
    np.testing.assert_allclose(cov.numpy(), np.asarray(covj), rtol=1e-9, atol=1e-11)
    with pytest.raises(ValueError):
        mt.predict_y(X[:5])
    np.testing.assert_allclose(gt.noise_variance(mt).numpy(),
                               np.asarray(gj.noise_variance(mj)), rtol=1e-14)


def test_failed_factorization_is_minus_inf_not_an_exception():
    rng = np.random.RandomState(0)
    x, y = rng.rand(40), rng.randn(40)
    mj = gj.GPE(x, y, kernel=gj.Const(lsigma=jnp.asarray(15.0)), lognoise=-60.0)
    mt = gt.GPE(x, y, kernel=gt.Const(lsigma=15.0), lognoise=-60.0, device="cpu")
    t, g = mt.target_and_dtarget()
    assert float(t) == float(mj.target) == -np.inf
    assert g.shape == (2,)
    assert float(mt.mll) == -np.inf


@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_f_and_predict_y(full_cov):
    mj, mt = _pair(_flagship, lambda: _flagship_data(80, 4))
    xs = np.random.RandomState(9).randn(31, 4)
    for name in ("predict_f", "predict_y"):
        mu, cov = getattr(mt, name)(xs, full_cov=full_cov)
        muj, covj = getattr(mj, name)(jnp.asarray(xs), full_cov=full_cov)
        assert cov.shape == ((31, 31) if full_cov else (31,))
        np.testing.assert_allclose(mu.numpy(), np.asarray(muj), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(cov.numpy(), np.asarray(covj), rtol=1e-9, atol=1e-11)


def _small(g, X, y, **kw):
    return g.GPE(X, y, g.MeanConst(beta=np.array(0.1)), g.SE(0.3, 0.1) + g.Const(-1.0),
                 lognoise=-1.0, **kw)


def _small_data():
    rng = np.random.RandomState(3)
    X = rng.randn(60, 2)
    return X, np.sin(2 * X[:, 0]) + 0.1 * rng.randn(60)


@pytest.mark.parametrize("flags", [{}, {"domean": False},
                                   {"noisebounds": (-1.5, -0.5)}])
def test_optimize_matches_jax(flags):
    mj, mt = _pair(_small, _small_data)
    rj = mj.optimize(maxiter=15, **flags)
    rt = mt.optimize(maxiter=15, **flags)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(rt.target, rj.target, rtol=1e-6)
    assert rt.n_iter == rj.n_iter
    np.testing.assert_allclose(mt.get_params().numpy(), np.asarray(mj.get_params()),
                               rtol=1e-6, atol=1e-9)
    if "noisebounds" in flags:
        assert -1.5 <= float(mt.lognoise) <= -0.5


def test_optimize_rejects_unknown_arguments_and_optax():
    """method='optax' runs (finite, no lower than the start) and, as in the
    JAX package, refuses bounds."""
    _, mt = _pair(_small, _small_data)
    with pytest.raises(TypeError):
        mt.optimize(maxiter=2, learning_rate=0.1)
    t0 = float(mt.target)
    res = mt.optimize(method="optax", maxiter=3)
    assert np.isfinite(res.target) and float(mt.target) >= t0 and res.n_iter == 3
    with pytest.raises(ValueError, match="bounds"):
        mt.optimize(method="optax", noisebounds=(-2.0, 0.0))
    with pytest.raises(ValueError):
        mt.optimize(method="newton")
    res = mt.optimize(noise=False, domean=False, kern=False)
    assert res.n_iter == 0 and res.x.shape == (0,)


@pytest.mark.parametrize("flags", [{}, {"domean": False}])
def test_optax_optimum_matches_jax(flags):
    """method='optax' in both packages: optax.lbfgs() as the JAX package's
    loop drives it, and the port's copy of it (`inference/lbfgs.py`). The
    first 10 iterates x_k, the values at them and the stepsizes at rtol
    1e-8 (the gradients round differently, rtol 1e-8 above), with equal
    line-search trial counts; then to convergence (||g|| < 1e-8 or 100
    iterations) the optimum: the target rtol 1e-8 and the parameters atol
    1e-5 (the target is flat to second order at its maximum). The model is
    _small without its Const term, which MeanConst makes unidentifiable
    (its log variance runs off to -inf)."""
    def make(g, X, y, **kw):
        return g.GPE(X, y, g.MeanConst(beta=np.array(0.1)), g.SE(0.3, 0.1), lognoise=-1.0,
                     **kw)

    mj, mt = _pair(make, _small_data)
    _check_optax_iterates(mj, mt, flags)
    rj = mj.optimize(method="optax", maxiter=100, **flags)
    rt = mt.optimize(method="optax", maxiter=100, **flags)
    np.testing.assert_allclose(float(mt.target), float(mj.target), rtol=1e-8)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), atol=1e-5)
    np.testing.assert_allclose(mt.get_params().numpy(), np.asarray(mj.get_params()), atol=1e-5)


def _check_optax_iterates(mj, mt, flags, iters=10, rtol=1e-8):
    """The first `iters` iterations of method='optax' from the same start in
    both packages: x_k, the value at x_k and the stepsize at rtol, the
    line-search trial counts equal."""
    vgj, x0j, _, _ = mj.make_objective(**flags)
    vgt, x0t, _, _ = mt.make_objective(**flags)
    rows, _, n = optax_rows(vgj, np.asarray(x0j), maxiter=iters)
    trace = []
    res = lbfgs.minimize(vgt, x0t, iters, 1e-8, trace=trace)
    assert res.n_iter == n == iters
    for ((xj, _), vj, (_, after)), (xt, step) in zip(rows, trace):
        assert int(step.search.count) == int(after[2].info.num_linesearch_steps)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=rtol)
        np.testing.assert_allclose(float(step.value), float(vj), rtol=rtol)
        np.testing.assert_allclose(float(step.search.stepsize),
                                   float(after[2].learning_rate), rtol=rtol)


def test_parameter_blocks_priors_and_data_updates():
    mj, mt = _pair(_small, _small_data)
    for flags in ({}, {"noise": False}, {"domean": False, "kern": False}):
        assert mt.num_params(**flags) == mj.num_params(**flags)
        np.testing.assert_array_equal(mt.get_params(**flags).numpy(),
                                      np.asarray(mj.get_params(**flags)))
    new = np.array([0.2, -0.3, 0.4, -0.8])
    mj.set_params(jnp.asarray(new), noise=False)
    mt.set_params(new, noise=False)
    np.testing.assert_array_equal(mt.get_params().numpy(), np.asarray(mj.get_params()))
    with pytest.raises(ValueError):
        mt.set_params(new)
    mj.set_priors(noise=[jpriors.Normal(-1.0, 1.0)], kern=[jpriors.Normal(), None, None])
    mt.set_priors(noise=[tpriors.Normal(-1.0, 1.0)], kern=[tpriors.Normal(), None, None])
    _check_target_grad(mj, mt)
    # block-restricted objective and log target
    vgj, x0j, _, blocks_j = mj.make_objective(noise=False)
    vgt, x0t, _, blocks_t = mt.make_objective(noise=False)
    assert blocks_t == blocks_j
    vj, gj_ = vgj(x0j)
    vt, gt_ = vgt(x0t)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-10)
    np.testing.assert_allclose(gt_.numpy(), np.asarray(gj_), rtol=1e-8, atol=1e-10)
    lpt = mt.make_logprob(include_priors=False)[0]
    lpj = mj.make_logprob(include_priors=False)[0]
    x0 = np.asarray(mj.get_params())
    np.testing.assert_allclose(float(lpt(torch.tensor(x0))), float(lpj(jnp.asarray(x0))),
                               rtol=1e-10)
    # data updates keep the model's dtype and device
    X2 = np.random.RandomState(8).randn(5, 2)
    y2 = np.ones(5)
    mj.push(X2, y2)
    mt.push(X2, y2)
    assert mt.nobs == mj.nobs == 65 and mt.x.dtype == torch.float64
    _check_target_grad(mj, mt)
    with pytest.raises(ValueError):
        mt.push(np.ones((2, 3)), np.ones(2))
    mt.fit(X2, y2)
    assert mt.nobs == 5 and mt.dim == 2
    draws = mt.sample_params(torch.Generator().manual_seed(0))
    assert draws.shape == (mt.num_params(),)


def test_gp_factory_and_default_device():
    X, y = _small_data()
    m = gt.GP(X, y, kernel=gt.SE(0.0, 0.0), device="cpu")
    assert isinstance(m, gt.GPE) and m.device.type == "cpu"
    ma = gt.GP(X, (y > 0).astype(float), kernel=gt.SE(0.0, 0.0), lik=gt.BernLik(),
               device="cpu")
    assert isinstance(ma, gt.GPA) and ma.device.type == "cpu"
    if torch.cuda.is_available():
        assert gt.GPE(X, y).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            gt.GPE(X, y)
