"""The port's ElasticGPE (models/elastic.py) against the JAX package's, on
the same numpy data: after every append the factor, alpha and mll agree
(rtol 1e-10, f64) across means and kernels, through capacity growth; the
maintained factor equals a fresh GPE's; set_params only marks it stale; the
GPE methods (predict, target and gradient, optimize) work after appends."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.models.elastic import ElasticGPE as JElastic
from gaussianprocesses_jl_tpu_torch.models.elastic import ElasticGPE

F64 = dict(device="cpu", dtype=torch.float64)


def _close(got, ref, rtol=1e-10):
    ref = np.asarray(ref, dtype=float)
    np.testing.assert_allclose(np.asarray(got, dtype=float), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


CASES = {
    "se": (lambda g: g.MeanZero(), lambda g: g.SE(0.2, 0.1)),
    "const-mat32": (lambda g: g.MeanConst(beta=0.3), lambda g: g.Matern(1.5, 0.1, 0.0)),
    "rq": (lambda g: g.MeanZero(), lambda g: g.RQ(0.1, 0.0, -0.2)),
    "sum-ard": (lambda g: g.MeanZero(),
                lambda g: g.SE(np.array([0.2, -0.1]), 0.1) + g.Matern(0.5, 0.0, 0.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_every_append_matches_jax(case):
    """24 points in blocks of 10, 7 and 7 (capacity 16, stepsize 8: the
    second append grows to 24 and rebuilds, the third extends): factor,
    alpha and mll after each append against JAX's ElasticGPE; then against
    a fresh GPE, and the predictive against JAX's."""
    mean, kern = CASES[case]
    rng = np.random.RandomState(0)
    X = rng.randn(24, 2)
    y = np.sin(X[:, 0]) + 0.2 * rng.randn(24)
    ej = JElastic(2, mean=mean(gj), kernel=kern(gj), lognoise=-1.0, capacity=16, stepsize=8)
    et = ElasticGPE(2, mean=mean(gt), kernel=kern(gt), lognoise=-1.0, capacity=16, stepsize=8,
                    **F64)
    for lo, hi in ((0, 10), (10, 17), (17, 24)):
        ej.append(X[lo:hi], y[lo:hi])
        et.append(X[lo:hi], y[lo:hi])
        assert et.nobs == ej.nobs == hi and et.capacity == ej.capacity
        _close(et.chol.numpy(), ej.chol)
        _close(et.alpha.numpy(), ej.alpha)
        _close(et.mll.numpy(), ej.mll)
    batch = gt.GPE(X, y, mean(gt), kern(gt), lognoise=-1.0, device="cpu")
    _close(et.mll.numpy(), batch.mll.numpy())
    xs = rng.randn(5, 2)
    for got, ref in zip(et.predict_f(xs), ej.predict_f(xs)):
        _close(got.numpy(), ref)


def test_the_padded_factor_matches_jax():
    """The whole padded buffer, capacity by capacity, after each of six
    appends of 4 (capacity 12, stepsize 8: the fourth grows to 20 and
    rebuilds, the others extend at their offset): JAX's padded factor, the
    identity past n included, rtol 1e-10."""
    rng = np.random.RandomState(2)
    X = rng.randn(24, 3)
    y = np.cos(X[:, 1]) + 0.1 * rng.randn(24)
    ej = JElastic(3, kernel=gj.SE(np.array([0.2, -0.1, 0.0]), 0.1), lognoise=-1.5,
                  capacity=12, stepsize=8)
    et = ElasticGPE(3, kernel=gt.SE(np.array([0.2, -0.1, 0.0]), 0.1), lognoise=-1.5,
                    capacity=12, stepsize=8, **F64)
    for i in range(0, 24, 4):
        ej.append(X[i:i + 4], y[i:i + 4])
        et.append(X[i:i + 4], y[i:i + 4])
        assert et._L.shape == ej._L.shape
        _close(et._L.numpy(), ej._L)
        n = et.nobs
        assert torch.equal(et._L[n:, n:], torch.eye(et.capacity - n, dtype=torch.float64))


def test_capacity_grows_by_steps():
    """Blocks of 5 into capacity 8, stepsize 8: 30 points end at capacity 32,
    as in the JAX package, with the mll of a fresh GPE."""
    rng = np.random.RandomState(1)
    X = rng.randn(30, 1)
    y = np.sin(X[:, 0])
    et = ElasticGPE(1, kernel=gt.SE(0.0, 0.0), lognoise=-1.0, capacity=8, stepsize=8, **F64)
    ej = JElastic(1, kernel=gj.SE(0.0, 0.0), lognoise=-1.0, capacity=8, stepsize=8)
    for i in range(0, 30, 5):
        et.append(X[i:i + 5], y[i:i + 5])
        ej.append(X[i:i + 5], y[i:i + 5])
        assert et.capacity == ej.capacity
        _close(et.mll.numpy(), ej.mll)
    assert et.nobs == 30 and et.capacity == 32
    batch = gt.GPE(X, y, kernel=gt.SE(0.0, 0.0), lognoise=-1.0, device="cpu")
    _close(et.mll.numpy(), batch.mll.numpy())


def test_set_params_is_lazy(monkeypatch):
    """A sweep of set_params costs no rebuild; the next mll pays one and the
    factor is cached after it; the mll is JAX's at the new parameters."""
    rng = np.random.RandomState(3)
    X, y = rng.randn(10, 1), rng.randn(10)
    et = ElasticGPE(1, kernel=gt.SE(0.0, 0.0), lognoise=-1.0, capacity=16, **F64)
    et.append(X, y)
    assert et._fresh
    calls = {"n": 0}
    rebuild = ElasticGPE._rebuild

    def counting(self):
        calls["n"] += 1
        return rebuild(self)

    monkeypatch.setattr(ElasticGPE, "_rebuild", counting)
    v = et.get_params()
    for i in range(5):
        et.set_params(v + 0.01 * i)
    assert calls["n"] == 0 and not et._fresh
    mll = float(et.mll)
    assert calls["n"] == 1
    float(et.mll)
    assert calls["n"] == 1
    ej = JElastic(1, kernel=gj.SE(0.0, 0.0), lognoise=-1.0, capacity=16)
    ej.append(X, y)
    ej.set_params(jnp.asarray(v.numpy() + 0.04))
    _close(mll, ej.mll)


def test_the_gpe_methods_work_after_appends():
    """predict_y, target_and_dtarget (against JAX's at the same data and
    parameters) and optimize, which leaves the factor of the optimum."""
    rng = np.random.RandomState(2)
    X, y = rng.randn(12, 1), rng.randn(12)
    et = ElasticGPE(1, kernel=gt.SE(0.0, 0.0), lognoise=-1.0, capacity=16, **F64)
    ej = JElastic(1, kernel=gj.SE(0.0, 0.0), lognoise=-1.0, capacity=16)
    for part in (slice(0, 6), slice(6, 12)):
        et.append(X[part], y[part])
        ej.append(X[part], y[part])
    t, g = et.target_and_dtarget()
    tj, gj_ = ej.target_and_dtarget()
    _close(t.numpy(), tj)
    _close(g.numpy(), gj_)
    mu, var = et.predict_y(rng.randn(4, 1))
    assert bool(torch.isfinite(mu).all()) and bool((var > 0).all())
    before = float(et.mll)
    et.optimize(maxiter=20)
    assert float(et.mll) >= before
    fresh = gt.GPE(X, y, kernel=et.kernel, lognoise=et.lognoise, device="cpu")
    _close(et.mll.numpy(), fresh.mll.numpy())
    with pytest.raises(AttributeError):
        et.fit(X, y)
    with pytest.raises(ValueError):
        et.append(rng.randn(2, 3), rng.randn(2))
