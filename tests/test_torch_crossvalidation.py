"""The port's cross-validation (inference/crossvalidation.py) against the
JAX package on the same numpy inputs made from a seed, in f64: all six
functions, over ragged, unordered folds (padded to one width), on a GPE with
a constant mean and an ARD kernel, so that every parameter block has a
gradient. Tolerances, stated at each assertion: values rtol 1e-10,
gradients rtol 1e-8 (atol 1e-10), fold predictions atol 1e-10.
"""
import numpy as np
import pytest

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt

N = 40
# ragged and out of order: widths 7, 13, 1 and 19
FOLDS = [[3, 0, 11, 25, 7, 39, 16], list(range(26, 39)), [1],
         [2, 4, 5, 6, 8, 9, 10, 12, 13, 14, 15, 17, 18, 19, 20, 21, 22, 23, 24]]


def _pair():
    rng = np.random.RandomState(4)
    x = rng.randn(N, 2)
    y = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] + 0.3 * rng.randn(N)
    ll = np.array([0.2, -0.1])
    mj = gj.GPE(x, y, gj.MeanConst(beta=np.array(0.1)), gj.SE(ll, 0.1), lognoise=-0.7)
    mt = gt.GPE(x, y, gt.MeanConst(beta=0.1), gt.SE(ll, 0.1), lognoise=-0.7, device="cpu")
    return mj, mt


def test_folds_partition_the_data():
    assert sorted(i for f in FOLDS for i in f) == list(range(N))


def test_loo_matches_jax():
    mj, mt = _pair()
    for a, b in zip(gt.predict_LOO(mt), gj.predict_LOO(mj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)
    np.testing.assert_allclose(float(gt.logp_LOO(mt)), float(gj.logp_LOO(mj)), rtol=1e-10)


@pytest.mark.parametrize("flags", [{}, {"noise": False}, {"domean": False, "kern": False}])
def test_loo_gradient_matches_jax(flags):
    mj, mt = _pair()
    np.testing.assert_allclose(gt.dlogp_LOO(mt, **flags).numpy(),
                               np.asarray(gj.dlogp_LOO(mj, **flags)), rtol=1e-8, atol=1e-10)


def test_cvfold_predictions_and_criterion_match_jax():
    mj, mt = _pair()
    pt, pj = gt.predict_CVfold(mt, FOLDS), gj.predict_CVfold(mj, FOLDS)
    assert [p[0].shape[0] for p in pt] == [len(f) for f in FOLDS]
    for (mut, St), (muj, Sj) in zip(pt, pj):
        np.testing.assert_allclose(mut.numpy(), np.asarray(muj), atol=1e-10)
        np.testing.assert_allclose(St.numpy(), np.asarray(Sj), atol=1e-10)
    np.testing.assert_allclose(float(gt.logp_CVfold(mt, FOLDS)),
                               float(gj.logp_CVfold(mj, FOLDS)), rtol=1e-10)


@pytest.mark.parametrize("flags", [{}, {"kern": False}])
def test_cvfold_gradient_matches_jax(flags):
    mj, mt = _pair()
    np.testing.assert_allclose(gt.dlogp_CVfold(mt, FOLDS, **flags).numpy(),
                               np.asarray(gj.dlogp_CVfold(mj, FOLDS, **flags)),
                               rtol=1e-8, atol=1e-10)


def test_singleton_folds_equal_loo_and_a_fold_equals_a_refit():
    """Singleton folds give the LOO criterion (rtol 1e-10); a fold's
    (mu, Sigma) equals the refit model's predict_y without it (atol 1e-8)."""
    _, mt = _pair()
    np.testing.assert_allclose(float(gt.logp_CVfold(mt, [[i] for i in range(N)])),
                               float(gt.logp_LOO(mt)), rtol=1e-10)
    V = FOLDS[0]
    keep = [j for j in range(N) if j not in V]
    x, y = mt.x.numpy(), mt.y.numpy()
    sub = gt.GPE(x[keep], y[keep], mt.mean, mt.kernel, lognoise=float(mt.lognoise),
                 device="cpu")
    mu_b, cov_b = sub.predict_y(x[V], full_cov=True)
    muV, SV = gt.predict_CVfold(mt, [V] + FOLDS[1:])[0]
    np.testing.assert_allclose(muV.numpy(), mu_b.numpy(), atol=1e-8)
    np.testing.assert_allclose(SV.numpy(), cov_b.numpy(), atol=1e-8)
