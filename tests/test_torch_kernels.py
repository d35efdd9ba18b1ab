"""Every kernel class and every mean of the port against the JAX package.

For each kernel: the symmetric and the cross gram, `diag`, and the gradient
of sum(W * gram) with respect to the flat parameters and X, against
`jax.grad` of the same sum. For each mean: the mean vector and the same
gradients. Inputs hold coincident points, so the exact
zero diagonal, `safe_dist`'s zero gradient at r = 0 and the Noise kernel's
coincidence rule are all exercised. Tolerance (f64): rtol 1e-10, atol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt

RTOL, ATOL = 1e-10, 1e-12

LL3 = np.array([0.1, -0.2, 0.3])

# (name, make(g)) — make is called with either package
KERNELS = [
    ("SEIso", lambda g: g.SE(0.3, 0.1)),
    ("SEArd", lambda g: g.SE(LL3, 0.1)),
    ("Mat12Iso", lambda g: g.Matern(0.5, 0.2, -0.1)),
    ("Mat32Iso", lambda g: g.Matern(1.5, 0.3, 0.2)),
    ("Mat52Iso", lambda g: g.Matern(2.5, -0.1, 0.0)),
    ("Mat12Ard", lambda g: g.Matern(0.5, LL3, -0.1)),
    ("Mat32Ard", lambda g: g.Matern(1.5, LL3, 0.2)),
    ("Mat52Ard", lambda g: g.Matern(2.5, LL3, 0.0)),
    ("RQIso", lambda g: g.RQ(0.2, 0.1, -0.3)),
    ("RQArd", lambda g: g.RQ(LL3, 0.1, -0.3)),
    ("Periodic", lambda g: g.Periodic(ll=np.array(0.1), lsigma=np.array(0.05),
                                      lp=np.array(0.5))),
    ("LinIso", lambda g: g.Lin(0.2)),
    ("LinArd", lambda g: g.Lin(LL3)),
    ("Poly", lambda g: g.Poly(lc=np.array(0.1), lsigma=np.array(-0.2), deg=3)),
    ("Noise", lambda g: g.Noise(lsigma=np.array(-0.5))),
    ("Const", lambda g: g.Const(lsigma=np.array(0.3))),
    ("Sum", lambda g: g.SE(0.2, 0.1) + g.Matern(0.5, 0.1, 0.0)),
    ("Prod", lambda g: g.RQ(0.1, 0.0, -0.2) * g.Matern(1.5, 0.3, 0.0)),
    ("Masked", lambda g: g.Masked(g.Matern(2.5, 0.1, 0.2), active_dims=(0, 2))),
    ("Fixed", lambda g: g.fix(g.SE(LL3, 0.4), "lsigma")),
    ("FixedAll", lambda g: g.fix(g.Periodic(ll=np.array(0.1), lsigma=np.array(0.05),
                                            lp=np.array(0.5)))),
    ("Composite", lambda g: g.Masked(g.Lin(0.1), active_dims=(1,))
     + g.fix(g.RQ(LL3, 0.1, 0.2), "lalpha") * g.Noise(lsigma=np.array(0.1))),
]


def _data():
    rng = np.random.RandomState(0)
    X1 = rng.randn(12, 3)
    X1[5] = X1[2]  # coincident pair inside the symmetric gram
    X2 = rng.randn(7, 3)
    X2[3] = X1[0]  # coincident pair across the cross gram
    W = rng.randn(12, 12)
    Wc = rng.randn(12, 7)
    return X1, X2, W, Wc


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,build", KERNELS, ids=[k[0] for k in KERNELS])
def test_kernel_matches_jax(name, build):
    kj, kt = build(gj), build(gt)
    assert kt.param_names() == kj.param_names()
    X1, X2, W, Wc = _data()
    vec = np.asarray(kj.flat_params())
    assert np.array_equal(kt.flat_params().numpy(), vec)

    for X2_, W_ in ((None, W), (X2, Wc)):
        def f_j(v, X):
            k = kj.with_flat_params(v)
            return jnp.sum(jnp.asarray(W_) * k.gram(X, None if X2_ is None else jnp.asarray(X2_)))

        v = _t(vec).requires_grad_()
        X = _t(X1).requires_grad_()
        K = kt.with_flat_params(v).gram(X, None if X2_ is None else _t(X2_))
        Kj = kj.gram(jnp.asarray(X1), None if X2_ is None else jnp.asarray(X2_))
        _close(K, Kj)
        gv, gx = torch.autograd.grad(torch.sum(_t(W_) * K), (v, X), allow_unused=True)
        gvj, gxj = jax.grad(f_j, argnums=(0, 1))(jnp.asarray(vec), jnp.asarray(X1))
        _close(gv if gv is not None else torch.zeros(len(vec)), gvj)
        _close(gx if gx is not None else torch.zeros_like(X), gxj)

    # diag and its gradient (JAX vmaps the 1x1 gram; the port writes profile(0))
    wd = np.random.RandomState(1).randn(12)
    v = _t(vec).requires_grad_()
    d = kt.with_flat_params(v).diag(_t(X1))
    dj = kj.diag(jnp.asarray(X1))
    _close(d, dj)
    if d.requires_grad:
        (gd,) = torch.autograd.grad(torch.sum(_t(wd) * d), v, allow_unused=True)
        gdj = jax.grad(lambda u: jnp.sum(wd * kj.with_flat_params(u).diag(jnp.asarray(X1))))(
            jnp.asarray(vec))
        _close(gd if gd is not None else torch.zeros(len(vec)), gdj)
    # the scalar form k(x1, x2)
    _close(kt(_t(X1[0]), _t(X2[0])), kj(jnp.asarray(X1[0]), jnp.asarray(X2[0])))


def test_symmetric_diagonal_is_exact_and_gradient_finite_at_coincidence():
    X1, _, _, _ = _data()
    for build in (lambda g: g.Matern(0.5, 0.2, -0.1), lambda g: g.Periodic(
            ll=np.array(0.1), lsigma=np.array(0.05), lp=np.array(0.5))):
        k = build(gt)
        X = _t(X1).requires_grad_()
        K = k.gram(X)
        assert torch.equal(K.diagonal(), k.diag(X.detach()))
        assert K[5, 2] == K[2, 2]  # coincident rows give profile(0) exactly
        (gx,) = torch.autograd.grad(K.sum(), X)
        assert bool(torch.isfinite(gx).all())


def test_noise_relative_coincidence_rule():
    """Coincidence is d2 <= eps * max(|x|^2, |x'|^2, 1): relative far from
    the origin, with an absolute floor near it."""
    eps = np.finfo(np.float64).eps
    X = np.array([[1e3, 0.0], [1e3 + 1e3 * 0.5 * np.sqrt(eps), 0.0], [1e3 + 1.0, 0.0],
                  [0.0, 0.0], [1e-10, 0.0], [0.1, 0.0]])
    kj, kt = gj.Noise(lsigma=np.array(0.2)), gt.Noise(lsigma=np.array(0.2))
    K = kt.gram(_t(X))
    _close(K, kj.gram(jnp.asarray(X)))
    s2 = np.exp(0.4)
    expect = np.zeros((6, 6), bool)
    expect[np.diag_indices(6)] = True
    expect[0, 1] = expect[1, 0] = True  # within the relative tolerance at |x| = 1e3
    expect[3, 4] = expect[4, 3] = True  # within the absolute floor at the origin
    np.testing.assert_array_equal(K.numpy() == s2, expect)
    _close(kt.gram(_t(X), _t(X[:2])), kj.gram(jnp.asarray(X), jnp.asarray(X[:2])))


MEANS = [
    ("MeanZero", lambda g: g.MeanZero()),
    ("MeanConst", lambda g: g.MeanConst(beta=np.array(0.4))),
    ("MeanLin", lambda g: g.MeanLin(beta=np.array([0.5, -0.3, 0.2]))),
    ("MeanPoly", lambda g: g.MeanPoly(beta=np.array([[0.5, -0.3, 0.2], [0.1, 0.2, -0.4]]))),
    ("MeanPeriodic", lambda g: g.MeanPeriodic(a=np.array([0.5, -0.3, 0.2]),
                                              b=np.array([0.1, 0.2, -0.4]),
                                              lp=np.array([0.0, 0.3, -0.2]))),
    ("SumMean", lambda g: g.MeanConst(beta=np.array(0.4)) + g.MeanLin(beta=np.array([0.5, -0.3, 0.2]))),
    ("ProdMean", lambda g: g.MeanConst(beta=np.array(0.4)) * g.MeanPeriodic(
        a=np.array([0.5, -0.3, 0.2]), b=np.array([0.1, 0.2, -0.4]),
        lp=np.array([0.0, 0.3, -0.2]))),
]


@pytest.mark.parametrize("name,build", MEANS, ids=[m[0] for m in MEANS])
def test_mean_matches_jax(name, build):
    mj, mt = build(gj), build(gt)
    assert mt.param_names() == mj.param_names()
    X1, _, _, _ = _data()
    vec = np.asarray(mj.flat_params(), dtype=np.float64)
    w = np.random.RandomState(2).randn(12)
    v = _t(vec).requires_grad_()
    X = _t(X1).requires_grad_()
    m = mt.with_flat_params(v).mean(X)
    _close(m, mj.mean(jnp.asarray(X1)))
    if m.requires_grad:
        gv, gx = torch.autograd.grad(torch.sum(_t(w) * m), (v, X), allow_unused=True)
        gvj, gxj = jax.grad(lambda u, Z: jnp.sum(w * mj.with_flat_params(u).mean(Z)),
                            argnums=(0, 1))(jnp.asarray(vec), jnp.asarray(X1))
        _close(gv if gv is not None else torch.zeros(len(vec)), gvj)
        _close(gx if gx is not None else torch.zeros_like(X), gxj)
