"""The port's observation-sharded FITC (parallel/fitc.py) and sharded VI
(parallel/vi.py) in one process, a mesh axis of size 1, against the JAX
package's on its virtual CPU mesh of 1 and of 4 devices, on the same seeded
numpy inputs, f64: tests/test_parallel.py::test_sharded_fitc_matches_single_device
and tests/test_parallel_vi.py, case for case.

Tolerances, stated at each assertion, are the JAX tests' own: the FITC mll
rtol 1e-6 and its gradient rtol 1e-4 (atol 1e-7); the sharded ELBO and its
gradients rtol 1e-6 (atol 1e-10); the sharded training against the
replicated Adam rtol 1e-6 (atol 1e-8). Against the JAX package's own
sharded runs the port is held tighter: the FITC mll rtol 1e-10 and its
gradient rtol 1e-6 (the QRs' backward passes differ), the ELBO trace and
the restarts' results rtol 1e-8. The restarts' starts
replay the JAX package's `jax.random.split` and `normal` draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.inference.vi import elbo as j_elbo
from gaussianprocesses_jl_tpu.inference.vi import make_neg_elbo as j_make_neg_elbo
from gaussianprocesses_jl_tpu.parallel import vi as jvi
from gaussianprocesses_jl_tpu.parallel.fitc import fitc_mll_sharded_fn as j_fitc_fn
from gaussianprocesses_jl_tpu.parallel.fitc import shard_data as j_shard_data
from gaussianprocesses_jl_tpu.parallel.mesh import make_mesh as j_make_mesh
from gaussianprocesses_jl_tpu_torch.inference.vi import make_neg_elbo, vi
from gaussianprocesses_jl_tpu_torch.parallel import fitc, mesh as tmesh
from gaussianprocesses_jl_tpu_torch.parallel import vi as tvi

JAX_DEVICES = [1, 4]
N_VI = 48


def _jmesh(P, axis):
    return j_make_mesh({axis: P}, devices=jax.devices()[:P])


def _close(got, ref, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(ref, dtype=float),
                               rtol=rtol, atol=atol)


def _fake_mesh(axis, size):
    """A mesh whose axis has `size` processes, for the checks that raise
    before any collective runs."""
    return tmesh.Mesh((axis,), {axis: size}, {axis: 0}, {axis: None}, torch.device("cpu"))


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_sharded_fitc_matches_single_device(P):
    """The sharded FITC mll rtol 1e-6 and gradient rtol 1e-4 against the
    port's FITC model and against the JAX package's sharded mll."""
    rng = np.random.RandomState(1)
    n = 1600
    x = 2 * np.pi * rng.rand(n)
    y = np.sin(x) + 0.3 * rng.randn(n)
    ind = np.linspace(0, 2 * np.pi, 16)
    mt = gt.FITC(x, ind, y, kernel=gt.SE(0.3, 0.1), lognoise=-0.6, device="cpu")
    mesh = gt.make_mesh({"data": 1}, device="cpu")
    X_loc, y_loc = fitc.shard_data(mt.x, mt.y, mesh)
    fn = fitc.fitc_mll_sharded_fn(mt.params.kernel, mesh)
    vec = mt.params.flat_params().clone().requires_grad_()
    mll = fn(mt.params.with_flat_params(vec), X_loc, y_loc, mt.covstrat.inducing)
    (g,) = torch.autograd.grad(mll, vec)
    assert bool(torch.isfinite(g).all())
    t_single, g_single = mt.target_and_dtarget()
    _close(float(mll), float(mt.mll), rtol=1e-6)
    _close(g.numpy(), g_single.numpy(), rtol=1e-4, atol=1e-7)
    _close(float(fitc.sharded_fitc_mll(mt.params, X_loc, y_loc, mt.covstrat.inducing, mesh)),
           float(mll), rtol=1e-14)

    mj = gj.FITC(x, ind, y, kernel=gj.SE(0.3, 0.1), lognoise=-0.6)
    jm = _jmesh(P, "data")
    jfn = j_fitc_fn(mj.params.kernel, jm)
    Xs, ys = j_shard_data(jnp.asarray(x)[:, None], jnp.asarray(y), jm)
    Xu = mj.covstrat.inducing
    v_j, g_j = jax.jit(jax.value_and_grad(lambda v: jfn(mj.params.with_flat_params(v), Xs, ys,
                                                        Xu)))(mj.params.flat_params())
    _close(float(mll), float(v_j), rtol=1e-10)
    # the QRs' backward passes differ (torch's reduced mode, JAX's "r" mode)
    _close(g.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-10)


def test_sharded_fitc_rejects_indivisible():
    X = torch.zeros(10, 1)
    with pytest.raises(ValueError, match="divisible"):
        fitc.shard_data(X, X[:, 0], _fake_mesh("data", 3))


@pytest.fixture(scope="module")
def poisson_models():
    rng = np.random.RandomState(3)
    t = np.linspace(0, 10, N_VI)
    y = rng.poisson(np.exp(1.0 + 0.7 * np.sin(t))).astype(float)
    mj = gj.GPA(t[:, None], y, gj.MeanZero(), gj.Matern(1.5, 0.0, 0.0), gj.PoisLik())
    mt = gt.GPA(t[:, None], y, gt.MeanZero(), gt.Matern(1.5, 0.0, 0.0), gt.PoisLik(),
                device="cpu")
    return mj, mt


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_sharded_elbo_matches_single_device(poisson_models, P):
    """The sharded ELBO and its gradients in m and v equal the single
    process's elbo (rtol 1e-6) and the JAX package's sharded ELBO."""
    mj, mt = poisson_models
    rng = np.random.RandomState(0)
    mvec, vvec = 0.5 + 0.3 * rng.randn(N_VI), np.exp(0.5 * rng.randn(N_VI))
    mesh = gt.make_mesh({"data": 1}, device="cpu")
    e_s = float(tvi.sharded_elbo(mt, mvec, vvec, mesh))
    _close(e_s, float(gt.elbo(mt, mvec, vvec)), rtol=1e-6)
    jm = _jmesh(P, "data")
    _close(e_s, float(jvi.sharded_elbo(mj, mvec, vvec, jm)), rtol=1e-10)

    fn = tvi.sharded_elbo_fn(mt, mesh)
    m_, v_ = (torch.as_tensor(a).requires_grad_() for a in (mvec, vvec))
    g_s = torch.autograd.grad(fn(m_, v_), (m_, v_))
    jfn = jvi.sharded_elbo_fn(mj, jm)
    g_j = jax.grad(lambda a, b: jfn(a, b), argnums=(0, 1))(jnp.asarray(mvec), jnp.asarray(vvec))
    g_d = jax.grad(lambda a, b: j_elbo(mj, a, b), argnums=(0, 1))(jnp.asarray(mvec),
                                                                   jnp.asarray(vvec))
    for gs, gj_, gd in zip(g_s, g_j, g_d):
        _close(gs.numpy(), np.asarray(gd), rtol=1e-6, atol=1e-10)
        _close(gs.numpy(), np.asarray(gj_), rtol=1e-9, atol=1e-12)


def test_sharded_elbo_rejects_indivisible(poisson_models):
    with pytest.raises(ValueError, match="divisible"):
        tvi.sharded_elbo_fn(poisson_models[1], _fake_mesh("data", 5))


def _jax_noise(key, R, D):
    """The JAX package's restart draws: normal(k, (D,)) for k in split(key, R)."""
    keys = jax.random.split(key, R)
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (D,), jnp.float64))(keys))


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_sharded_vi_multi_restart(poisson_models, P):
    """8 restarts: with the JAX package's starts replayed, every restart's
    final ELBO and the winner's (m, v) equal the JAX package's sharded_vi
    (rtol 1e-8); the winner is the argmax and no worse than the plain Adam
    run that restart 0 is (restart 0 equals vi(method="adam"), rtol
    1e-10); the fitted Q predicts."""
    mj, mt = poisson_models
    key = jax.random.PRNGKey(1)
    res = tvi.sharded_vi(mt, gt.make_mesh({"chains": 1}, device="cpu"), restarts=8, nits=150,
                         lr=0.05, seed=lambda R, D: _jax_noise(key, R, D))
    assert res.elbos.shape == (8,)
    assert res.best == int(torch.argmax(res.elbos))
    _close(res.elbo, float(res.elbos[res.best]), rtol=0)
    rj = jvi.sharded_vi(mj, _jmesh(P, "chains"), restarts=8, nits=150, lr=0.05, key=key)
    _close(res.elbos.numpy(), np.asarray(rj.elbos), rtol=1e-8)
    assert res.best == rj.best
    _close(res.approx.m.numpy(), np.asarray(rj.approx.m), rtol=1e-8, atol=1e-10)
    _close(res.approx.v.numpy(), np.asarray(rj.approx.v), rtol=1e-8)

    q = vi(mt, nits=150, method="adam", lr=0.05)
    e_single = float(gt.elbo(mt, q.m, q.v))
    assert res.elbo >= e_single - 1e-6
    _close(float(res.elbos[0]), e_single, rtol=1e-10)
    mu, var = gt.vi_predict_y(mt, res.approx, mt.x)
    assert bool(torch.isfinite(mu).all()) and bool((var >= 0).all())


def test_sharded_vi_validates_restarts(poisson_models):
    with pytest.raises(ValueError, match="divisible"):
        tvi.sharded_vi(poisson_models[1], _fake_mesh("chains", 8), restarts=6, nits=5)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_sharded_vi_train_matches_replicated_adam(poisson_models, P):
    """Adam on the sharded ELBO follows the replicated vi(method='adam')
    (rtol 1e-6, atol 1e-8) and the JAX package's sharded_vi_train (its ELBO
    trace step for step, rtol 1e-8)."""
    mj, mt = poisson_models
    res = tvi.sharded_vi_train(mt, gt.make_mesh({"data": 1}, device="cpu"), nits=150, lr=0.05)
    q = vi(mt, nits=150, method="adam", lr=0.05)
    _close(res.approx.m.numpy(), q.m.numpy(), rtol=1e-6, atol=1e-8)
    _close(res.approx.v.numpy(), q.v.numpy(), rtol=1e-6, atol=1e-8)
    tr = res.elbo_trace.numpy()
    assert tr.shape == (150,) and tr[-1] > tr[0]
    _close(res.elbo, float(gt.elbo(mt, res.approx.m, res.approx.v)), rtol=1e-6)
    rj = jvi.sharded_vi_train(mj, _jmesh(P, "data"), nits=150, lr=0.05)
    _close(tr, np.asarray(rj.elbo_trace), rtol=1e-8)
    _close(res.approx.m.numpy(), np.asarray(rj.approx.m), rtol=1e-8, atol=1e-10)


def test_sharded_vi_train_custom_start(poisson_models):
    mj, mt = poisson_models
    _, theta0, n = make_neg_elbo(mt)
    _, theta0_j, _ = j_make_neg_elbo(mj)
    _close(theta0.numpy(), np.asarray(theta0_j), rtol=1e-12)
    th = theta0 + 0.1 * torch.as_tensor(np.random.RandomState(1).randn(theta0.shape[0]))
    res = tvi.sharded_vi_train(mt, gt.make_mesh({"data": 1}, device="cpu"), nits=40, lr=0.05,
                               theta0=th)
    assert bool(torch.isfinite(res.approx.m).all()) and bool((res.approx.v > 0).all())
    rj = jvi.sharded_vi_train(mj, _jmesh(1, "data"), nits=40, lr=0.05, theta0=jnp.asarray(th))
    _close(res.elbo_trace.numpy(), np.asarray(rj.elbo_trace), rtol=1e-8)
