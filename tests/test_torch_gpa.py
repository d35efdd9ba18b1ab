"""The port's GPA model (models/gpa.py) and the GPE additions of this slice
(GP with a likelihood, GPE.rand) against the JAX package, on the same numpy
inputs made from a seed, in f64 unless marked."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.models.gpa import gpa_target as j_target
from gaussianprocesses_jl_tpu_torch.models.gpa import gpa_target as t_target

from test_torch_gpe import _check_optax_iterates

N, D = 30, 3
LL = np.array([0.2, -0.1, 0.3])


def _lik(g, name):
    return {"gaussian": lambda: g.GaussLik(lsigma=-0.5), "bernoulli": g.BernLik,
            "poisson": g.PoisLik, "studentt": lambda: g.StuTLik(lsigma=-0.5, nu=3),
            "exponential": g.ExpLik, "binomial": lambda: g.BinLik(n=5)}[name]()


def _data(name, n=N):
    rng = np.random.RandomState(5)
    X = rng.randn(n, D)
    f = np.sin(X[:, 0])
    y = {"bernoulli": (f > 0).astype(float), "poisson": rng.poisson(np.exp(f)).astype(float),
         "gaussian": f + 0.1 * rng.randn(n), "studentt": f + 0.1 * rng.standard_t(3, n),
         "exponential": rng.exponential(np.exp(f)),
         "binomial": rng.binomial(5, 1 / (1 + np.exp(-f))).astype(float)}[name]
    return X, y


def _models(name, kern="mat32ard", n=N, dtype=torch.float64):
    """The same GPA in both packages, at one random flat vector (latents and
    hyperparameters), with Normal priors on the kernel."""
    X, y = _data(name, n)
    kerns = {"se": lambda g: g.SE(0.1, 0.2), "mat32ard": lambda g: g.Matern(1.5, LL, 0.1)}
    mj = gj.GPA(X, y, gj.MeanConst(beta=0.1), kerns[kern](gj), _lik(gj, name))
    mt = gt.GPA(X.astype(np.float32) if dtype == torch.float32 else X, y,
                gt.MeanConst(beta=0.1), kerns[kern](gt), _lik(gt, name), device="cpu")
    nk = mj.params.kernel.n_params
    mj.set_priors(kern=[gj.priors.Normal(0.0, 2.0)] * nk)
    mt.set_priors(kern=[gt.priors.Normal(0.0, 2.0)] * nk)
    vec = np.asarray(mj.params.flat_params()) + 0.3 * np.random.RandomState(7).randn(
        mj.params.n_params)
    mj.set_params(vec)
    mt.set_params(vec)
    return mj, mt


LIKS = ["gaussian", "bernoulli", "poisson", "studentt", "exponential", "binomial"]


@pytest.mark.parametrize("kern", ["se", "mat32ard"])
@pytest.mark.parametrize("name", LIKS)
def test_gpa_target_and_gradient_match_jax(name, kern):
    """gpa_target and its gradient in the flat vector, n = 30: rtol 1e-9
    (one Cholesky of a 30 x 30 gram plus the 1e-6 nugget in f64; the
    gradient through the library's Cholesky backward on each side)."""
    mj, mt = _models(name, kern)
    vec = np.asarray(mj.params.flat_params())
    tj, gjv = jax.value_and_grad(
        lambda v: j_target(mj.params.with_flat_params(v), mj.x, mj.y, mj.covstrat)[0])(
        jnp.asarray(vec))
    tt, gtv = mt.target_and_dtarget()
    assert tt.dtype == torch.float64 and gtv.shape == (mt.num_params(),)
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-9)
    np.testing.assert_allclose(gtv.numpy(), np.asarray(gjv), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(gjv)).max())
    np.testing.assert_allclose(float(mt.ll), float(mj.ll), rtol=1e-9)


def test_flat_layout_and_process_flag():
    mj, mt = _models("gaussian")
    assert mt.params.param_names() == mj.params.param_names()
    assert mt.num_params() == mj.num_params() == N + 1 + 1 + 4
    assert mt.num_params(lik=False) == N + 1 + 4
    np.testing.assert_array_equal(mt.get_params(lik=False, kern=False).numpy(),
                                  np.asarray(mj.get_params(lik=False, kern=False)))
    hyp = np.arange(1 + 1 + 4) * 0.1
    mt.set_params(hyp, process=False)
    mj.set_params(hyp, process=False)
    np.testing.assert_array_equal(mt.params.flat_params().numpy(),
                                  np.asarray(mj.params.flat_params()))
    with pytest.raises(ValueError):
        mt.set_params(hyp)  # v is included unless process=False
    assert [s.stop - s.start for s in mt.params.block_slices()] == [N, 1, 1, 4]


def test_split_targets_equal_the_joint_target():
    """make_split_logprob's two targets (A against the cached factor, B
    rebuilding it) are the joint target, and equal the JAX package's."""
    for name in ("bernoulli", "studentt"):
        mj, mt = _models(name)
        pre, la, lb, a0, b0 = mt.make_split_logprob()
        joint = float(mt.target)
        assert float(la(a0, pre(b0), b0)) == pytest.approx(joint, rel=1e-13)
        assert float(lb(b0, a0)) == pytest.approx(joint, rel=1e-13)
        pj, laj, lbj, aj, bj = mj.make_split_logprob()
        np.testing.assert_allclose(float(la(a0, pre(b0), b0)), float(laj(aj, pj(bj), bj)),
                                   rtol=1e-10)
        lp, x0, _, blocks = mt.make_logprob()
        assert blocks[0] == ("process", N) and float(lp(x0)) == pytest.approx(joint, rel=1e-13)


def test_predict_f_and_predict_y_match_jax():
    Xs = np.random.RandomState(2).randn(6, D)
    for name in ("bernoulli", "poisson"):
        mj, mt = _models(name)
        for full in (False, True):
            for got, ref in zip(mt.predict_f(Xs, full_cov=full), mj.predict_f(Xs, full_cov=full)):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)
            for got, ref in zip(mt.predict_y(Xs, full_cov=full), mj.predict_y(Xs, full_cov=full)):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)
    p, pv = mt.predict_y(Xs) if name == "bernoulli" else _models("bernoulli")[1].predict_y(Xs)


def test_gp_factory_builds_a_gpa_and_rejects_strategies_without_latents():
    X, y = _data("bernoulli")
    m = gt.GP(X, y, gt.MeanZero(), gt.SE(0.0, 0.0), lik=gt.BernLik(), device="cpu")
    assert isinstance(m, gt.GPA) and m.device.type == "cpu"
    assert isinstance(gt.GP(X, np.sin(X[:, 0]), device="cpu"), gt.GPE)
    with pytest.raises(TypeError, match="whitened-latent"):
        gt.GPA(X, y, gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik(), covstrat=object(),
               device="cpu")
    with pytest.raises(ValueError):
        gt.GPA(X, y[:-1], gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gt.GPA(X, y, gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik())


def test_optimize_and_sample_params():
    """optimize() moves latents and hyperparameters up the target (the JAX
    package's L-BFGS-B loop through the port's optimizer); sample_params
    draws the hyperparameters only."""
    _, mt = _models("bernoulli")
    before = float(mt.target)
    res = mt.optimize(maxiter=30)
    assert float(mt.target) > before and res.target == pytest.approx(float(mt.target))
    draws = mt.sample_params(torch.Generator().manual_seed(0))
    assert draws.shape == (mt.num_params() - N,) and torch.isfinite(draws).all()


def test_optax_iterates_match_jax():
    """method='optax' on a GPA (Bernoulli, Matern 3/2 ARD, n = 30; the
    latents and the hyperparameters free): the first 10 iterates, values
    and stepsizes at rtol 1e-8 and equal line-search trial counts against
    optax.lbfgs() as the JAX package drives it, then `optimize` in both
    packages to the same parameters after 10 iterations (rtol 1e-8)."""
    mj, mt = _models("bernoulli")
    _check_optax_iterates(mj, mt, {})
    rj = mj.optimize(method="optax", maxiter=10)
    rt = mt.optimize(method="optax", maxiter=10)
    assert rt.n_iter == rj.n_iter == 10 and rt.message.endswith(" evaluations")
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=1e-8)
    np.testing.assert_allclose(float(mt.target), float(mj.target), rtol=1e-8)


def test_rand_draws_have_the_predictive_moments():
    """GPE.rand and GPA.rand through eigh with a clamped spectrum: draws
    from a torch.Generator (not jax.random's), whose sample mean and
    covariance over 4000 draws are the predictive ones within MC error."""
    rng = np.random.RandomState(0)
    X, y = rng.randn(12, 1), np.sin(rng.randn(12))
    m = gt.GPE(X, y, gt.MeanZero(), gt.SE(0.0, 0.0), lognoise=-1.0, device="cpu")
    xs = np.linspace(-2, 2, 5)[:, None]
    g = torch.Generator().manual_seed(1)
    for draws, (mu, cov) in ((m.rand(xs, 4000, generator=g), m.predict_f(xs, full_cov=True)),
                             (m.rand(xs, 4000, from_prior=True, generator=g),
                              (torch.zeros(5, dtype=torch.float64), m.kernel.gram(
                                  torch.as_tensor(xs))))):
        assert draws.shape == (5, 4000)
        sd = torch.sqrt(cov.diagonal())
        assert ((draws.mean(1) - mu).abs() <= 5 * sd / np.sqrt(4000) + 1e-12).all()
        np.testing.assert_allclose(torch.cov(draws).numpy(), cov.numpy(), atol=0.1 * float(
            cov.diagonal().max()))
    assert m.rand(xs, generator=g).shape == (5,)
    mj = gj.GPE(X, y, gj.MeanZero(), gj.SE(0.0, 0.0), lognoise=-1.0)
    dj = mj.rand(jax.random.PRNGKey(0), xs, 3)
    assert dj.shape == m.rand(xs, 3, generator=g).shape
    _, mt = _models("bernoulli")
    d = mt.rand(np.random.RandomState(3).randn(4, D), 2000, generator=g)
    mu, var = mt.predict_f(np.random.RandomState(3).randn(4, D))
    assert ((d.mean(1) - mu).abs() <= 5 * torch.sqrt(var) / np.sqrt(2000) + 1e-9).all()


def test_load_chains_carries_jax_chain_states():
    """A (C, D) array of the JAX package's chain states becomes a (C, D)
    tensor in the model's dtype, each row the same model as in JAX."""
    mj, mt = _models("bernoulli")
    states = np.asarray(mj.params.flat_params())[None] + 0.05 * np.random.RandomState(
        1).randn(3, mj.params.n_params)
    T = gt.load_chains(mt.params, states, mj.params.param_names())
    assert T.shape == states.shape and T.dtype == torch.float64
    for c in range(3):
        pj = mj.params.with_flat_params(jnp.asarray(states[c]))
        np.testing.assert_allclose(
            float(t_target(mt.params.with_flat_params(T[c]), mt.x, mt.y)[0]),
            float(j_target(pj, mj.x, mj.y)[0]), rtol=1e-10)
    with pytest.raises(ValueError):
        gt.load_chains(mt.params, states[:, 1:])
    with pytest.raises(ValueError):
        gt.load_chains(mt.params, states, ["x"] * states.shape[1])


@pytest.mark.f32
def test_gpa_target_in_f32_matches_f64():
    """The classification target in f32 (nugget 1e-4) against the same
    model in f64 (nugget 1e-6) through JAX: the targets differ by the
    nugget's effect and f32 rounding, so rtol 1e-3 on the target and atol
    2e-2 max|g| on the gradient, the tolerances of the f32 headline."""
    mj, mt = _models("bernoulli", dtype=torch.float32)
    mt.params = mt.params.to(dtype=torch.float32)
    tt, gtv = mt.target_and_dtarget()
    assert tt.dtype == torch.float32
    tj, gjv = mj.target_and_dtarget()
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-3)
    gmax = float(np.abs(np.asarray(gjv)).max())
    np.testing.assert_allclose(gtv.double().numpy(), np.asarray(gjv), rtol=0, atol=2e-2 * gmax)


def test_gpa_study_refuses_the_cpu_and_phase_13s_tolerances_hold_on_it():
    """`perf/gpa_study.py` needs a card for its run; its `--f32-gap`
    measurement runs here. At configuration #2's size (n = 200, d = 5) the
    f32 model lies within chip_smoke phase 13's tolerances of the f64 model
    (target rtol 1e-4, gradient 2e-3 max|g|), and within f32 rounding of it
    at the f32 model's own nugget."""
    from gaussianprocesses_jl_tpu_torch.perf import gpa_study

    if not torch.cuda.is_available():
        assert gpa_study.main([]) == 1
    ((t_rel, g_rel, t_same, g_same),) = gpa_study.f32_gap(states=1)
    assert t_rel < 1e-4 and g_rel < 2e-3
    assert t_same < 1e-6 and g_same < 1e-5
