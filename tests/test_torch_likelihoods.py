"""The port's likelihoods and quadrature (ops/likelihoods.py,
utils/quadrature.py) against the JAX package's, on the same numpy inputs
made from a seed, in f64. Tolerance: rtol 1e-12 (the same elementwise
formulas; atol 1e-14 for values that cancel to near 0)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.ops.likelihoods import Likelihood as JLikelihood
from gaussianprocesses_jl_tpu.utils import quadrature as jq
from gaussianprocesses_jl_tpu_torch.ops.likelihoods import Likelihood as TLikelihood
from gaussianprocesses_jl_tpu_torch.utils import quadrature as tq

LIKS = [
    ("GaussLik", lambda g: g.GaussLik(lsigma=-0.3)),
    ("BernLik", lambda g: g.BernLik()),
    ("PoisLik", lambda g: g.PoisLik()),
    ("StuTLik", lambda g: g.StuTLik(lsigma=-0.3, nu=4)),
    ("ExpLik", lambda g: g.ExpLik()),
    ("BinLik", lambda g: g.BinLik(n=5)),
]


def _data(name, n=17):
    """(f, y, m, v): latents over [-8, 8], observations of the likelihood's
    kind, and a predictive mean and variance."""
    rng = np.random.RandomState(3)
    f = np.linspace(-8.0, 8.0, n)
    y = {"GaussLik": rng.randn(n), "StuTLik": rng.randn(n),
         "BernLik": (rng.rand(n) > 0.5).astype(float),
         "PoisLik": rng.poisson(2.0, n).astype(float),
         "ExpLik": rng.exponential(1.0, n),
         "BinLik": rng.binomial(5, 0.4, n).astype(float)}[name]
    return f, y, 0.7 * rng.randn(n), 0.1 + rng.rand(n)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name,build", LIKS, ids=[k[0] for k in LIKS])
def test_likelihood_matches_jax(name, build):
    """log_dens, dlog_dens_df, the moments, predict_obs (closed form or
    quadrature), var_exp and dv_var_exp."""
    lj, lt = build(gj), build(gt)
    f, y, m, v = _data(name)
    fj, yj, mj, vj = map(jnp.asarray, (f, y, m, v))
    ft, yt, mt, vt = map(torch.as_tensor, (f, y, m, v))
    _close(lt.log_dens(ft, yt), lj.log_dens(fj, yj))
    _close(lt.dlog_dens_df(ft, yt), lj.dlog_dens_df(fj, yj))
    _close(lt.mean_lik(ft), lj.mean_lik(fj))
    _close(lt.var_lik(ft), lj.var_lik(fj))
    for got, ref in zip(lt.predict_obs(mt, vt), lj.predict_obs(mj, vj)):
        _close(got, ref)
    _close(lt.var_exp(yt, mt, vt), lj.var_exp(yj, mj, vj))
    _close(lt.dv_var_exp(yt, mt, vt), lj.dv_var_exp(yj, mj, vj))
    # the base class's quadrature, even where a closed form overrides it
    for got, ref in zip(TLikelihood.predict_obs(lt, mt, vt), JLikelihood.predict_obs(lj, mj, vj)):
        _close(got, ref)
    # the same function as a module: flat parameters and names
    assert lt.n_params == lj.n_params and lt.param_names() == lj.param_names()


def test_quadrature_nodes_and_expectation():
    xt, wt = tq.gauss_hermite(20)
    xj, wj = jq.gauss_hermite(20)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert abs(float(wt.sum()) - 1.0) < 1e-14
    mu, var = np.array([-1.0, 0.0, 2.5]), np.array([0.3, 1.0, 0.05])
    got = tq.hermgauss_expectation(lambda f: torch.cos(f) * f ** 2, torch.as_tensor(mu),
                                   torch.as_tensor(var))
    ref = jq.hermgauss_expectation(lambda f: jnp.cos(f) * f ** 2, jnp.asarray(mu),
                                   jnp.asarray(var))
    _close(got, ref)
    # E[f^2] = mu^2 + var exactly for a polynomial of low degree
    np.testing.assert_allclose(
        tq.hermgauss_expectation(lambda f: f * f, torch.as_tensor(mu), torch.as_tensor(var)),
        mu ** 2 + var, rtol=1e-13)
    xs, ws = tq.gauss_hermite(8, torch.float32)
    assert xs.dtype == ws.dtype == torch.float32 and xs.shape == (8,)


def test_log_ndtr_batches_over_chains_without_a_loop():
    """The probit likelihood's log_ndtr under torch.func.vmap(grad): no
    per-chain fallback (functorch warns when an operator has no batching
    rule), and the value and gradient of a loop over the chains."""
    lik = gt.BernLik()
    f = torch.as_tensor(np.random.RandomState(1).randn(5, 9) * 4)
    y = torch.as_tensor((np.arange(9) % 2).astype(float))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        g = torch.func.vmap(torch.func.grad(lambda ff: lik.log_dens(ff, y).sum()))(f)
    assert not [w for w in caught if "batching rule" in str(w.message)]
    for c in range(5):
        ref = jax.grad(lambda ff: gj.BernLik().log_dens(ff, jnp.asarray(y.numpy())).sum())(
            jnp.asarray(f[c].numpy()))
        _close(g[c], ref)


@pytest.mark.f32
def test_likelihoods_in_f32_match_f64():
    """f32 latents through the port against JAX in f64: rtol 1e-5 (a few
    f32 roundings of log_dens's terms, whose sizes stay near 1..10^2)."""
    for name, build in LIKS:
        f, y, _, _ = _data(name)
        got = build(gt).to(dtype=torch.float32).log_dens(torch.as_tensor(f, dtype=torch.float32),
                                                         torch.as_tensor(y))
        assert got.dtype == torch.float32
        ref = np.asarray(build(gj).log_dens(jnp.asarray(f), jnp.asarray(y)))
        np.testing.assert_allclose(got.double().numpy(), ref, rtol=1e-5, atol=1e-5)
