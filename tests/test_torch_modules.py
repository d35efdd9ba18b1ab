"""The port's module system, params and priors against the JAX package.

The same models are built in both packages from the same numbers; the flat
parameter order, the parameter names and the prior log-density must agree
(f64, atol 1e-12), and `load_flat` must carry a JAX flat vector across.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.models.gpe import GPEParams as JGPEParams
from gaussianprocesses_jl_tpu.utils import priors as jpriors
from gaussianprocesses_jl_tpu.utils.params import wrap_param as jwrap
from gaussianprocesses_jl_tpu_torch.models.gpe import GPEParams as TGPEParams
from gaussianprocesses_jl_tpu_torch.utils import priors as tpriors
from gaussianprocesses_jl_tpu_torch.utils.params import wrap_param as twrap


def _flagship(g):
    return g.SE(0.2, 0.1) + g.RQ(0.1, 0.0, -0.2) * g.Matern(1.5, 0.3, 0.0)


def _ard_fixed(g):
    return g.fix(g.SE(np.array([0.1, -0.2, 0.3]), 0.4), "lsigma")


def _with_priors(g, pri, wrap, Params):
    kern = g.SE(0.3, -0.1).set_priors([pri.Normal(0.0, 2.0), pri.Gamma(2.0, 3.0)])
    mean = g.MeanLin(beta=np.array([0.5, -0.25])).set_priors(
        [pri.StudentT(4.0, 0.1, 2.0), pri.Uniform(-1.0, 1.0)])
    noise = wrap(np.array(-1.3)).set_priors([pri.LogNormal(0.0, 0.5)])
    return Params(lognoise=noise, mean=mean, kernel=kern)


MODELS = {
    "flagship": lambda g, pri, wrap, P: P(lognoise=wrap(-1.0),
                                          mean=g.MeanConst(beta=np.array(0.3)),
                                          kernel=_flagship(g)),
    "ard_fixed": lambda g, pri, wrap, P: P(lognoise=wrap(-2.0), mean=g.MeanZero(),
                                           kernel=_ard_fixed(g)),
    "priors": _with_priors,
}


def _both(name):
    j = MODELS[name](gj, jpriors, jwrap, JGPEParams)
    t = MODELS[name](gt, tpriors, twrap, TGPEParams)
    return j, t


@pytest.mark.parametrize("name", list(MODELS))
def test_flat_order_names_and_prior(name):
    j, t = _both(name)
    assert t.n_params == j.n_params
    assert t.param_names() == j.param_names()
    np.testing.assert_array_equal(t.flat_params().numpy(), np.asarray(j.flat_params()))
    np.testing.assert_allclose(float(t.prior_logpdf()), float(j.prior_logpdf()),
                               rtol=0, atol=1e-12)
    assert [type(p).__name__ if p else None for p in t.priors_flat()] == [
        type(p).__name__ if p else None for p in j.priors_flat()]


@pytest.mark.parametrize("name", list(MODELS))
def test_with_flat_params_round_trip_and_autograd(name):
    j, t = _both(name)
    vec = np.random.RandomState(3).randn(j.n_params) * 0.1
    jn = j.with_flat_params(jnp.asarray(vec))
    v = torch.tensor(vec, requires_grad=True)
    tn = t.with_flat_params(v)
    np.testing.assert_array_equal(tn.flat_params().detach().numpy(),
                                  np.asarray(jn.flat_params()))
    # leaves are slices of vec: the prior's gradient flows back to it
    np.testing.assert_allclose(float(tn.prior_logpdf().detach()), float(jn.prior_logpdf()),
                               rtol=0, atol=1e-12)
    lp = tn.prior_logpdf()
    g_t = torch.autograd.grad(lp, v, allow_unused=True)[0] if lp.requires_grad else None
    g_j = jax.grad(lambda x: j.with_flat_params(x).prior_logpdf())(jnp.asarray(vec))
    g_t = np.zeros(len(vec)) if g_t is None else g_t.numpy()
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        t.with_flat_params(torch.zeros(t.n_params + 1, dtype=torch.float64))


def test_load_flat_checks_count_and_names():
    j, t = _both("flagship")
    vec = np.asarray(j.flat_params()) + 0.05
    out = gt.load_flat(t, vec, j.param_names())
    np.testing.assert_array_equal(out.flat_params().numpy(), vec)
    assert out.dtype == t.dtype and out.device == t.device
    t32 = t.to(dtype=torch.float32)
    assert gt.load_flat(t32, vec).flat_params().dtype == torch.float32
    with pytest.raises(ValueError):
        gt.load_flat(t, vec[:-1])
    names = j.param_names()
    names[0] = "lognoise.other"
    with pytest.raises(ValueError):
        gt.load_flat(t, vec, names)


def test_vector_param_names_and_set_priors_errors():
    jp = jwrap(np.array([-1.0, -1.5, -2.0]))
    tp = twrap(np.array([-1.0, -1.5, -2.0]))
    assert tp.param_names() == jp.param_names() == ["value_1", "value_2", "value_3"]
    assert tp.shape == (3,)
    with pytest.raises(ValueError):
        tp.set_priors([tpriors.Normal()])
    # a composite hands each child its share of the priors
    k = gt.SumKernel(gt.SE(0.0, 0.0), gt.Const(0.0))
    assert len(k.set_priors([None, tpriors.Normal(), None]).priors_flat()) == 3


def test_fixed_kernel_adds_no_prior():
    jk = gj.fix(gj.SE(0.1, 0.2).set_priors([jpriors.Normal(), jpriors.Normal()]), "ll")
    tk = gt.fix(gt.SE(0.1, 0.2).set_priors([tpriors.Normal(), tpriors.Normal()]), "ll")
    assert float(tk.prior_logpdf()) == float(jk.prior_logpdf()) == 0.0
    assert tk.param_names() == jk.param_names() == ["lsigma"]
    assert gt.free(tk, "ll").param_names() == ["ll", "lsigma"]
    assert gt.free(tk).param_names() == ["ll", "lsigma"]


def test_to_moves_every_leaf():
    _, t = _both("flagship")
    t32 = t.to(dtype=torch.float32, device="cpu")
    assert all(x.dtype == torch.float32 for x in t32.tensors())
    assert t32.flat_params().dtype == torch.float32


PRIORS = [
    ("Normal", (0.3, 1.7), [-2.0, 0.0, 1.5]),
    ("LogNormal", (0.2, 0.6), [-1.0, 0.0, 0.3, 2.0]),
    ("Uniform", (-1.0, 2.0), [-1.5, -0.5, 1.0, 2.5]),
    ("Gamma", (2.5, 1.5), [-1.0, 0.0, 0.4, 3.0]),
    ("Exponential", (1.3,), [-0.5, 0.0, 0.7]),
    ("Beta", (2.0, 3.5), [-0.1, 0.0, 0.3, 0.9, 1.2]),
    ("StudentT", (4.0, 0.5, 1.5), [-3.0, 0.5, 2.0]),
]


@pytest.mark.parametrize("name,args,xs", PRIORS, ids=[p[0] for p in PRIORS])
def test_prior_logpdf_and_gradient(name, args, xs):
    pj = getattr(jpriors, name)(*args)
    pt = getattr(tpriors, name)(*args)
    for x in xs:
        lj = float(pj.logpdf(jnp.asarray(x)))
        lt = float(pt.logpdf(torch.tensor(x, dtype=torch.float64)))
        if np.isinf(lj):
            assert lt == lj
        else:
            np.testing.assert_allclose(lt, lj, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(float(pt.gradlogpdf(x)), float(pj.gradlogpdf(x)),
                                       rtol=1e-10, atol=1e-12)


MOMENTS = {  # analytic mean and variance of each prior above
    "Normal": (0.3, 1.7**2),
    "LogNormal": (np.exp(0.2 + 0.18), (np.exp(0.36) - 1) * np.exp(0.4 + 0.36)),
    "Uniform": (0.5, 0.75),
    "Gamma": (2.5 / 1.5, 2.5 / 1.5**2),
    "Exponential": (1 / 1.3, 1 / 1.3**2),
    "Beta": (2.0 / 5.5, 2.0 * 3.5 / (5.5**2 * 6.5)),
    "StudentT": (0.5, 1.5**2 * 4.0 / 2.0),
}


@pytest.mark.parametrize("name,args,xs", PRIORS, ids=[p[0] for p in PRIORS])
def test_prior_sample_moments(name, args, xs):
    """2000 draws from a seeded torch.Generator: the sample mean lies
    within 5 standard errors of the analytic mean."""
    pt = getattr(tpriors, name)(*args)
    gen = torch.Generator().manual_seed(0)
    draws = np.array([float(pt.sample(gen)) for _ in range(2000)])
    mean, var = MOMENTS[name]
    assert np.all(np.isfinite(draws))
    assert abs(draws.mean() - mean) < 5 * np.sqrt(var / len(draws))


def test_sample_priors_uses_priors_and_uniform_fallback():
    _, t = _both("priors")
    gen = torch.Generator().manual_seed(1)
    draws = torch.stack([t.sample_priors(gen) for _ in range(200)])
    assert draws.shape == (200, t.n_params)
    assert bool((draws[:, 0] > 0).all())  # LogNormal on the noise
    assert bool((draws[:, 2].abs() <= 1).all())  # Uniform(-1, 1) on beta_2
    plain = gt.SE(0.0, 0.0).sample_priors(gen)
    assert bool((plain.abs() <= 2).all())
