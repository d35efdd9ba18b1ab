"""The port's MCMC entry points (inference/mcmc.py): HMC on GPE and GPA, a batch
of chains with best-chain selection, burn and thin, the rejection of
unknown arguments, and `ess`'s requirements; against the JAX package where
the two compute the same thing (the prior layout), by behaviour where
their random streams differ. f64."""
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.inference.mcmc import _model_priors_flat as j_priors
from gaussianprocesses_jl_tpu_torch.inference.mcmc import _model_priors_flat as t_priors

Normal = gt.priors.Normal


def _gpe():
    rng = np.random.RandomState(0)
    x = rng.randn(15, 1)
    y = np.sin(x[:, 0]) + 0.2 * rng.randn(15)
    m = gt.GPE(x, y, kernel=gt.SE(0.0, 0.0), lognoise=-1.0, device="cpu")
    m.set_priors(noise=[Normal(-1.0, 1.0)], kern=[Normal(0.0, 2.0), Normal(0.0, 2.0)])
    return m


def _gpa():
    rng = np.random.RandomState(1)
    x = rng.randn(10, 2)
    m = gt.GPA(x, (x[:, 0] > 0).astype(float), gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik(),
               device="cpu")
    m.set_priors(kern=[Normal(0.0, 1.0)] * 2)
    return m


def test_mcmc_on_gpe_and_gpa_with_burn_and_thin():
    g = torch.Generator().manual_seed(0)
    m = _gpe()
    res = gt.mcmc(m, g, n_iter=40, burn=10, thin=3, eps=0.1, verbose=False)
    assert res.samples.shape == (10, 3) and torch.isfinite(res.samples).all()
    assert isinstance(res.accept_rate, float) and 0.0 < res.accept_rate <= 1.0
    np.testing.assert_array_equal(m.get_params().numpy(), res.final.numpy())
    assert res.posterior.shape == (3, 10)
    ma = _gpa()
    res = gt.mcmc(ma, g, n_iter=20, burn=5, eps=0.1, kern=False, verbose=False)
    assert res.samples.shape == (15, 10)  # v only
    res = gt.mcmc(ma, g, n_iter=8, sampler="split", a_iters=3, burn=4, thin=2, verbose=False)
    assert res.samples.shape == (10, ma.num_params()) and res.accept_rate.shape == (2,)


@pytest.mark.parametrize("sampler", ["joint", "split"])
def test_chains_run_as_one_batch_and_the_model_takes_the_best(sampler):
    """chains=k: (k, n_kept, D) draws from jittered starts; the model ends
    at the final state of the chain with the best final target."""
    m = _gpa()
    kw = dict(a_iters=2) if sampler == "split" else {}
    res = gt.mcmc(m, torch.Generator().manual_seed(3), n_iter=6, chains=4, sampler=sampler,
                  eps=0.1, verbose=False, **kw)
    n_kept = 12 if sampler == "split" else 6
    assert res.samples.shape == (4, n_kept, m.num_params())
    assert not torch.allclose(res.samples[0, 0], res.samples[1, 0])
    lp, _, _, _ = m.make_logprob()
    targets = torch.stack([lp(res.final[c]) for c in range(4)])
    best = int(torch.argmax(targets))
    np.testing.assert_array_equal(m.get_params().numpy(), res.final[best].numpy())
    assert tuple(res.accept_rate.shape) == ((4, 2) if sampler == "split" else (4,))


def test_unknown_arguments_raise():
    m = _gpe()
    with pytest.raises(TypeError, match="unknown mcmc"):
        gt.mcmc(m, n_iter=2, noize=True, verbose=False)
    with pytest.raises(TypeError, match="unknown ess"):
        gt.ess(m, n_iter=2, noize=True, verbose=False)


def test_ess_on_gpe_with_chains_and_its_requirements():
    m = _gpe()
    res = gt.ess(m, torch.Generator().manual_seed(4), n_iter=12, chains=3, burn=2,
                 verbose=False)
    assert res.samples.shape == (3, 10, 3) and res.accept_rate is None
    assert (res.mean_proposals >= 1.0).all()
    assert not torch.allclose(res.samples[0, 0], res.samples[1, 0])
    mll, _, _, _ = m.make_logprob(include_priors=False)
    best = int(torch.argmax(torch.stack([mll(res.final[c]) for c in range(3)])))
    np.testing.assert_array_equal(m.get_params().numpy(), res.final[best].numpy())
    rng = np.random.RandomState(0)
    bare = gt.GPE(rng.randn(8, 1), rng.randn(8), kernel=gt.SE(0.0, 0.0), device="cpu")
    with pytest.raises(ValueError, match="Normal"):
        gt.ess(bare, n_iter=2, verbose=False)
    with pytest.raises(TypeError, match="GPE"):
        gt.ess(_gpa(), n_iter=2, verbose=False)


def test_model_priors_flat_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(6, 1)
    y = (x[:, 0] > 0).astype(float)
    mj = gj.GPA(x, y, gj.MeanConst(beta=0.0), gj.SE(0.0, 0.0), gj.BernLik())
    mt = gt.GPA(x, y, gt.MeanConst(beta=0.0), gt.SE(0.0, 0.0), gt.BernLik(), device="cpu")
    mj.set_priors(kern=[gj.priors.Normal(0.0, 1.0)] * 2)
    mt.set_priors(kern=[Normal(0.0, 1.0)] * 2)
    pj, pt = j_priors(mj), t_priors(mt)
    assert len(pj) == len(pt) == mt.num_params()
    for a, b in zip(pj, pt):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.mu, a.sigma) == (b.mu, b.sigma)
