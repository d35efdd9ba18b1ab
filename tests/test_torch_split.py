"""The port's split-block HMC (inference/split.py) against the JAX
package's `split_hmc`: whole outer iterations from the draws JAX made from
its key (rebuilt here as it splits them) give JAX's draws, final state and
target, accept rates and dual-averaged step sizes; split and joint samplers
agree on posterior moments within Monte Carlo error. f64."""
import jax
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu_torch.inference.hmc import hmc
from gaussianprocesses_jl_tpu_torch.inference.split import da_init, da_update, split_hmc
from jax_draws import Replay, split_draws


def _gpa(n=8, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 2)
    y = (np.sin(X[:, 0]) + 0.3 * rng.randn(n) > 0).astype(float)
    mj = gj.GPA(X, y, gj.MeanZero(), gj.SE(0.0, 0.0), gj.BernLik())
    mt = gt.GPA(X, y, gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik(), device="cpu")
    mj.set_priors(kern=[gj.priors.Normal(0.0, 1.0)] * 2)
    mt.set_priors(kern=[gt.priors.Normal(0.0, 1.0)] * 2)
    return mj, mt


KW = dict(a_iters=2, eps_a=0.2, eps_b=0.1, Lmin=2, Lmax=4)


@pytest.mark.parametrize("chains", [None, 2])
def test_outer_iterations_from_jax_draws_match_jax(chains):
    """One warmup and one sampling outer iteration (two A updates, one B
    update each): the warmup and post-warmup draws, the final state and
    target, the accept rates, and the step sizes after one dual-averaging
    update (da_update and da_init exactly as JAX runs them), rtol 1e-10; one
    chain, and two chains at once against JAX's vmap."""
    mj, mt = _gpa()
    pj, laj, lbj, aj, bj = mj.make_split_logprob()
    pt, lat, lbt, at, bt = mt.make_split_logprob()
    C = chains or 1
    rng = np.random.RandomState(9)
    a0 = np.asarray(aj)[None] + 0.1 * rng.randn(C, aj.shape[0])
    b0 = np.asarray(bj)[None] + 0.1 * rng.randn(C, bj.shape[0])
    keys = [jax.random.PRNGKey(11 + c) for c in range(C)]

    def run_jax(a, b, k):
        return gj.split_hmc(pj, laj, lbj, a, b, k, n_iter=1, n_warmup=1, **KW)

    if chains is None:
        rj = run_jax(a0[0], b0[0], keys[0])
    else:
        rj = jax.vmap(run_jax)(a0, b0, jax.numpy.stack(keys))
    stream = Replay(hmc=split_draws(keys, 2, KW["a_iters"], aj.shape[0], bj.shape[0],
                                    KW["Lmin"], KW["Lmax"]))
    a_in, b_in = torch.as_tensor(a0), torch.as_tensor(b0)
    if chains is None:
        a_in, b_in = a_in[0], b_in[0]
    rt = split_hmc(pt, lat, lbt, a_in, b_in, stream, n_iter=1, n_warmup=1, **KW)
    assert stream.exhausted()
    for field in ("samples", "warmup_samples", "final", "final_target", "accept_rate_a",
                  "accept_rate_b", "eps_a_final", "eps_b_final"):
        got, ref = getattr(rt, field), np.asarray(getattr(rj, field))
        assert tuple(got.shape) == ref.shape, field
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12, err_msg=field)


def test_da_update_follows_the_dual_averaging_recursion():
    """da_update on tensors of step sizes, one a chain: the recursion of
    Hoffman & Gelman's Alg. 5 with the JAX package's constants (gamma 0.05,
    t0 10, kappa 0.75), written out here in plain floats."""
    eps0 = torch.tensor([0.1, 0.3], dtype=torch.float64)
    st = da_init(eps0)
    a_means = [torch.tensor([0.9, 0.2], dtype=torch.float64),
               torch.tensor([0.5, 0.95], dtype=torch.float64)]
    for c in range(2):
        e, mu, leb, hbar, t = (float(eps0[c]), np.log(10 * float(eps0[c])),
                               np.log(float(eps0[c])), 0.0, 0.0)
        for a in a_means:
            t += 1.0
            hbar = (1 - 1 / (t + 10.0)) * hbar + (0.8 - float(a[c])) / (t + 10.0)
            log_eps = mu - np.sqrt(t) / 0.05 * hbar
            w = t ** -0.75
            leb = w * log_eps + (1 - w) * leb
            e = np.exp(log_eps)
        s = st
        for a in a_means:
            s = da_update(a, s)
        assert float(s[0][c]) == pytest.approx(e, rel=1e-13)
        assert float(s[2][c]) == pytest.approx(leb, rel=1e-13)


def test_split_and_joint_samplers_agree_on_moments():
    """32 chains of each sampler on an 8-point probit GPA: the posterior
    means of the kernel hyperparameters and of two latents agree within 5
    standard errors of their difference (each from the ESS)."""
    _, mt = _gpa()
    pt, lat, lbt, at, bt = mt.make_split_logprob()
    g = torch.Generator().manual_seed(0)
    C = 32
    x0 = torch.cat([at, bt])[None] + 0.05 * torch.randn((C, at.shape[0] + bt.shape[0]),
                                                        generator=g, dtype=torch.float64)
    rs = split_hmc(pt, lat, lbt, x0[:, :at.shape[0]], x0[:, at.shape[0]:], g, n_iter=40,
                   a_iters=2, eps_a=0.25, eps_b=0.15, Lmin=3, Lmax=6)
    lp, _, _, _ = mt.make_logprob()
    rh = hmc(lp, x0, g, n_iter=80, eps=0.12, Lmin=3, Lmax=6)
    cols = [0, 1, at.shape[0], at.shape[0] + 1]
    s_split, s_joint = rs.samples[:, 16:, cols], rh.samples[:, 24:, cols]
    for s in (s_split, s_joint):
        assert torch.isfinite(s).all()
    def se(s):
        return s.reshape(-1, len(cols)).std(0) / torch.sqrt(gt.effective_sample_size(s))
    diff = (s_split.reshape(-1, 4).mean(0) - s_joint.reshape(-1, 4).mean(0)).abs()
    assert (diff <= 5 * torch.sqrt(se(s_split) ** 2 + se(s_joint) ** 2)).all(), diff
    assert 0.3 < float(rs.accept_rate_a.mean()) and 0.3 < float(rs.accept_rate_b.mean())


def test_split_sampler_api_rejects_block_flags_and_gpe():
    _, mt = _gpa()
    for bad in ({"kern": False}, {"kern": True}, {"noize": True}):
        with pytest.raises(ValueError, match="block flags"):
            gt.mcmc(mt, n_iter=2, sampler="split", verbose=False, **bad)
    with pytest.raises(ValueError, match="sampler"):
        gt.mcmc(mt, n_iter=2, sampler="nuts", verbose=False)
    rng = np.random.RandomState(0)
    m = gt.GPE(rng.randn(8, 1), rng.randn(8), kernel=gt.SE(0.0, 0.0), device="cpu")
    with pytest.raises(TypeError, match="GPA"):
        gt.mcmc(m, n_iter=2, sampler="split", verbose=False)


def test_warmup_plumbs_through():
    """n_warmup is additive: the warmup rows are returned apart, accept
    rates count only post-warmup proposals, the step sizes adapt during
    warmup and stay at their averaged values after it; mcmc() keeps only
    the post-warmup rows."""
    _, mt = _gpa()
    pt, lat, lbt, at, bt = mt.make_split_logprob()
    r = split_hmc(pt, lat, lbt, at, bt, torch.Generator().manual_seed(1), n_iter=3, n_warmup=4,
                  **KW)
    assert r.samples.shape == (3 * 2, at.shape[0] + bt.shape[0])
    assert r.warmup_samples.shape == (4 * 2, at.shape[0] + bt.shape[0])
    assert float(r.eps_a_final) != KW["eps_a"] and float(r.eps_b_final) != KW["eps_b"]
    assert 0.0 <= float(r.accept_rate_a) <= 1.0 and 0.0 <= float(r.accept_rate_b) <= 1.0
    res = gt.mcmc(mt, torch.Generator().manual_seed(1), n_iter=3, n_warmup=4, sampler="split",
                  a_iters=2, eps_a=0.2, eps_b=0.1, Lmin=2, Lmax=4, verbose=False)
    assert res.samples.shape == (6, mt.num_params())
    assert res.accept_rate.shape == (2,)
