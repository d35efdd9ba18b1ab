"""The port's HMC (inference/hmc.py) against the JAX package's.

Random streams differ, so the deterministic core is compared exactly: one
transition of the port from the momenta, path length and accept uniform
that JAX's `hmc_iteration` drew from its key (rebuilt here by splitting the
key as it does) equals JAX's transition. Whole runs are compared by
moments within Monte Carlo error. f64."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.inference.hmc import hmc_iteration as j_iteration
from gaussianprocesses_jl_tpu_torch.inference.hmc import (
    batched_value_and_grad,
    hmc,
    hmc_iteration,
    hmc_transition,
)
from jax_draws import Replay, hmc_draws


def _gpa(n=10, d=2):
    """A small probit classification GPA in both packages."""
    rng = np.random.RandomState(4)
    X = rng.randn(n, d)
    y = (np.sin(X[:, 0]) > 0).astype(float)
    ll = np.array([0.1, -0.2])
    mj = gj.GPA(X, y, gj.MeanZero(), gj.Matern(1.5, ll, 0.1), gj.BernLik())
    mt = gt.GPA(X, y, gt.MeanZero(), gt.Matern(1.5, ll, 0.1), gt.BernLik(), device="cpu")
    mj.set_priors(kern=[gj.priors.Normal(0.0, 2.0)] * (d + 1))
    mt.set_priors(kern=[gt.priors.Normal(0.0, 2.0)] * (d + 1))
    return mj, mt


@pytest.mark.parametrize("minv", [None, "diag"])
def test_one_transition_from_jax_draws_matches_jax(minv):
    """One transition on the GPA target (Lmax = 6) from JAX's draws: the new
    state, target, gradient, accept probability and decision, rtol 1e-10."""
    mj, mt = _gpa()
    lpj, x0j, _, _ = mj.make_logprob()
    lpt, _, _, _ = mt.make_logprob()
    D = x0j.shape[0]
    theta = np.asarray(x0j) + 0.2 * np.random.RandomState(1).randn(D)
    mv = None if minv is None else 0.5 + np.random.RandomState(2).rand(D)
    vgj = jax.value_and_grad(lpj)
    tj, gjv = vgj(jnp.asarray(theta))
    key = jax.random.PRNGKey(3)
    outj = j_iteration(vgj, jnp.asarray(theta), tj, gjv, key, 0.1, 2, 6,
                       minv=None if mv is None else jnp.asarray(mv))
    z, L, u = hmc_draws([key], D, 2, 6)
    vgt = batched_value_and_grad(lpt)
    th = torch.as_tensor(theta)[None]
    tt, gtv = vgt(th)
    np.testing.assert_allclose(tt.numpy(), [float(tj)], rtol=1e-12)
    nu0 = torch.as_tensor(z) if mv is None else torch.as_tensor(z) / torch.sqrt(torch.as_tensor(mv))
    outt = hmc_transition(vgt, th, tt, gtv, nu0, torch.as_tensor(L), torch.log(torch.as_tensor(u)),
                          0.1, 6, None if mv is None else torch.as_tensor(mv))
    for got, ref in zip(outt, outj):
        np.testing.assert_allclose(got[0].double().numpy(), np.asarray(ref, dtype=float),
                                   rtol=1e-10, atol=1e-12)
    # hmc_iteration draws through its stream: the replayed draws give the same
    again = hmc_iteration(vgt, th, tt, gtv, Replay(hmc=[(z, L, u)]), 0.1, 2, 6,
                          None if mv is None else torch.as_tensor(mv))
    for a, b in zip(again, outt):
        assert torch.equal(a, b)


def test_a_batch_of_chains_equals_a_loop_over_chains():
    """Four chains in one transition (per-chain step sizes) equal four
    one-chain transitions."""
    _, mt = _gpa()
    lpt, x0, _, _ = mt.make_logprob()
    rng = np.random.RandomState(5)
    C, D = 4, x0.shape[0]
    th = x0[None] + 0.2 * torch.as_tensor(rng.randn(C, D))
    nu0 = torch.as_tensor(rng.randn(C, D))
    L = torch.tensor([1, 3, 5, 2])
    log_u = torch.log(torch.as_tensor(rng.rand(C)))
    eps = torch.tensor([0.05, 0.1, 0.2, 0.15], dtype=torch.float64)
    vg = batched_value_and_grad(lpt)
    t, g = vg(th)
    out = hmc_transition(vg, th, t, g, nu0, L, log_u, eps, 5)
    for c in range(C):
        one = hmc_transition(vg, th[c:c + 1], t[c:c + 1], g[c:c + 1], nu0[c:c + 1], L[c:c + 1],
                             log_u[c:c + 1], eps[c:c + 1], 5)
        for a, b in zip(out, one):
            np.testing.assert_allclose(a[c].double().numpy(), b[0].double().numpy(), rtol=1e-12,
                                       atol=1e-14)


def _cliff(th):
    """A Gaussian with a hard -inf cliff at th[0] > 1 (the analog of a
    failed f32 Cholesky: -inf there, finite gradients near the edge)."""
    good = -0.5 * torch.sum(th * th)
    return torch.where(th[0] > 1.0, torch.full_like(good, -math.inf), good)


def test_chains_never_absorb_minus_inf_and_recover_from_it():
    """32 chains, half started inside the -inf region: every chain's state
    ends finite; a chain never steps into the region once out of it; the
    chains keep moving."""
    starts = torch.stack([torch.linspace(0.5, 1.5, 32, dtype=torch.float64),
                          torch.zeros(32, dtype=torch.float64)], dim=1)
    res = hmc(_cliff, starts, torch.Generator().manual_seed(3), n_iter=300, eps=0.4)
    s = res.samples
    assert torch.isfinite(s).all() and torch.isfinite(res.final_target).all()
    inside = s[..., 0] > 1.0
    for c in range(32):
        out = torch.nonzero(~inside[c])
        assert len(out) > 0  # recovered
        assert not inside[c, int(out[0]):].any()  # never fell back
    assert float(s[:, 100:, 0].std()) > 0.1


def test_gaussian_moments_within_mc_error():
    """64 chains on a 2-D Gaussian (mean [1, -2], sd [0.5, 2]): the pooled
    mean within 5 MC standard errors (counting ESS), the sd within 15%."""
    mu = torch.tensor([1.0, -2.0], dtype=torch.float64)
    sd = torch.tensor([0.5, 2.0], dtype=torch.float64)
    res = hmc(lambda th: -0.5 * torch.sum(((th - mu) / sd) ** 2),
              torch.zeros((64, 2), dtype=torch.float64), torch.Generator().manual_seed(0),
              n_iter=120, eps=0.25)
    s = res.samples[:, 20:]
    assert float(res.accept_rate.mean()) > 0.6
    ess = gt.effective_sample_size(s)
    se = sd / torch.sqrt(ess)
    assert ((s.reshape(-1, 2).mean(0) - mu).abs() <= 5 * se).all()
    np.testing.assert_allclose(s.reshape(-1, 2).std(0).numpy(), sd.numpy(), rtol=0.15)
    one = hmc(lambda th: -0.5 * torch.sum(th * th), torch.zeros(2, dtype=torch.float64),
              n_iter=5)
    assert one.samples.shape == (5, 2) and one.final.shape == (2,)
