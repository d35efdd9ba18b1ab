"""The port's elliptical slice sampler (inference/ess.py) against the JAX
package's: iterations from the draws JAX made from its key (the ellipse's
direction, the slice height, the first angle and every shrink uniform,
rebuilt as its loop splits them) give JAX's states and proposal counts;
whole runs are compared by moments within Monte Carlo error. f64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.inference.ess import ess as j_ess
from gaussianprocesses_jl_tpu_torch.inference.ess import _MAX_SHRINK, ess
from jax_draws import Replay, ess_draws


@pytest.mark.parametrize("chains", [None, 3])
def test_iterations_from_jax_draws_match_jax(chains):
    """Four iterations on a GPE's marginal likelihood (its three
    hyperparameters under Normal priors): the states, the final log
    likelihood and the mean proposal count, rtol 1e-10; one chain, and
    three at once against JAX's vmap."""
    rng = np.random.RandomState(0)
    X, y = rng.randn(15, 1), np.sin(rng.randn(15))
    mj = gj.GPE(X, y, gj.MeanZero(), gj.SE(0.0, 0.0), lognoise=-1.0)
    mt = gt.GPE(X, y, gt.MeanZero(), gt.SE(0.0, 0.0), lognoise=-1.0, device="cpu")
    llj, x0j, _, _ = mj.make_logprob(include_priors=False)
    llt, _, _, _ = mt.make_logprob(include_priors=False)
    mu, sigma = np.array([-1.0, 0.0, 0.0]), np.array([1.0, 2.0, 2.0])
    C = chains or 1
    starts = np.asarray(x0j)[None] + 0.1 * rng.randn(C, 3)
    keys = [jax.random.PRNGKey(21 + c) for c in range(C)]

    def run_jax(th, k):
        return j_ess(llj, th, jnp.asarray(mu), jnp.asarray(sigma), k, n_iter=4)

    rj = (run_jax(jnp.asarray(starts[0]), keys[0]) if chains is None
          else jax.vmap(run_jax)(jnp.asarray(starts), jnp.stack(keys)))
    st, sh = ess_draws(keys, 4, 3, _MAX_SHRINK)
    stream = Replay(ess_starts=st, ess_shrinks=sh)
    th = torch.as_tensor(starts[0] if chains is None else starts)
    rt = ess(llt, th, mu, sigma, stream, n_iter=4)
    assert stream.exhausted()
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(rt.final_loglik.numpy(), np.asarray(rj.final_loglik), rtol=1e-10)
    np.testing.assert_array_equal(rt.mean_proposals.numpy(), np.asarray(rj.mean_proposals))


def test_gaussian_posterior_moments():
    """Prior N(0, 1), likelihood N(1, 0.5^2) per coordinate: 64 chains'
    pooled mean within 5 MC standard errors of the exact product
    posterior's, the variance within 20%."""
    res = ess(lambda th: -0.5 * torch.sum(((th - 1.0) / 0.5) ** 2),
              torch.zeros((64, 2), dtype=torch.float64), np.zeros(2), np.ones(2),
              torch.Generator().manual_seed(1), n_iter=100)
    s = res.samples[:, 10:]
    post_var = 1.0 / (1.0 + 1.0 / 0.25)
    post_mean = post_var / 0.25
    se = np.sqrt(post_var) / torch.sqrt(gt.effective_sample_size(s))
    assert ((s.reshape(-1, 2).mean(0) - post_mean).abs() <= 5 * se).all()
    np.testing.assert_allclose(s.reshape(-1, 2).var(0).numpy(), post_var, rtol=0.2)
    assert (res.mean_proposals >= 1.0).all()


def test_a_stuck_chain_keeps_its_state():
    """A likelihood that is -inf everywhere but at the start itself: the
    bracket shrinks toward the start without reaching it exactly, every
    round proposes -inf, and at the cap the chain keeps its state (as the
    JAX package's does)."""
    th0 = torch.tensor([[0.25, 0.0]], dtype=torch.float64)

    def ll(th):
        return torch.where((th == th0[0]).all(), torch.zeros_like(th[0]),
                           torch.full_like(th[0], -float("inf")))

    res = ess(ll, th0, np.zeros(2), np.ones(2), torch.Generator().manual_seed(0), n_iter=2)
    assert torch.equal(res.samples[0, -1], th0[0])
    assert float(res.mean_proposals) == _MAX_SHRINK + 1
