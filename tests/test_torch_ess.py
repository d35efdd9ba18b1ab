"""The port's elliptical slice sampler (inference/ess.py) against the JAX
package's: iterations from the draws JAX made from its key (the ellipse's
direction, the slice height, the first angle and every shrink uniform,
rebuilt as its loop splits them) give JAX's states and proposal counts,
whatever the shrink rounds a block; whole runs are compared by moments
within Monte Carlo error. f64."""
import functools

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

MU, SIGMA = np.array([-1.0, 0.0, 0.0]), np.array([1.0, 2.0, 2.0])


@functools.lru_cache(maxsize=None)
def _problem(C):
    """(torch log likelihood, starts (C, 3), JAX's result, its draws) for a
    GPE's marginal likelihood at n = 40 (its three hyperparameters under Normal
    priors), C chains, 4 iterations; C = 1 runs JAX's single chain."""
    rng = np.random.RandomState(0)
    X = rng.randn(40, 1)
    y = np.sin(3.0 * X[:, 0]) + 0.1 * rng.randn(40)
    mj = gj.GPE(X, y, gj.MeanZero(), gj.SE(0.0, 0.0), lognoise=-1.0)
    mt = gt.GPE(X, y, gt.MeanZero(), gt.SE(0.0, 0.0), lognoise=-1.0, device="cpu")
    llj, x0j, _, _ = mj.make_logprob(include_priors=False)
    llt, _, _, _ = mt.make_logprob(include_priors=False)
    starts = np.asarray(x0j)[None] + 0.1 * rng.randn(C, 3)
    keys = [jax.random.PRNGKey(21 + c) for c in range(C)]

    def run_jax(th, k):
        return j_ess(llj, th, jnp.asarray(MU), jnp.asarray(SIGMA), k, n_iter=4)

    rj = (run_jax(jnp.asarray(starts[0]), keys[0]) if C == 1
          else jax.vmap(run_jax)(jnp.asarray(starts), jnp.stack(keys)))
    return llt, starts, rj, ess_draws(keys, 4, 3, _MAX_SHRINK)


class _Counted(Replay):
    """A Replay that records how many shrink blocks each iteration drew."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.blocks = []

    def ess_start(self, C, D, like):
        self.blocks.append(0)
        return super().ess_start(C, D, like)

    def ess_shrink_block(self, R, C, like):
        self.blocks[-1] += 1
        return super().ess_shrink_block(R, C, like)


@pytest.mark.parametrize("rounds", [1, 4, 8])
@pytest.mark.parametrize("chains", [None, 3])
def test_iterations_from_jax_draws_match_jax(chains, rounds):
    """Four iterations on a GPE's marginal likelihood, shrink rounds in
    blocks of 1, 4 and 8: the states, the final log likelihood and the mean
    proposal count, rtol 1e-10; one chain, and three at once against JAX's
    vmap. With three chains and blocks of 1 and 4 some iteration runs more
    than one block (a chain needs 7 or more rounds)."""
    llt, starts, rj, (st, sh) = _problem(chains or 1)
    stream = _Counted(ess_starts=st, ess_shrinks=sh)
    th = torch.as_tensor(starts[0] if chains is None else starts)
    rt = ess(llt, th, MU, SIGMA, stream, n_iter=4, rounds=rounds)
    assert stream.exhausted()
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(rt.final_loglik.numpy(), np.asarray(rj.final_loglik), rtol=1e-10)
    np.testing.assert_array_equal(rt.mean_proposals.numpy(), np.asarray(rj.mean_proposals))
    if chains and rounds < 8:
        assert max(stream.blocks) > 1


@pytest.mark.parametrize("rounds", [8, 16])
def test_a_chain_at_the_shrink_cap_matches_jax(rounds):
    """A likelihood that is -inf everywhere but at the start: from JAX's
    draws every round proposes -inf, and after `_MAX_SHRINK` rounds (25
    blocks of 8; 13 of 16, the last past JAX's draws on its padding) the
    chain keeps its state with JAX's proposal count, beside a chain that
    moves."""
    th0 = np.array([0.25, 0.0])

    def llj(th):
        return jnp.where(jnp.all(th == th0), 0.0, -jnp.inf) - 0.0 * jnp.sum(th)

    def llt(th):
        return torch.where((th == torch.as_tensor(th0)).all(), torch.zeros_like(th[0]),
                           torch.full_like(th[0], -float("inf")))

    keys = [jax.random.PRNGKey(5)]
    rj = j_ess(llj, jnp.asarray(th0), jnp.zeros(2), jnp.ones(2), keys[0], n_iter=2)
    st, sh = ess_draws(keys, 2, 2, _MAX_SHRINK)
    stream = _Counted(ess_starts=st, ess_shrinks=sh)
    rt = ess(llt, torch.as_tensor(th0), np.zeros(2), np.ones(2), stream, n_iter=2, rounds=rounds)
    assert stream.blocks == [-(-_MAX_SHRINK // rounds)] * 2
    np.testing.assert_array_equal(rt.samples.numpy(), np.asarray(rj.samples))
    assert float(rt.mean_proposals) == float(rj.mean_proposals) == _MAX_SHRINK + 1


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
