"""Replaying the JAX package's random draws through the port's samplers.

The port's samplers take their random numbers from a `RandomStream`; the
JAX package's from `jax.random` keys, split as its samplers split them.
`Replay` is a stream that hands out draws made here from those keys, so a
test runs the port's deterministic cores on exactly the numbers the JAX
sampler used and compares the results (not draws: the two generators
differ). Imported by the tests; collects no test itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussianprocesses_jl_tpu_torch.inference.hmc import RandomStream


def hmc_draws(keys, D, Lmin, Lmax, dtype=jnp.float64):
    """(z (C, D), L (C,), u (C,)) of `hmc_iteration`'s draws, one key a
    chain: split(key, 3), then normal, randint and uniform."""
    zs, Ls, us = [], [], []
    for k in keys:
        k_mom, k_len, k_mh = jax.random.split(k, 3)
        zs.append(np.asarray(jax.random.normal(k_mom, (D,), dtype=dtype)))
        Ls.append(int(jax.random.randint(k_len, (), Lmin, Lmax + 1)))
        us.append(float(jax.random.uniform(k_mh, (), dtype=dtype)))
    return np.stack(zs), np.asarray(Ls), np.asarray(us)


def split_draws(keys, total, a_iters, D_a, D_b, Lmin, Lmax):
    """The HMC draws of `split_hmc` in the order the port asks for them:
    for each outer iteration, a_iters A updates then one B update; `keys`
    the chains' keys as the JAX sampler receives them."""
    per_chain = []
    for key in keys:
        outs = []
        for k in jax.random.split(key, total):
            k_a, k_b = jax.random.split(k)
            outs += [(ka, D_a) for ka in jax.random.split(k_a, a_iters)] + [(k_b, D_b)]
        per_chain.append(outs)
    return [hmc_draws([pc[i][0] for pc in per_chain], per_chain[0][i][1], Lmin, Lmax)
            for i in range(len(per_chain[0]))]


def ess_draws(keys, n_iter, D, max_shrink):
    """(starts, shrinks) of `ess`'s draws: for each iteration, (z (C, D),
    u (C,), angle (C,)) and the chains' shrink uniforms (C, max_shrink), as
    split(key, 4) and the shrink loop's split(k) make them."""
    starts, shrinks = [], []
    per = [jax.random.split(k, n_iter) for k in keys]
    for i in range(n_iter):
        z, u, th, sh = [], [], [], []
        for ks in per:
            k_nu, k_u, k_theta, k = jax.random.split(ks[i], 4)
            z.append(np.asarray(jax.random.normal(k_nu, (D,), dtype=jnp.float64)))
            u.append(float(jax.random.uniform(k_u, (), dtype=jnp.float64)))
            th.append(float(jax.random.uniform(k_theta, (), dtype=jnp.float64, minval=0.0,
                                               maxval=2.0 * jnp.pi)))
            row = []
            for _ in range(max_shrink):
                k, ku = jax.random.split(k)
                row.append(float(jax.random.uniform(ku, (), dtype=jnp.float64)))
            sh.append(row)
        starts.append((np.stack(z), np.asarray(u), np.asarray(th)))
        shrinks.append(np.asarray(sh))
    return starts, shrinks


def sharded_hmc_draws(key, C, total, D, Lmin, Lmax):
    """[(z (C, D), L (C,), u (C,))] for each iteration of the JAX package's
    `sharded_hmc`: its chains' keys split(key, C), carried and folded with
    the global iteration (`fold_in(keys, it)`) before each one."""
    keys = jax.random.split(key, C)
    out = []
    for it in range(total):
        keys = jax.vmap(jax.random.fold_in)(keys, jnp.full((C,), it))
        out.append(hmc_draws(keys, D, Lmin, Lmax))
    return out


def sharded_split_draws(key, C, total, a_iters, D_a, D_b, Lmin, Lmax, Lmin_b, Lmax_b):
    """For each outer iteration of the JAX package's `sharded_split_hmc`,
    the HMC draws in the order the port asks for them (a_iters A updates,
    then the B update): each chain's carried key folded with the iteration,
    split(k, a_iters + 1), the A updates from [1:], the B update from [0]."""
    keys = jax.random.split(key, C)
    out = []
    for it in range(total):
        keys = jax.vmap(jax.random.fold_in)(keys, jnp.full((C,), it))
        ks = jax.vmap(lambda k: jax.random.split(k, a_iters + 1))(keys)
        out.append([hmc_draws(ks[:, 1 + j], D_a, Lmin, Lmax) for j in range(a_iters)]
                   + [hmc_draws(ks[:, 0], D_b, Lmin_b, Lmax_b)])
    return out


def jax_target(logprob):
    """A JAX log target (D,) -> () as a torch function that the port's
    samplers batch with `torch.func.vmap(grad_and_value(...))`: its values
    and gradients are the JAX package's own, so a sampler run on it differs
    from the JAX sampler's only by the sampler's arithmetic. CPU f64."""
    vg = jax.jit(jax.vmap(jax.value_and_grad(logprob)))

    def call(theta):
        v, g = vg(theta.detach().numpy())
        return torch.tensor(np.asarray(v)), torch.tensor(np.asarray(g))

    class Target(torch.autograd.Function):
        @staticmethod
        def forward(theta):
            v, g = call(theta[None])
            return v[0], g[0]

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.mark_non_differentiable(output[1])
            ctx.save_for_backward(output[1])

        @staticmethod
        def backward(ctx, dv, dg):
            (g,) = ctx.saved_tensors
            return dv * g

        @staticmethod
        def vmap(info, in_dims, theta):
            return call(theta.movedim(in_dims[0], 0)), (0, 0)

    return lambda theta: Target.apply(theta)[0]


class Replay(RandomStream):
    """A RandomStream that hands out given draws, in order."""

    def __init__(self, hmc=(), ess_starts=(), ess_shrinks=(), normal=()):
        super().__init__(None)
        self._hmc, self._starts = list(hmc), list(ess_starts)
        self._shrinks, self._normal = list(ess_shrinks), list(normal)
        self._round = 0

    @staticmethod
    def _t(a, like, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or like.dtype, device=like.device)

    def normal(self, shape, like):
        out = self._t(self._normal.pop(0), like)
        assert tuple(out.shape) == tuple(shape)
        return out

    def hmc(self, C, D, Lmin, Lmax, like):
        z, L, u = self._hmc.pop(0)
        assert z.shape == (C, D)
        return self._t(z, like), self._t(L, like, torch.int64), self._t(u, like)

    def ess_start(self, C, D, like):
        self._round = 0
        self._rows = self._shrinks.pop(0)
        return tuple(self._t(a, like) for a in self._starts.pop(0))

    def ess_shrink_block(self, R, C, like):
        """Rounds [r, r + R) of the chains' shrink uniforms as (R, C); the
        rounds past JAX's last (`max_shrink`) are 0.5, which no chain reads:
        a chain is masked once it has had max_shrink rounds."""
        rows = self._rows[:, self._round:self._round + R]
        self._round += R
        pad = np.full((rows.shape[0], R - rows.shape[1]), 0.5)
        return self._t(np.concatenate([rows, pad], axis=1).T, like)

    def exhausted(self):
        return not (self._hmc or self._starts or self._normal)
