"""The port's dense linear algebra (ops/linalg.py) against the JAX package,
in f64: factorization with its failure flag, the blocked Cholesky, the
triangular inverse and SYRK, and `dense_quad_logdet`'s value and VJP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocesses_jl_tpu.ops import linalg as jl
from gaussianprocesses_jl_tpu_torch.ops import linalg as tl


def _spd(n, seed=0):
    A = np.random.RandomState(seed).randn(n, n)
    return A @ A.T / n + 0.5 * np.eye(n)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def test_safe_cholesky_pd_and_not_pd():
    K = _spd(30)
    L, ok = tl.safe_cholesky(_t(K))
    Lj, okj = jl.safe_cholesky(jnp.asarray(K))
    assert bool(ok) and bool(okj)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-12, atol=1e-13)
    bad = K.copy()
    bad[3, 3] = -5.0
    L, ok = tl.safe_cholesky(_t(bad))  # must not raise
    Lj, okj = jl.safe_cholesky(jnp.asarray(bad))
    assert not bool(ok) and not bool(okj)
    np.testing.assert_array_equal(L.numpy(), np.eye(30))
    nan = K.copy()
    nan[0, 0] = np.nan
    assert not bool(tl.safe_cholesky(_t(nan))[1])


def test_blocked_cholesky():
    K = _spd(50, 1)
    L, ld = tl.blocked_cholesky(_t(K), block=16)
    Lj, ldj = jl.blocked_cholesky(jnp.asarray(K), block=16)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(float(ld), float(ldj), rtol=1e-12)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K), rtol=1e-11, atol=1e-12)
    small, _ = tl.blocked_cholesky(_t(K[:10, :10]), block=16)
    np.testing.assert_allclose(small.numpy(), np.linalg.cholesky(K[:10, :10]), atol=1e-13)


def test_tri_inv_lower():
    L = np.linalg.cholesky(_spd(37, 2))
    got = tl.tri_inv_lower(_t(L), block=8)
    ref = jl.tri_inv_lower(jnp.asarray(L), block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.numpy() @ L, np.eye(37), atol=1e-11)
    np.testing.assert_allclose(tl.tri_inv_lower(_t(L)).numpy(), np.linalg.inv(L),
                               rtol=1e-10, atol=1e-12)


def test_tri_inv_lower_leaves_no_reference_cycle():
    """One call of the recursion (n = 37 in blocks of 8) leaves no tensor
    for the garbage collector: a self-calling closure held the padded
    factor and the diagonal blocks' inverses until the collector ran."""
    import gc

    L = _t(np.linalg.cholesky(_spd(37, 2)))
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        tl.tri_inv_lower(L, block=8)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert cyclic == []


def test_tri_syrk_lower():
    Linv = np.linalg.inv(np.linalg.cholesky(_spd(50, 3)))
    got = tl.tri_syrk_lower(_t(Linv), block=16)
    ref = jl.tri_syrk_lower(jnp.asarray(Linv), block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.numpy(), Linv.T @ Linv, rtol=1e-12, atol=1e-13)


def test_dense_quad_logdet_value_and_vjp():
    n = 40
    K = _spd(n, 4)
    r = np.random.RandomState(5).randn(n)
    qb, lb = 0.7, -1.3  # cotangents of quad and logdet
    Kt = _t(K).requires_grad_()
    rt = _t(r).requires_grad_()
    quad, logdet, ok = tl.dense_quad_logdet(Kt, rt)
    (qj, lj, okj), vjp = jax.vjp(lambda A, b: jl.dense_quad_logdet(A, b),
                                 jnp.asarray(K), jnp.asarray(r))
    assert bool(ok) and bool(okj)
    np.testing.assert_allclose(float(quad.detach()), float(qj), rtol=1e-12)
    np.testing.assert_allclose(float(logdet.detach()), float(lj), rtol=1e-12)
    gK, gr = torch.autograd.grad(qb * quad + lb * logdet, (Kt, rt))
    gKj, grj = vjp((jnp.asarray(qb), jnp.asarray(lb), np.zeros((), dtype=jax.dtypes.float0)))
    np.testing.assert_allclose(gK.numpy(), np.asarray(gKj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gr.numpy(), np.asarray(grj), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [300, 1100])
def test_explicit_kinv_route_against_jax(n):
    """The backward's route to K^-1 and alpha (`explicit_kinv`), at n where
    the recursion pads to 2 and 5 blocks of 256 and, at 1100, the product
    takes 2 blocks of 1024: against the JAX package's tri_inv_lower and
    tri_syrk_lower, and `dense_quad_logdet`'s VJP against JAX's, at the
    tolerances of the tests above."""
    K = _spd(n, 8)
    r = np.random.RandomState(9).randn(n)
    L = np.linalg.cholesky(K)
    w = np.linalg.solve(L, r)
    Kinv, alpha = tl.explicit_kinv(_t(L), _t(w))
    Linv_j = jl.tri_inv_lower(jnp.asarray(L))
    np.testing.assert_allclose(Kinv.numpy(), np.asarray(jl.tri_syrk_lower(Linv_j)),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(Linv_j.T @ jnp.asarray(w)),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Kinv.numpy(), np.linalg.inv(K), rtol=1e-9, atol=1e-12)
    Kt, rt = _t(K).requires_grad_(), _t(r).requires_grad_()
    quad, logdet, _ = tl.dense_quad_logdet(Kt, rt)
    gK, gr = torch.autograd.grad(0.7 * quad - 1.3 * logdet, (Kt, rt))
    _, vjp = jax.vjp(lambda A, b: jl.dense_quad_logdet(A, b), jnp.asarray(K), jnp.asarray(r))
    gKj, grj = vjp((jnp.asarray(0.7), jnp.asarray(-1.3), np.zeros((), dtype=jax.dtypes.float0)))
    np.testing.assert_allclose(gK.numpy(), np.asarray(gKj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gr.numpy(), np.asarray(grj), rtol=1e-10, atol=1e-12)


def test_dense_quad_logdet_flags_failure_without_raising():
    bad = _spd(20)
    bad[2, 2] = -1.0
    quad, logdet, ok = tl.dense_quad_logdet(_t(bad), _t(np.ones(20)))
    assert not bool(ok)


def test_default_jitter_add_diag_and_solves():
    assert tl.default_jitter(torch.float64) == jl.default_jitter(jnp.float64) == 1e-10
    assert tl.default_jitter(torch.float32) == jl.default_jitter(jnp.float32) == 1e-5
    K = _spd(12, 6)
    v = np.linspace(0.1, 1.2, 12)
    np.testing.assert_array_equal(tl.add_diag(_t(K), _t(v)).numpy(),
                                  np.asarray(jl.add_diag(jnp.asarray(K), jnp.asarray(v))))
    np.testing.assert_array_equal(tl.add_diag(_t(K), 0.25).numpy(), K + 0.25 * np.eye(12))
    L = np.linalg.cholesky(K)
    B = np.random.RandomState(7).randn(12, 3)
    for name in ("solve_lower", "solve_upper", "chol_solve"):
        for rhs in (B, B[:, 0]):
            np.testing.assert_allclose(
                getattr(tl, name)(_t(L), _t(rhs)).numpy(),
                np.asarray(getattr(jl, name)(jnp.asarray(L), jnp.asarray(rhs))),
                rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(float(tl.chol_logdet(_t(L))),
                               float(jl.chol_logdet(jnp.asarray(L))), rtol=1e-13)
    np.testing.assert_array_equal(tl.symmetrize(_t(B[:3])).numpy(),
                                  np.asarray(jl.symmetrize(jnp.asarray(B[:3]))))


def test_set_grad_gemm_precision_only_highest():
    tl.set_grad_gemm_precision("highest")
    with pytest.raises(ValueError):
        tl.set_grad_gemm_precision("high")


@pytest.mark.parametrize("n", [40, 300])
def test_vmap_over_chains_equals_a_loop(n):
    """`dense_quad_logdet` (its generated vmap rule) and `tri_inv_lower`
    under `torch.func.vmap` over 3 chains, value and gradient, equal a loop
    over the chains; at n = 300 the triangular inverse takes its padded
    route (n > 256, n % 256 != 0), which writes into a padded copy. The
    gradient is also held against JAX's VJP of its own dense_quad_logdet."""
    rng = np.random.RandomState(n)
    K = torch.stack([_t(_spd(n, seed)) for seed in range(3)])
    r = torch.as_tensor(rng.randn(3, n))

    def f(Kc, rc):
        quad, logdet, ok = tl.dense_quad_logdet(Kc, rc)
        return torch.where(ok, quad + 0.5 * logdet, torch.zeros_like(quad))

    (gK, gr), v = torch.func.vmap(torch.func.grad_and_value(f, argnums=(0, 1)))(K, r)
    for c in range(3):
        Kc, rc = K[c].clone().requires_grad_(), r[c].clone().requires_grad_()
        vc = f(Kc, rc)
        aK, ar = torch.autograd.grad(vc, (Kc, rc))
        assert float(v[c]) == pytest.approx(float(vc.detach()), rel=1e-14)
        np.testing.assert_allclose(gK[c].numpy(), aK.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(gr[c].numpy(), ar.numpy(), rtol=1e-12, atol=1e-14)
        jK, jr = jax.grad(lambda A, b: (lambda q, l, ok: q + 0.5 * l)(
            *jl.dense_quad_logdet(A, b)), argnums=(0, 1))(jnp.asarray(K[c].numpy()),
                                                        jnp.asarray(r[c].numpy()))
        np.testing.assert_allclose(gK[c].numpy(), np.asarray(jK), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(gr[c].numpy(), np.asarray(jr), rtol=1e-9, atol=1e-12)
    L = torch.linalg.cholesky(K)
    Linv = torch.func.vmap(tl.tri_inv_lower)(L)
    np.testing.assert_allclose(Linv.numpy(), torch.linalg.inv(L).numpy(), rtol=0, atol=1e-12)
    quad, logdet, ok = torch.func.vmap(tl.dense_quad_logdet)(K, r)
    assert quad.shape == logdet.shape == ok.shape == (3,) and bool(ok.all())
