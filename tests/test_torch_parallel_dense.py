"""The port's distributed dense path (parallel/cholesky.py, parallel/dense.py,
parallel/gram.py) in one process, a mesh axis of size 1, against the JAX
package's on its virtual CPU mesh of 1 and of 4 devices, on the same seeded
numpy inputs, f64. Case for case the JAX package's
tests/test_distributed_dense.py, tests/test_distributed_cholesky.py and
tests/test_chains_x_j.py, at n = 64 (16 tiles of 4, so 4 a device on 4
devices).

Tolerances, stated at each assertion, are the JAX tests' own: the mll
rtol 1e-9 and its gradient rtol 1e-6 against the JAX package (and the dense
strategy), tiles and factors atol 1e-10 of their largest entry, solves atol
1e-8, the latent map's VJP rtol 1e-8. Bits do not follow the JAX package
(its factorization sums in its own order), so nothing is held bit for bit
across packages. The non-PD case must give -inf, and `ok` must come from
`info` (a finite factor with info = 1 is a failure)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.models.gpa import gpa_target as j_gpa_target
from gaussianprocesses_jl_tpu.models.gpe import gpe_target as j_gpe_target
from gaussianprocesses_jl_tpu.parallel import cholesky as jc
from gaussianprocesses_jl_tpu.parallel import dense as jd
from gaussianprocesses_jl_tpu.parallel.gram import ring_gram as j_ring_gram
from gaussianprocesses_jl_tpu.parallel.mesh import make_mesh as j_make_mesh
from gaussianprocesses_jl_tpu_torch.convert import load_distributed
from gaussianprocesses_jl_tpu_torch.inference.hmc import batched_value_and_grad, hmc
from gaussianprocesses_jl_tpu_torch.models.gpa import gpa_target
from gaussianprocesses_jl_tpu_torch.models.gpe import gpe_target
from gaussianprocesses_jl_tpu_torch.parallel import chains
from gaussianprocesses_jl_tpu_torch.parallel import cholesky as tc
from gaussianprocesses_jl_tpu_torch.parallel.dense import AmbientFullCovariance
from gaussianprocesses_jl_tpu_torch.parallel.mesh import make_pod_mesh

B, N = 4, 64
JAX_DEVICES = [1, 4]


def _jmesh(P, axis="j"):
    return j_make_mesh({axis: P}, devices=jax.devices()[:P])


def _tmesh(axis="j"):
    return gt.make_mesh({axis: 1}, device="cpu")


def _data(n=N, d=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    return X, np.sin(X[:, 0]) + 0.2 * rng.randn(n)


def _spd(n, seed=0):
    A = np.random.RandomState(seed).randn(n, n)
    return A @ A.T + n * np.eye(n)


def _close(got, ref, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(ref, dtype=float),
                               rtol=rtol, atol=atol)


def _value_grad_t(fn, vec):
    vec = torch.as_tensor(np.asarray(vec)).clone().requires_grad_()
    val = fn(vec)
    (g,) = torch.autograd.grad(val, vec)
    return float(val), g.numpy()


def _value_grad_j(fn, vec):
    v, g = jax.jit(jax.value_and_grad(fn))(jnp.asarray(np.asarray(vec)))
    return float(v), np.asarray(g)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_build_tiles_matches_dense_gram(P):
    X, _ = _data()
    kj = gj.SE(0.3, 0.1) + gj.Matern(2.5, -0.2, 0.0)
    kt = gt.SE(0.3, 0.1) + gt.Matern(2.5, -0.2, 0.0)
    mesh = _tmesh()
    K = tc.untile(tc.build_tiles(kt, 0.17, torch.as_tensor(X), B, mesh), B, mesh).numpy()
    Kj = jc.untile(jc.build_tiles(kj, jnp.asarray(0.17), jnp.asarray(X), B, _jmesh(P)), B,
                   _jmesh(P))
    ref = np.asarray(kj.gram(jnp.asarray(X))) + 0.17 * np.eye(N)
    _close(K, ref, atol=1e-10 * np.abs(ref).max())
    _close(K, Kj, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_build_tiles_heteroscedastic(P):
    X, _ = _data(seed=5)
    nv = np.exp(np.random.RandomState(6).randn(N) * 0.3)
    mesh = _tmesh()
    K = tc.untile(tc.build_tiles(gt.SE(0.0, 0.0), torch.as_tensor(nv), torch.as_tensor(X), B,
                                 mesh), B, mesh).numpy()
    Kj = jc.untile(jc.build_tiles(gj.SE(0.0, 0.0), jnp.asarray(nv), jnp.asarray(X), B,
                                  _jmesh(P)), B, _jmesh(P))
    _close(K, Kj, atol=1e-10)
    _close(K, np.asarray(gj.SE(0.0, 0.0).gram(jnp.asarray(X))) + np.diag(nv), atol=1e-10)


def _factor_pair(P, seed):
    K = _spd(N, seed)
    mesh = _tmesh()
    L_t, ld_t = tc.distributed_cholesky(tc.tile_and_shard(torch.as_tensor(K), B, mesh), mesh)
    jm = _jmesh(P)
    L_j, ld_j = jc.distributed_cholesky(jc.tile_and_shard(jnp.asarray(K), B, jm), jm)
    return K, mesh, (L_t, ld_t), jm, (L_j, ld_j)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_distributed_cholesky_matches_dense(P):
    K, mesh, (L_t, ld_t), jm, (L_j, ld_j) = _factor_pair(P, 0)
    L = tc.untile(L_t, B, mesh).numpy()
    ref = np.linalg.cholesky(K)
    _close(L, ref, atol=1e-8 * np.abs(ref).max())
    _close(L, np.tril(jc.untile(L_j, B, jm)), atol=1e-10 * np.abs(ref).max())
    _close(float(ld_t), np.linalg.slogdet(K)[1], rtol=1e-10)
    _close(float(ld_t), float(ld_j), rtol=1e-12)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_distributed_solve_matches_dense(P):
    K, mesh, (L_t, _), jm, (L_j, _) = _factor_pair(P, 1)
    b = np.random.RandomState(2).randn(N)
    w = tc.distributed_solve_lower(L_t, torch.as_tensor(b), B, mesh).numpy()
    ref = np.linalg.solve(np.linalg.cholesky(K), b)
    _close(w, ref, atol=1e-8 * np.abs(ref).max())
    _close(w, jc.distributed_solve_lower(L_j, jnp.asarray(b), B, jm), atol=1e-12)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_distributed_solves_match_dense(P):
    K, mesh, (L_t, ld_t), jm, (L_j, _) = _factor_pair(P, 1)
    rng = np.random.RandomState(2)
    b, Bm = rng.randn(N), rng.randn(N, 5)
    L_ref = np.linalg.cholesky(K)
    bt, Bt = torch.as_tensor(b), torch.as_tensor(Bm)
    cases = [
        (tc.distributed_solve_lower(L_t, bt, B, mesh), np.linalg.solve(L_ref, b),
         jc.distributed_solve_lower(L_j, jnp.asarray(b), B, jm), 1e-8),
        (tc.distributed_solve_upper(L_t, bt, B, mesh), np.linalg.solve(L_ref.T, b),
         jc.distributed_solve_upper(L_j, jnp.asarray(b), B, jm), 1e-8),
        (tc.distributed_chol_solve(L_t, Bt, B, mesh), np.linalg.solve(K, Bm),
         jc.distributed_chol_solve(L_j, jnp.asarray(Bm), B, jm), 1e-7),
        (tc.distributed_unwhiten(L_t, Bt, B, mesh), L_ref @ Bm,
         jc.distributed_unwhiten(L_j, jnp.asarray(Bm), B, jm), 1e-8),
    ]
    for got, ref, jax_got, atol in cases:
        _close(got.numpy(), ref, atol=atol)
        _close(got.numpy(), jax_got, atol=atol)
    _close(float(ld_t), np.linalg.slogdet(K)[1], rtol=1e-10)


def _composite(pkg):
    return pkg.SE(0.2, 0.1) * pkg.RQ(0.1, 0.0, 0.3) + pkg.Matern(1.5, 0.0, -0.5)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_distributed_mll_value_and_grad_match_single_device(P):
    """The distributed GPE target's value rtol 1e-9 and gradient rtol 1e-6
    against the JAX package's distributed target and the dense strategy."""
    X, y = _data(seed=3)
    beta = np.array([0.1, -0.2, 0.05])
    pj = gj.GPEParams(lognoise=gj.Param(value=jnp.asarray(-0.7)),
                      mean=gj.MeanLin(beta=jnp.asarray(beta)), kernel=_composite(gj))
    pt = gt.GPEParams(lognoise=gt.Param(value=torch.tensor(-0.7)),
                      mean=gt.MeanLin(beta=torch.as_tensor(beta)),
                      kernel=_composite(gt)).to(dtype=torch.float64)
    Xt, yt, Xj, yj = torch.as_tensor(X), torch.as_tensor(y), jnp.asarray(X), jnp.asarray(y)
    vec = np.asarray(pj.flat_params())
    v_t, g_t = _value_grad_t(lambda v: gpe_target(
        pt.with_flat_params(v), Xt, yt, gt.DistributedFullCovariance(_tmesh(), B=B))[0], vec)
    v_d, g_d = _value_grad_t(lambda v: gpe_target(pt.with_flat_params(v), Xt, yt)[0], vec)
    v_j, g_j = _value_grad_j(lambda v: j_gpe_target(
        pj.with_flat_params(v), Xj, yj, gj.DistributedFullCovariance(mesh=_jmesh(P), B=B))[0],
        vec)
    for v_ref, g_ref in ((v_j, g_j), (v_d, g_d)):
        _close(v_t, v_ref, rtol=1e-9)
        _close(g_t, g_ref, rtol=1e-6, atol=1e-9 * np.abs(g_ref).max())


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_distributed_mll_heteroscedastic_grad(P):
    X, y = _data(seed=9)
    ln = 0.1 * np.random.RandomState(10).randn(N) - 0.5
    pj = gj.GPEParams(lognoise=gj.Param(value=jnp.asarray(ln)), mean=gj.MeanZero(),
                      kernel=gj.SE(0.0, 0.0))
    pt = gt.GPEParams(lognoise=gt.Param(value=torch.as_tensor(ln)), mean=gt.MeanZero(),
                      kernel=gt.SE(0.0, 0.0)).to(dtype=torch.float64)
    vec = np.asarray(pj.flat_params())
    v_t, g_t = _value_grad_t(lambda v: gpe_target(
        pt.with_flat_params(v), torch.as_tensor(X), torch.as_tensor(y),
        gt.DistributedFullCovariance(_tmesh(), B=B))[0], vec)
    v_j, g_j = _value_grad_j(lambda v: j_gpe_target(
        pj.with_flat_params(v), jnp.asarray(X), jnp.asarray(y),
        gj.DistributedFullCovariance(mesh=_jmesh(P), B=B))[0], vec)
    _close(v_t, v_j, rtol=1e-9)
    _close(g_t, g_j, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_gpe_with_distributed_strategy_end_to_end(P):
    """GPE(covstrat=DistributedFullCovariance): mll, target and gradient,
    predict_f (variances and full covariance) and 5 optimizer steps,
    against the JAX package's GPE on its distributed strategy."""
    X, y = _data(seed=4)
    mj = gj.GPE(X, y, kernel=gj.SE(0.2, 0.1), lognoise=-0.7,
                covstrat=gj.DistributedFullCovariance(mesh=_jmesh(P), B=B))
    mt = gt.GPE(X, y, kernel=gt.SE(0.2, 0.1), lognoise=-0.7,
                covstrat=gt.DistributedFullCovariance(_tmesh(), B=B), device="cpu")
    _close(float(mt.mll), float(mj.mll), rtol=1e-10)
    t_t, g_t = mt.target_and_dtarget()
    t_j, g_j = mj.target_and_dtarget()
    _close(float(t_t), float(t_j), rtol=1e-10)
    _close(g_t.numpy(), np.asarray(g_j), rtol=1e-6)
    Xs = np.random.RandomState(7).randn(16, 3)
    for full in (False, True):
        for a, b in zip(mt.predict_f(Xs, full_cov=full), mj.predict_f(jnp.asarray(Xs),
                                                                        full_cov=full)):
            _close(a.numpy(), np.asarray(b), atol=1e-8)
    mt.optimize(maxiter=5)
    mj.optimize(maxiter=5)
    assert np.isfinite(float(mt.target)) and float(mt.target) >= float(t_t) - 1e-8
    _close(mt.params.flat_params().numpy(), np.asarray(mj.params.flat_params()), atol=1e-5)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_distributed_mll_function_matches_gpe(P):
    X, y = _data(seed=11)
    m = gt.GPE(X, y, kernel=gt.SE(0.2, 0.1), lognoise=-0.7, device="cpu")
    nv = torch.exp(2.0 * m.params.lognoise.value)
    got = float(tc.distributed_mll(m.params.kernel, nv, m.x, m.y, 16, _tmesh()))
    ref = float(jc.distributed_mll(gj.SE(0.2, 0.1), jnp.exp(2.0 * -0.7), jnp.asarray(X),
                                   jnp.asarray(y), B=16, mesh=_jmesh(P)))
    _close(got, float(m.mll), rtol=1e-9)
    _close(got, ref, rtol=1e-9)


def test_distributed_mll_matches_gpe():
    """tests/test_distributed_cholesky.py's end-to-end mll, d = 2, B = 16."""
    rng = np.random.RandomState(3)
    X = rng.randn(N, 2)
    y = np.sin(X[:, 0]) + 0.2 * rng.randn(N)
    m = gt.GPE(X, y, kernel=gt.SE(0.2, 0.1), lognoise=-0.7, device="cpu")
    got = float(tc.distributed_mll(m.params.kernel, math.exp(-1.4), m.x, m.y, 16, _tmesh()))
    _close(got, float(gj.GPE(X, y, kernel=gj.SE(0.2, 0.1), lognoise=-0.7).mll), rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_distributed_nonpd_rejected(dtype, monkeypatch):
    """A rank-one Const(20) gram with lognoise -200 is not PD: -inf, as in the
    JAX package. Whether cholesky_ex's partial factor stays finite there
    depends on the LAPACK build, so `ok` must come from `info`: a cholesky_ex
    that returns a finite factor of a PD tile with info = 1 must still give
    `not ok` and -inf."""
    X, y = _data(seed=12)
    pt = gt.GPEParams(lognoise=gt.Param(value=torch.tensor(-200.0)), mean=gt.MeanZero(),
                      kernel=gt.Const(20.0)).to(dtype=dtype)
    Xt, yt = torch.as_tensor(X, dtype=dtype), torch.as_tensor(y, dtype=dtype)
    mesh = _tmesh()
    assert float(gpe_target(pt, Xt, yt, gt.DistributedFullCovariance(mesh, B=B))[0]) == -math.inf
    tiles = tc.build_tiles(pt.kernel, math.exp(-400.0), Xt, B, mesh)
    L, logdet, ok = tc.distributed_cholesky(tiles.detach(), mesh, return_ok=True)
    assert not bool(ok)

    pd = gt.GPEParams(lognoise=gt.Param(value=torch.tensor(-0.7)), mean=gt.MeanZero(),
                      kernel=gt.SE(0.2, 0.1)).to(dtype=dtype)
    pd_tiles = tc.build_tiles(pd.kernel, math.exp(-1.4), Xt, B, mesh).detach()
    assert bool(tc.distributed_cholesky(pd_tiles, mesh, return_ok=True)[2])
    real = torch.linalg.cholesky_ex

    def info_one(A, **kw):
        Lkk, info = real(A, **kw)
        return Lkk, torch.ones_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", info_one)
    L, logdet, ok = tc.distributed_cholesky(pd_tiles, mesh, return_ok=True)
    assert bool(torch.isfinite(L).all()) and bool(torch.isfinite(logdet))
    assert not bool(ok)  # the failure shows in info alone
    assert float(gpe_target(pd, Xt, yt, gt.DistributedFullCovariance(mesh, B=B))[0]) == -math.inf
    monkeypatch.undo()
    pj = gj.GPEParams(lognoise=gj.Param(value=jnp.asarray(-200.0)), mean=gj.MeanZero(),
                      kernel=gj.Const(20.0))
    assert np.isneginf(float(j_gpe_target(pj, jnp.asarray(X), jnp.asarray(y),
                                          gj.DistributedFullCovariance(mesh=_jmesh(4), B=B))[0]))


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_ring_gram_matches_dense(P):
    X, _ = _data(seed=13)
    K = gt.ring_gram(gt.SE(0.1, 0.2) + gt.Periodic(0.0, 0.0, 0.5), torch.as_tensor(X),
                     _tmesh("data")).numpy()
    kj = gj.SE(0.1, 0.2) + gj.Periodic(0.0, 0.0, 0.5)
    _close(K, np.asarray(kj.gram(jnp.asarray(X))), atol=1e-12)
    _close(K, np.asarray(j_ring_gram(kj, jnp.asarray(X), _jmesh(P, "data"))), atol=1e-12)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_ring_gram_differentiable(P):
    X, y = _data(seed=14)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    kt = gt.SE(0.1, 0.2)
    _, g = _value_grad_t(lambda v: torch.sum(gt.ring_gram(kt.with_flat_params(v), Xt,
                                                          _tmesh("data")) * torch.outer(yt, yt)),
                         kt.flat_params().numpy())
    kj = gj.SE(0.1, 0.2)
    yj = jnp.asarray(y)
    _, g_j = _value_grad_j(lambda v: jnp.sum(j_ring_gram(kj.with_flat_params(v), jnp.asarray(X),
                                                         _jmesh(P, "data")) * jnp.outer(yj, yj)),
                           np.asarray(kj.flat_params()))
    _close(g, g_j, rtol=1e-8)


def test_choose_tile_size():
    for n, P, kw in ((256, 8, {}), (1024, 8, {"max_B": 64}), (3000, 1, {}), (16384, 1, {}),
                     (200, 1, {"max_B": 40})):
        assert tc.choose_tile_size(n, P, **kw) == jc.choose_tile_size(n, P, **kw)
    assert tc.choose_tile_size(256, 8) == 32
    assert tc.choose_tile_size(3000, 1) == 500
    for mod in (tc, jc):
        with pytest.raises(ValueError):
            mod.choose_tile_size(7, 8)


@pytest.mark.parametrize("P", JAX_DEVICES)
def test_distributed_unwhiten_build_vjp_matches_single_device(P):
    """Reverse mode through the sharded factorization (Murray's, on the
    shards) against autograd through a dense torch.linalg.cholesky and
    against the JAX package's custom VJP, for the kernel's parameters and
    v."""
    n, b, nv = 32, 4, 0.3
    rng = np.random.RandomState(21)
    X, v, gw = rng.randn(n, 3), rng.randn(n), rng.randn(n)
    Xt, gwt = torch.as_tensor(X), torch.as_tensor(gw)
    kt = gt.SE(0.2, 0.1) + gt.Matern(1.5, 0.0, -0.3)
    mesh = _tmesh()
    k_n = kt.n_params

    def loss_dist(vec):
        tiles = tc.build_tiles(kt.with_flat_params(vec[:k_n]), nv, Xt, b, mesh)
        f, ok = tc.distributed_unwhiten_build(tiles, vec[k_n:], b, mesh)
        return torch.sum(gwt * torch.sin(f))

    def loss_ref(vec):
        K = kt.with_flat_params(vec[:k_n]).gram(Xt) + nv * torch.eye(n, dtype=torch.float64)
        return torch.sum(gwt * torch.sin(torch.linalg.cholesky(K) @ vec[k_n:]))

    kj = gj.SE(0.2, 0.1) + gj.Matern(1.5, 0.0, -0.3)
    jm = _jmesh(P)

    def loss_jax(vec):
        tiles = jc.build_tiles(kj.with_flat_params(vec[:k_n]), jnp.asarray(nv), jnp.asarray(X),
                               b, jm)
        f, _ = jc.distributed_unwhiten_build(tiles, vec[k_n:], b, jm)
        return jnp.sum(jnp.asarray(gw) * jnp.sin(f))

    vec = np.concatenate([kt.flat_params().numpy(), v])
    val, g = _value_grad_t(loss_dist, vec)
    val_r, g_r = _value_grad_t(loss_ref, vec)
    val_j, g_j = _value_grad_j(loss_jax, vec)  # jitted
    _close(val, val_r, rtol=1e-12)
    _close(g, g_r, rtol=1e-8, atol=1e-10)
    _close(g, g_j, rtol=1e-8, atol=1e-10)


def _gpa_pair(likname, P):
    n = N
    rng = np.random.RandomState(31)
    X = rng.randn(n, 2)
    f_true = np.sin(X[:, 0])
    if likname == "bern":
        y = (f_true + 0.3 * rng.randn(n) > 0).astype(float)
        liks = (gj.BernLik(), gt.BernLik())
    else:
        y = rng.poisson(np.exp(0.5 * f_true)).astype(float)
        liks = (gj.PoisLik(), gt.PoisLik())
    v = 0.3 * np.random.RandomState(32).randn(n)
    mj = gj.GPA(X, y, gj.MeanConst(beta=jnp.asarray(0.1)), gj.Matern(1.5, jnp.zeros(2), 0.1),
                liks[0], covstrat=gj.DistributedFullCovariance(mesh=_jmesh(P), B=B))
    mj.params = mj.params.with_flat_params(mj.params.flat_params().at[:n].set(v))
    ms = []
    for cs in (gt.DistributedFullCovariance(_tmesh(), B=B), None):
        m = gt.GPA(X, y, gt.MeanConst(beta=0.1), gt.Matern(1.5, np.zeros(2), 0.1), liks[1],
                   covstrat=cs, device="cpu")
        m.params = m.params.with_flat_params(torch.cat([torch.as_tensor(v),
                                                        m.params.flat_params()[n:]]))
        ms.append(m)
    return mj, ms[0], ms[1]


@pytest.mark.parametrize("P", JAX_DEVICES)
@pytest.mark.parametrize("likname", ["bern", "pois"])
def test_gpa_distributed_target_and_grad(likname, P):
    """The GPA target and gradient through the distributed latent map,
    against the JAX package's distributed GPA (value rtol 1e-10, gradient
    rtol 1e-6) and the dense strategy; then predict_f."""
    mj, mt, md = _gpa_pair(likname, P)
    vec = np.asarray(mj.params.flat_params())
    v_t, g_t = _value_grad_t(lambda v: gpa_target(mt.params.with_flat_params(v), mt.x, mt.y,
                                                  mt.covstrat)[0], vec)
    v_d, g_d = _value_grad_t(lambda v: gpa_target(md.params.with_flat_params(v), md.x, md.y)[0],
                             vec)
    v_j, g_j = _value_grad_j(lambda v: j_gpa_target(mj.params.with_flat_params(v), mj.x, mj.y,
                                                    mj.covstrat)[0], vec)
    for v_ref, g_ref in ((v_j, g_j), (v_d, g_d)):
        _close(v_t, v_ref, rtol=1e-10)
        _close(g_t, g_ref, rtol=1e-6, atol=1e-9 * np.abs(g_ref).max())
    Xs = np.random.RandomState(33).randn(8, 2)
    for a, b in zip(mt.predict_f(Xs), mj.predict_f(jnp.asarray(Xs))):
        _close(a.numpy(), np.asarray(b), atol=1e-8)


def test_gpa_distributed_hmc_smoke():
    """15 HMC iterations on the distributed GPA target: finite, and the
    draws of the dense target's run with the same generator (atol 1e-8)."""
    n = 32
    rng = np.random.RandomState(41)
    X = rng.randn(n, 2)
    y = (np.sin(X[:, 0]) > 0).astype(float)
    runs = []
    for cs in (gt.DistributedFullCovariance(_tmesh(), B=8), None):
        m = gt.GPA(X, y, gt.MeanZero(), gt.Matern(1.5, 0.0, 0.0), gt.BernLik(), covstrat=cs,
                   device="cpu")
        logprob, x0, _, _ = m.make_logprob()
        runs.append(hmc(logprob, x0, torch.Generator().manual_seed(0), n_iter=15, eps=0.02,
                        Lmin=2, Lmax=5))
    assert bool(torch.isfinite(runs[0].samples).all())
    _close(runs[0].samples.numpy(), runs[1].samples.numpy(), atol=1e-8)


@pytest.mark.parametrize("kind", ["gpe", "gpa"])
def test_distributed_target_under_vmap(kind):
    """The samplers' batched value and gradient (torch.func.vmap over 4
    chains) through the strategy's vmap rules equal the dense strategy's
    (rtol 1e-10) and a loop over the chains (rtol 1e-12)."""
    X, y = _data(seed=2)
    models = []
    for cs in (gt.DistributedFullCovariance(_tmesh(), B=B), None):
        if kind == "gpe":
            models.append(gt.GPE(X, y, kernel=gt.SE(0.1, 0.0), lognoise=-1.0, covstrat=cs,
                                 device="cpu"))
        else:
            models.append(gt.GPA(X, (y > 0).astype(float), gt.MeanZero(), gt.SE(0.1, 0.0),
                                 gt.BernLik(), covstrat=cs, device="cpu"))
    (lp, x0, _, _), (lp_d, _, _, _) = (m.make_logprob() for m in models)
    th = x0[None] + 0.1 * torch.as_tensor(np.random.RandomState(8).randn(4, x0.numel()))
    t, g = batched_value_and_grad(lp)(th)
    t_d, g_d = batched_value_and_grad(lp_d)(th)
    _close(t.numpy(), t_d.numpy(), rtol=1e-10)
    _close(g.numpy(), g_d.numpy(), rtol=1e-10, atol=1e-10 * float(g_d.abs().max()))
    for c in range(4):
        tc_, gc = _value_grad_t(lp, th[c].numpy())
        _close(float(t[c]), tc_, rtol=1e-12)
        _close(g[c].numpy(), gc, rtol=1e-12, atol=1e-12 * float(np.abs(gc).max()))


# --- chains x j (tests/test_chains_x_j.py) ---------------------------------

CHAINS, N_CX, D_CX, B_CX = 4, 32, 2, 4


def _cx_data():
    rng = np.random.RandomState(0)
    X = rng.randn(N_CX, D_CX)
    return X, np.sin(X[:, 0]) + 0.3 * rng.randn(N_CX)


def test_pod_mesh_shape():
    pod = make_pod_mesh({"j": 1}, device="cpu")
    assert pod.axis_names == ("chains", "j")
    assert pod.shape == {"chains": 1, "j": 1}


@pytest.mark.parametrize("kind", ["gpe", "gpa"])
def test_chains_x_j_matches_single_axis(kind):
    """sharded_hmc over AmbientFullCovariance on a pod mesh gives the draws
    of the single-axis run on the dense target (atol 1e-6, the JAX test's),
    with the same seed."""
    X, y = _cx_data()
    pod = make_pod_mesh({"j": 1}, device="cpu")
    lps = []
    for cs in (AmbientFullCovariance(pod, B=B_CX), None):
        if kind == "gpe":
            m = gt.GPE(X, y, kernel=gt.SE(0.0, 0.0), lognoise=-1.0, covstrat=cs, device="cpu")
        else:
            m = gt.GPA(X, (y > 0).astype(float), gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik(),
                       covstrat=cs, device="cpu")
        lps.append(m.make_logprob())
    (lp_amb, x0, _, _), (lp_ref, x0r, _, _) = lps
    _close(x0.numpy(), x0r.numpy(), atol=0)
    theta0 = x0[None] + 0.05 * torch.as_tensor(np.random.RandomState(3).randn(CHAINS, x0.numel()))
    kw = dict(n_iter=8, n_warmup=4, eps0=0.05, Lmin=2, Lmax=5)
    r_amb = chains.sharded_hmc(lp_amb, theta0, 3, pod, **kw)
    r_ref = chains.sharded_hmc(lp_ref, theta0, 3, gt.make_mesh(device="cpu"), **kw)
    assert bool(torch.isfinite(r_amb.samples).all())
    _close(r_amb.samples.numpy(), r_ref.samples.numpy(), atol=1e-6)
    _close(r_amb.final_target.numpy(), r_ref.final_target.numpy(), rtol=1e-8)


def test_ambient_matches_dense_value_and_grad():
    """The GPE and GPA targets over AmbientFullCovariance against the JAX
    package's, differentiated inside its shard_map on 4 devices (value rtol
    1e-10, gradient rtol 1e-6), and against the dense targets."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as PS

    X, y = _cx_data()
    yb = (y > 0).astype(float)
    jm = _jmesh(4)
    pod = make_pod_mesh({"j": 1}, device="cpu")
    pairs = [
        (gj.GPE(X, y, kernel=gj.SE(0.0, 0.0), lognoise=-1.0,
                covstrat=jd.AmbientFullCovariance(axis="j", P_=4, B=B_CX)),
         gt.GPE(X, y, kernel=gt.SE(0.0, 0.0), lognoise=-1.0,
                covstrat=AmbientFullCovariance(pod, B=B_CX), device="cpu"),
         gt.GPE(X, y, kernel=gt.SE(0.0, 0.0), lognoise=-1.0, device="cpu"), 0.03),
        (gj.GPA(X, yb, gj.MeanZero(), gj.SE(0.0, 0.0), gj.BernLik(),
                covstrat=jd.AmbientFullCovariance(axis="j", P_=4, B=B_CX)),
         gt.GPA(X, yb, gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik(),
                covstrat=AmbientFullCovariance(pod, B=B_CX), device="cpu"),
         gt.GPA(X, yb, gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik(), device="cpu"), 0.05)]
    for mj, mt, md, shift in pairs:
        lp_j, x0, _, _ = mj.make_logprob()
        th = np.asarray(x0) + shift
        fn = jax.jit(shard_map(lambda t: jax.value_and_grad(lp_j)(t), mesh=jm,
                               in_specs=(PS(),), out_specs=(PS(), PS()), check_vma=False))
        v_j, g_j = fn(jnp.asarray(th))
        v_t, g_t = _value_grad_t(mt.make_logprob()[0], th)
        v_d, g_d = _value_grad_t(md.make_logprob()[0], th)
        for v_ref, g_ref in ((float(v_j), np.asarray(g_j)), (v_d, g_d)):
            _close(v_t, v_ref, rtol=1e-10)
            _close(g_t, g_ref, rtol=1e-6, atol=1e-10)


def test_load_distributed_carries_the_strategy():
    """convert.load_distributed puts a JAX DistributedFullCovariance's or
    AmbientFullCovariance's (axis, B) onto a port GPE over a port mesh, and
    the target follows the JAX model's (rtol 1e-10); a mismatched axis or
    axis size raises."""
    X, y = _data(seed=4)
    mesh = _tmesh()
    ref = float(gj.GPE(X, y, kernel=gj.SE(0.2, 0.1), lognoise=-0.7,
                       covstrat=gj.DistributedFullCovariance(mesh=_jmesh(1), B=8)).target)
    for js in (gj.DistributedFullCovariance(mesh=_jmesh(1), B=8),
               jd.AmbientFullCovariance(axis="j", P_=1, B=16)):
        mt = gt.GPE(X, y, kernel=gt.SE(0.2, 0.1), lognoise=-0.7, device="cpu")
        P_ = js.mesh.shape[js.axis] if hasattr(js, "mesh") else js.P_
        load_distributed(mt, type(js).__name__, mesh, axis=js.axis, B=js.B, P_=P_)
        assert type(mt.covstrat).__name__ == type(js).__name__ and mt.covstrat.B == js.B
        _close(float(mt.target), ref, rtol=1e-10)
    m = gt.GPE(X, y, device="cpu")
    with pytest.raises(ValueError):
        load_distributed(m, "DistributedFullCovariance", mesh, axis="data")
    with pytest.raises(ValueError):
        load_distributed(m, "AmbientFullCovariance", mesh, axis="j", B=8, P_=4)
    with pytest.raises(ValueError):
        load_distributed(m, "FullCovariance", mesh)
