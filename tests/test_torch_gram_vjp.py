"""The gram op's backward (ops/gram.py `gram_vjp_plain`) against the JAX
package's gradient rule, and CPU models of the CUDA kernels' tile walks.

The JAX package's `_gram_cv_bwd` is `jax.vjp` of `_xla_reference`; the port's
plain VJP writes each profile's derivatives in closed form, as
`gram_vjp_kernel` in csrc/gram.cu computes them, so these tests check those
formulas on the CPU before the card runs them. The kernels themselves run
only on the card (chip_smoke.py holds them against these plain versions).
Inputs are made with numpy from a seed and handed to both packages.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.ops.pallas_gram import _pack, _unpack, _xla_reference
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op

# hyperparameters exact in binary, every family iso and (but Periodic) ARD
LL = np.array([0.25, -0.125, 0.375])
KERNELS = [
    ("SEIso", lambda g: g.SE(0.25, 0.125)),
    ("SEArd", lambda g: g.SE(LL, 0.125)),
    ("Mat12Iso", lambda g: g.Matern(0.5, 0.375, -0.125)),
    ("Mat12Ard", lambda g: g.Matern(0.5, LL, -0.125)),
    ("Mat32Iso", lambda g: g.Matern(1.5, 0.25, 0.25)),
    ("Mat32Ard", lambda g: g.Matern(1.5, LL, 0.25)),
    ("Mat52Iso", lambda g: g.Matern(2.5, -0.125, 0.0)),
    ("Mat52Ard", lambda g: g.Matern(2.5, LL, 0.0)),
    ("RQIso", lambda g: g.RQ(0.25, 0.125, -0.25)),
    ("RQArd", lambda g: g.RQ(LL, 0.125, -0.25)),
    ("Periodic", lambda g: g.Periodic(ll=0.125, lsigma=0.0625, lp=0.5)),
]
EXTRA = {"RQIso": "lalpha", "RQArd": "lalpha", "Periodic": "lp"}


def _inputs(name, dtype=np.float64):
    """X1 (300, 3), X2 (77, 3), ragged against the 64-wide tile, scaled as
    the module scales them (ARD: by exp(-ll)); a duplicate point off the
    diagonal in X1."""
    rng = np.random.RandomState(11)
    X1, X2 = rng.randn(300, 3), rng.randn(77, 3)
    X1[40] = X1[7]
    if name.endswith("Ard"):
        X1, X2 = X1 * np.exp(-LL), X2 * np.exp(-LL)
    return X1.astype(dtype), X2.astype(dtype)


def _jax_vjp(kj, A, B, G, sym):
    """jax.vjp of `_xla_reference` with an f64 parameter vector: (the
    gradients as a module of the kernel's fields, dA, dB)."""
    _, treedef, specs = _pack(kj)
    flat = jnp.concatenate([jnp.ravel(jnp.asarray(l, jnp.float64))
                            for l in jax.tree_util.tree_leaves(kj)])
    _, vjp = jax.vjp(lambda f, a, b: _xla_reference((treedef, specs, sym), f, a, b),
                     flat, jnp.asarray(A), jnp.asarray(B))
    dflat, dA, dB = vjp(jnp.asarray(G))
    return _unpack(treedef, specs, dflat), np.asarray(dA), np.asarray(dB)


def _compare(name, kt, grads, ref, rtol, atol_dp=0.0, atol_dx=0.0):
    dp, dX1, dX2 = grads
    gm, dA, dB = ref
    np.testing.assert_allclose(dp[0].item(), float(gm.lsigma), rtol=rtol, atol=atol_dp)
    if not name.endswith("Ard"):  # ARD passes ll = 0 to the op: ll acts through X
        np.testing.assert_allclose(dp[1].item(), float(gm.ll), rtol=rtol, atol=atol_dp)
    if name in EXTRA:
        np.testing.assert_allclose(dp[2].item(), float(getattr(gm, EXTRA[name])), rtol=rtol,
                                   atol=atol_dp)
    else:
        assert dp[2].item() == 0.0
    if dX1 is not None:
        np.testing.assert_allclose(dX1.numpy(), dA, rtol=rtol, atol=atol_dx)
    if dX2 is not None:
        np.testing.assert_allclose(dX2.numpy(), dB, rtol=rtol, atol=atol_dx)


@pytest.mark.parametrize("name,build", KERNELS, ids=[k[0] for k in KERNELS])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "cross"])
def test_plain_vjp_matches_jax_vjp_of_the_reference(name, build, sym):
    """f64, rtol 1e-10 (plus 1e-12 of the sums of magnitudes, for a
    component that cancels to near 0): dp only, then with the inputs'
    gradients, on a cotangent that is not symmetric."""
    kj, kt = build(gj), build(gt)
    A, B = _inputs(name)
    G = np.random.RandomState(12).randn(300, 300 if sym else 77)
    ref = _jax_vjp(kj, A, A if sym else B, G, sym)
    args = (kt._family, kt._gram_params(), torch.as_tensor(A),
            None if sym else torch.as_tensor(B), torch.as_tensor(G))
    dp_only = gram_op.gram_vjp_plain(*args, needs=(True, False, False))
    assert dp_only[1] is None and dp_only[2] is None
    _compare(name, kt, dp_only, ref, rtol=1e-10, atol_dp=1e-12 * np.abs(G).sum())
    full = gram_op.gram_vjp_plain(*args, needs=(True, True, not sym))
    assert (full[2] is None) == sym
    _compare(name, kt, full, ref, rtol=1e-10, atol_dp=1e-12 * np.abs(G).sum(),
             atol_dx=1e-12 * np.abs(G).sum(1).max())


@pytest.mark.f32
@pytest.mark.parametrize("name", ["RQIso", "Mat32Ard"])
def test_plain_vjp_in_f32_matches_jax_in_f64(name):
    """f32 inputs through the port, f64 through JAX. Tolerance: 1e-6 of the
    sums of magnitudes (sum |G| sigma^2 for dp, max_i sum_j |G_ij| for dX):
    f32 sums of n^2 terms round to about eps log2(n^2) of those."""
    build = dict(KERNELS)[name]
    kj, kt = build(gj), build(gt).to(dtype=torch.float32)
    A, B = _inputs(name, np.float32)
    G = np.random.RandomState(13).randn(300, 77).astype(np.float32)
    ref = _jax_vjp(kj, A.astype(np.float64), B.astype(np.float64), G.astype(np.float64), False)
    grads = gram_op.gram_vjp_plain(kt._family, kt._gram_params(), torch.as_tensor(A),
                                   torch.as_tensor(B), torch.as_tensor(G))
    assert all(t.dtype == torch.float32 for t in grads)
    sig2 = float(np.exp(2 * 0.25 if name == "Mat32Ard" else 2 * 0.125))
    grads = tuple(t.double() for t in grads)
    _compare(name, kt, grads, ref, rtol=0.0, atol_dp=1e-6 * np.abs(G).sum() * sig2,
             atol_dx=1e-6 * np.abs(G).sum(1).max() * sig2)


def tile_of(t, sym, nb2):
    """(bi, bj) of tile t as csrc/gram.cu's `tile_of` finds it: t = bi (bi +
    1) / 2 + bj with bj <= bi on a symmetric gram (a float square root,
    corrected by integer steps), row-major over nb2 tile columns otherwise."""
    if not sym:
        return t // nb2, t % nb2
    b = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while b * (b + 1) // 2 > t:
        b -= 1
    while (b + 1) * (b + 2) // 2 <= t:
        b += 1
    return b, t - b * (b + 1) // 2


@pytest.mark.parametrize("n", [1, 63, 64, 65, 77, 300])
@pytest.mark.parametrize("chains", [1, 3])
def test_forward_tile_walk_writes_every_output_once(n, chains):
    """The lower-triangle walk of a symmetric gram, each off-diagonal tile
    also writing its mirror, and the full walk of a cross gram, over the
    (chain, tile) pairs u = c ntiles + t of a batch of chains, shared out
    over persistent grids of 1, 7 and 1056 blocks: every output of every
    chain's ragged n written exactly once."""
    nb = -(-n // gram_op.TILE)
    for sym, (n1, n2) in ((True, (n, n)), (False, (n, 77))):
        nb2 = -(-n2 // gram_op.TILE)
        ntiles = gram_op.tile_count(n1, n2, sym)
        assert ntiles == (nb * (nb + 1) // 2 if sym else nb * nb2)
        for grid in (1, 7, 1056):
            writes = np.zeros((chains, n1, n2), dtype=int)
            seen = []
            for b in range(min(grid, chains * ntiles)):
                for u in range(b, chains * ntiles, grid):
                    c, t = divmod(u, ntiles)
                    bi, bj = tile_of(t, sym, nb2)
                    seen.append(u)
                    assert 0 <= bj < nb2 and (bj <= bi or not sym)
                    r, cs = slice(64 * bi, 64 * bi + 64), slice(64 * bj, 64 * bj + 64)
                    writes[c, r, cs] += 1
                    if sym and bi != bj:
                        writes[c, cs, r] += 1
            assert sorted(seen) == list(range(chains * ntiles))
            assert (writes == 1).all()


def test_triangle_index_holds_at_large_tile_counts():
    """The kernels find (bi, bj) of a lower-triangle tile from a float square
    root and correct it by integer steps; the correction holds far past any
    real n, where the float is off."""
    rng = np.random.RandomState(0)
    for t in [0, 1, 2, 3, 2**31, 2**40 + 12345] + list(rng.randint(0, 2**50, 200)):
        bi, bj = tile_of(int(t), True, 0)
        assert 0 <= bj <= bi and bi * (bi + 1) // 2 + bj == t


def _sum4(terms):
    """gram_vjp_reduce's `sum4`: four interleaved sums, added in a fixed
    order."""
    a = [terms[0] * 0 for _ in range(4)]
    full = len(terms) // 4 * 4
    for j in range(full):
        a[j % 4] = a[j % 4] + terms[j]
    for j in range(full, len(terms)):
        a[0] = a[0] + terms[j]
    return (a[0] + a[1]) + (a[2] + a[3])


def walked(b, c, ntiles, grid):
    """gram_vjp_reduce's `walked`: whether block b of a walk over `grid`
    blocks (b, b + grid, ...) meets one of chain c's pairs c ntiles ..
    (c + 1) ntiles - 1."""
    return (b - c * ntiles) % grid < ntiles


def _vjp_batched_model(family, P, A, B, G, grid, needs):
    """gram_vjp_kernel and gram_vjp_reduce on the CPU over a batch of chains
    (G (C, n1, n2); P, A and B with a chain dimension where they are per
    chain), tile by tile: each block walks the (chain, tile) pairs
    u = c ntiles + t in its order, adds a chain's hyperparameter terms and
    writes them to part_dp[chain][block] when its walk moves to another
    chain; each pair writes its row and column partials (x sum W - W x);
    the reduction adds a chain's dp over the blocks that walked it in block
    order, and each row's partials in tile order, four interleaved sums at
    a time (`sum4`)."""
    T = gram_op.TILE
    sym = B is None
    C = G.shape[0]
    at = lambda t, nd, c: t[c] if t.ndim == nd else t  # noqa: E731
    n1, d = A.shape[-2:]
    n2 = n1 if sym else B.shape[-2]
    nb1, nb2 = -(-n1 // T), -(-n2 // T)
    pad = lambda X, nb: torch.cat([X, X.new_zeros((nb * T - X.shape[0], d))])  # noqa: E731
    ntiles = gram_op.tile_count(n1, n2, sym)
    grid = min(grid, C * ntiles)
    rows, cols, part_dp = {}, {}, {}
    for b in range(grid):
        cur = None
        for u in range(b, C * ntiles, grid):
            c, t = divmod(u, ntiles)
            if c != cur:
                cur = c
                part_dp[c, b] = torch.zeros(3, dtype=G.dtype)
            p, X1 = at(P, 2, c), at(A, 3, c)
            P1 = pad(X1, nb1)
            P2 = P1 if sym else pad(at(B, 3, c), nb2)
            Gp = G.new_zeros((nb1 * T, nb2 * T))
            Gp[:n1, :n2] = G[c]
            bi, bj = tile_of(t, sym, nb2)
            r, cs = slice(T * bi, T * bi + T), slice(T * bj, T * bj + T)
            xr, xc = P1[r], P2[cs]
            r2 = ((xr[:, None, :] - xc[None, :, :]) ** 2).sum(-1)
            S = Gp[r, cs] + (Gp[cs, r].T if sym and bi != bj else 0)
            pinned = torch.zeros((T, T), dtype=torch.bool)
            if sym and bi == bj:
                pinned = torch.eye(T, dtype=torch.bool)
            r2 = torch.where(pinned, torch.zeros_like(r2), r2)
            K, dll, dex, dr2 = gram_op.gram_derivs(family, p, r2)
            part_dp[c, b] += torch.stack([2 * (S * K).sum(), (S * dll).sum(), (S * dex).sum()])
            W = torch.where(pinned, torch.zeros_like(S), 2 * S * dr2)
            rows[u] = xr * W.sum(1, keepdim=True) - W @ xc
            cols[u] = xc * W.sum(0)[:, None] - W.T @ xr
    # the reduction reads a partial exactly where the kernel wrote one
    assert set(part_dp) == {(c, b) for c in range(C) for b in range(grid)
                            if walked(b, c, ntiles, grid)}
    dp = (torch.stack([sum((part_dp[c, b] for b in range(grid) if (c, b) in part_dp),
                           torch.zeros(3, dtype=G.dtype)) for c in range(C)])
          if needs[0] else None)
    dX1 = dX2 = None
    if needs[1]:
        out = []
        for c in range(C):
            u0, parts = c * ntiles, []
            for b in range(nb1):
                if sym:
                    tri = u0 + b * (b + 1) // 2
                    parts.append(_sum4([rows[tri + bj] for bj in range(b + 1)])
                                 + _sum4([cols[u0 + bi * (bi + 1) // 2 + b]
                                          for bi in range(b, nb1)]))
                else:
                    parts.append(_sum4([rows[u0 + b * nb2 + bj] for bj in range(nb2)]))
            out.append(torch.cat(parts)[:n1])
        dX1 = torch.stack(out)
    if needs[2] and not sym:
        dX2 = torch.stack([torch.cat([_sum4([cols[c * ntiles + bi * nb2 + b] for bi in range(nb1)])
                                      for b in range(nb2)])[:n2] for c in range(C)])
    return dp, dX1, dX2


def _vjp_tile_model(family, p, X1, X2, G, grid, needs):
    """The model above for one gram: one chain, nothing batched but G."""
    return tuple(None if t is None else t[0]
                 for t in _vjp_batched_model(family, p, X1, X2, G[None], grid, needs))


@pytest.mark.parametrize("family", range(gram_op.PERIODIC + 1))
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "cross"])
def test_vjp_tile_model_matches_the_plain_vjp(family, sym):
    """The kernel's algorithm (mirrored cotangent tiles, pinned diagonal,
    row and column partials, sums in block and tile order) on ragged sizes
    and grids of 1, 2 and 5 blocks gives the plain VJP to f64 rounding."""
    rng = np.random.RandomState(family)
    X1 = torch.as_tensor(rng.randn(150, 3))
    X2 = None if sym else torch.as_tensor(rng.randn(77, 3))
    G = torch.as_tensor(rng.randn(150, 150 if sym else 77))
    p = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)
    ref = gram_op.gram_vjp_plain(family, p, X1, X2, G)
    for grid in (1, 2, 5):
        got = _vjp_tile_model(family, p, X1, X2, G, grid, (True, True, True))
        for a, b in zip(got, ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                           atol=1e-12 * float(b.abs().max()))


@pytest.mark.parametrize("family", [gram_op.SE, gram_op.MAT32, gram_op.RQ, gram_op.PERIODIC])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "cross"])
@pytest.mark.parametrize("ard", [False, True], ids=["shared_X", "per_chain_X"])
def test_batched_vjp_model_matches_the_batched_plain_vjp(family, sym, ard):
    """The kernel's algorithm over 3 chains (per-chain hyperparameters; X
    shared, or one X a chain as ARD gives), on grids of 1, 2, 5 and 64
    blocks (at 64, blocks that never meet a chain leave no partial for it):
    the vmapped plain VJP to f64 rounding, chain by chain."""
    rng = np.random.RandomState(10 + family)
    C = 3
    P = torch.as_tensor(0.2 * rng.randn(C, 3))
    A = torch.as_tensor(rng.randn(C, 130, 2) if ard else rng.randn(130, 2))
    B = None if sym else torch.as_tensor(rng.randn(C, 70, 2) if ard else rng.randn(70, 2))
    G = torch.as_tensor(rng.randn(C, 130, 130 if sym else 70))
    ref = gram_op.gram_vjp_plain(family, P, A, B, G)
    for c in range(C):  # the batched plain VJP is the loop over chains
        one = gram_op.gram_vjp_plain(family, P[c], A[c] if ard else A,
                                     None if sym else (B[c] if ard else B), G[c])
        for a, b in zip(ref, one):
            if a is not None:
                np.testing.assert_allclose(a[c].numpy(), b.numpy(), rtol=1e-14, atol=1e-14)
    for grid in (1, 2, 5, 64):
        got = _vjp_batched_model(family, P, A, B, G, grid, (True, True, True))
        for a, b in zip(got, ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                           atol=1e-12 * float(b.abs().max()))


def test_walked_finds_every_block_of_a_chain():
    """`walked` against the walk itself, for tile counts below, at and above
    the grid."""
    for ntiles, C, grid in ((10, 128, 660), (10, 3, 7), (1128, 2, 660), (3, 5, 64), (1, 4, 2)):
        met = {(u // ntiles, b) for b in range(min(grid, C * ntiles))
               for u in range(b, C * ntiles, min(grid, C * ntiles))}
        g = min(grid, C * ntiles)
        assert met == {(c, b) for c in range(C) for b in range(g) if walked(b, c, ntiles, g)}


def test_vjp_scratch_holds_the_partials():
    """The scratch the wrapper allocates holds every block's dp partial and
    the 64 x d partials of each tile for each side asked for, for each
    chain."""
    f = gram_op.vjp_scratch_elems
    assert f(3000, 3000, 10, True, False, False, 132) == 3 * 8 * 132
    tiles = 47 * 48 // 2
    assert f(3000, 3000, 10, True, True, False, 132) == 3 * 8 * 132 + 2 * tiles * 640
    assert f(300, 77, 10, False, True, True, 132) == 3 * 8 * 132 + 2 * 5 * 2 * 640
    assert f(300, 77, 10, False, False, True, 132) == 3 * 8 * 132 + 5 * 2 * 640
    assert f(200, 200, 5, True, True, False, 132, chains=128) == 128 * (3 * 8 * 132
                                                                        + 2 * 10 * 320)


def test_backward_on_the_cpu_is_the_plain_vjp_and_launches_nothing(monkeypatch):
    """A CPU tensor's backward goes through gram_vjp_plain with the
    gradients autograd asks for, and neither kernel is counted."""
    calls = []
    plain = gram_op.gram_vjp_plain

    def spy(family, p, X1, X2, G, needs):
        calls.append(tuple(needs))
        return plain(family, p, X1, X2, G, needs)

    monkeypatch.setattr(gram_op, "gram_vjp_plain", spy)
    before = dict(gram_op.LAUNCHES)
    X = torch.as_tensor(np.random.RandomState(1).randn(30, 2))
    p = torch.tensor([0.1, 0.2, 0.0], dtype=torch.float64, requires_grad=True)
    torch.autograd.grad(gram_op.gram(gram_op.SE, p, X).sum(), p)
    Xg = X.clone().requires_grad_()
    torch.autograd.grad(gram_op.gram(gram_op.MAT32, p, Xg, X).sum(), (p, Xg))
    assert calls == [(True, False, False), (True, True, False)]
    assert gram_op.LAUNCHES == before


@pytest.mark.parametrize("bad", ["device", "shape", "dtype", "strided"])
def test_vjp_launcher_refuses_what_the_kernel_does_not_take(bad):
    X = torch.as_tensor(np.random.RandomState(2).randn(20, 3))
    p = torch.zeros(3, dtype=torch.float64)
    G = torch.ones((20, 20), dtype=torch.float64)
    if bad == "shape":
        G = torch.ones((20, 19), dtype=torch.float64)
    elif bad == "dtype":
        G = G.float()
    elif bad == "strided":
        G = torch.ones((20, 40), dtype=torch.float64)[:, ::2]
    before = gram_op.LAUNCHES["gram_vjp"]
    with pytest.raises(ValueError, match="CUDA" if bad == "device" else "cotangent"):
        gram_op.launch_gram_vjp(gram_op.SE, p, X, None, G)
    assert gram_op.LAUNCHES["gram_vjp"] == before


@pytest.mark.parametrize("ll", [0.1, 8.0, 16.97], ids=["z_order_1", "z_1e-7", "z_1e-14"])
def test_rq_dlalpha_keeps_its_accuracy_where_z_is_small(ll):
    """RQ's dK/dlalpha = K alpha (z/(1+z) - log1p(z)) cancels to ~-K alpha
    z^2/2 where z = r2 / (2 alpha l^2) is small, as for a switched-off RQ
    term (Mauna Loa's optimum puts its length scale near e^17, z ~ 1e-11,
    where the closed form keeps ~1e-5 of relative accuracy). The plain VJP's
    dp for lalpha, and the derivative itself, against a 50-digit
    reference (mpmath): rtol 1e-12 at every z."""
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 50
    rng = np.random.RandomState(11)
    x = np.sort(rng.uniform(0.0, 46.0, 30))
    G = rng.randn(30, 30)
    lalpha = -1.8
    alpha = mpmath.exp(lalpha)
    il2 = mpmath.exp(-2 * mpmath.mpf(ll))
    ref_d = np.empty((30, 30))
    for i in range(30):
        for j in range(30):
            z = (mpmath.mpf(x[i]) - mpmath.mpf(x[j])) ** 2 * il2 / (2 * alpha)
            K = (1 + z) ** (-alpha)
            ref_d[i, j] = float(K * alpha * (z / (1 + z) - mpmath.log1p(z)))
    p = torch.tensor([0.0, ll, lalpha], dtype=torch.float64)
    X = torch.as_tensor(x[:, None])
    _, _, dex, _ = gram_op.gram_derivs(gram_op.RQ, p, gram_op.sqdist(X, X))
    off = ~np.eye(30, dtype=bool)
    np.testing.assert_allclose(dex.numpy()[off], ref_d[off], rtol=1e-12)
    dp, _, _ = gram_op.gram_vjp_plain(gram_op.RQ, p, X, None, torch.as_tensor(G),
                                      (True, False, False))
    ref_dp = float(np.sum(G * ref_d))
    np.testing.assert_allclose(float(dp[2]), ref_dp, rtol=1e-12,
                               atol=1e-12 * float(np.sum(np.abs(G * ref_d))))
