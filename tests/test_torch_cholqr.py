"""The float32 route of the sparse strategies' QR (`models/sparse._CholQR3`:
a shifted Cholesky QR in three passes whose Grams and n-side products are
float64) on the CPU.

* The forward on tall float32 matrices of cond(A) 1e2, 1e5 and 1e7, and of
  7e7 (where an unshifted Cholesky QR fails), 1e8, 9e8 and 1e10, against
  float64 Householder (R's diagonal made positive), each gap beside the
  library's float32 Householder on the same matrix.
* The VJP: in float64 against autograd through `torch.linalg.qr`; in
  float32 against that float64 gradient.
* SoR, DTC, FITC and FSA in float32 against float64, and against the same
  float32 model with an exact QR.
* The route under `torch.func.vmap`: a sampler's target over chains, and
  padded stacks.
* `QR_ROUTES`: which route each dtype takes, eagerly and through the graph
  layer's replays (capture emulated as in test_torch_graphs.py); a Gram
  whose Cholesky factor fails reads `ok` False.
"""
import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.inference import lbfgs
from gaussianprocesses_jl_tpu_torch.models import sparse
from gaussianprocesses_jl_tpu_torch.ops.linalg import add_diag, safe_cholesky
from gaussianprocesses_jl_tpu_torch.utils import graphs, profiling
from gpbench.configs import fitc_se_n100k as conf

from test_torch_graphs import emulated  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "gpbench" / "configs" / "fitc_se_n100k.json").read_text())
U32 = 2.0 ** -24  # float32's unit roundoff
ROWS, COLS = 3000, 48
KINDS = ["SoR", "DTC", "FITC", "FSA"]
# the benchmark's start box [-1, 1]^3 ([log noise, log l, log sigma]), and where
# the fits end (noise variance 0.01, l = 2.7), as in test_torch_fitc_config.py
BOX = [(-1.0, 0.0, 0.0), (0.25, -0.5, 0.75), (0.9, 0.9, -0.9), (-1.0, -1.0, 1.0),
       (1.0, 1.0, 1.0), (-1.0, 1.0, -1.0)]
OPTIMUM = [(-2.3, 1.05, 0.0)]


def _tall(cond, rows=ROWS, cols=COLS, seed=0):
    """U diag(s) V^T in float32, s log-spaced from 1 to 1/cond."""
    g = torch.Generator().manual_seed(seed)
    U = torch.linalg.qr(torch.randn(rows, cols, dtype=torch.float64, generator=g))[0]
    V = torch.linalg.qr(torch.randn(cols, cols, dtype=torch.float64, generator=g))[0]
    s = torch.logspace(0, -math.log10(cond), cols, dtype=torch.float64)
    return ((U * s) @ V.T).float()


def _positive(Q, R):
    """(Q, R) with R's diagonal made positive, as `_finish` makes it."""
    s = torch.sign(R.diagonal())
    s = torch.where(s == 0, torch.ones_like(s), s)
    return Q * s, s[:, None] * R


def _gaps(Q, R, A64, R64):
    Q, R = _positive(Q.double(), R.double())
    eye = torch.eye(R.shape[0], dtype=torch.float64)
    two = torch.linalg.matrix_norm
    return (float(two(Q.T @ Q - eye, 2)), float(two(Q @ R - A64, 2) / two(A64, 2)),
            float(two(R - R64) / two(R64)))


@pytest.mark.parametrize("cond", [1e2, 1e5, 1e7])
def test_forward_against_float64_householder(cond):
    """Q and R from float64 work rounded once to float32: ||Q^T Q - I||_2 and
    ||QR - A||_2 / ||A||_2 within 2 u32 (the rounding of Q's entries and of
    R's; read: 9e-9 and 3e-8), and R within 2 u32 of float64's R in
    Frobenius norm (its own rounding plus float64's error u64 cond(A) <
    1e-9; read 2.5e-8). The library's float32 Householder reads 3.5-4.2e-7,
    2.0-3.2e-7 and 1.3-1.7e-7 on the same matrices: the first two bounds sit
    below it, and the route's readings are held below the library's."""
    A = _tall(cond)
    A64 = A.double()
    assert 0.5 * cond < float(torch.linalg.cond(A64)) < 2 * cond
    _, R64 = _positive(*torch.linalg.qr(A64))
    Q, R, ok = sparse._CholQR3.apply(A)
    assert Q.dtype == R.dtype == torch.float32 and bool(ok)
    assert bool((R.diagonal() > 0).all()) and bool((torch.tril(R, -1) == 0).all())
    orth, res, rgap = _gaps(Q, R, A64, R64)
    assert orth < 2 * U32 and res < 2 * U32 and rgap < 2 * U32, (orth, res, rgap)
    lib = _gaps(*torch.linalg.qr(A), A64, R64)
    assert orth < lib[0] and res < lib[1], (orth, res, lib)


def _spread(rows=ROWS, cols=COLS, seed=0):
    """A generic float32 matrix as ill-conditioned as float32 lets one be:
    half its singular values 1, half 1e-9 before the rounding to float32,
    whose own error lifts the small ones to ~1e-8 (cond(A) 5.8e7-7.4e7)."""
    g = torch.Generator().manual_seed(seed)
    U = torch.linalg.qr(torch.randn(rows, cols, dtype=torch.float64, generator=g))[0]
    V = torch.linalg.qr(torch.randn(cols, cols, dtype=torch.float64, generator=g))[0]
    s = torch.ones(cols, dtype=torch.float64)
    s[cols // 2:] = 1e-9
    return ((U * s) @ V.T).float()


def _integer(k, rows=ROWS, cols=COLS, seed=0):
    """B T in float32, exactly: B small random integers, T the identity with
    k above the diagonal twice, so cond(A) ~ k^2 (1.0e8 at k = 1e4, 9.2e8 at
    3e4, 1.0e10 at 1e5) however the data round."""
    g = torch.Generator().manual_seed(seed)
    T = torch.eye(cols, dtype=torch.float64)
    T[0, 1] = T[2, 3] = k
    return (torch.randint(-8, 9, (rows, cols), generator=g).double() @ T).float()


@pytest.mark.parametrize("case, lo, hi", [(("spread", 0), 5e7, 8e7), (("spread", 1), 5e7, 8e7),
                                          (("integer", 1e4), 9e7, 2e8),
                                          (("integer", 3e4), 9e8, 2e9),
                                          (("integer", 1e5), 9e9, 2e10)])
def test_forward_beyond_an_unshifted_cholesky_qr(case, lo, hi):
    """Where an unshifted Cholesky QR in float64 fails (cond(A)^2 u64 ~ 1:
    in two passes it failed on both `_spread` matrices, ok False), and on
    exact matrices up to cond(A) 1e10, the shifted first pass factors and
    Q and R are as good as at cond 1e2:
    ||Q^T Q - I||_2, ||QR - A||_2 / ||A||_2 and R's gap to float64's R all
    within 2 u32 (read: at most 1.3e-8, 4.7e-8 and 2.6e-8), ok True, and
    the first two below the library's float32 Householder (3.7-8.6e-7 and
    0.6-5.1e-7)."""
    kind, arg = case
    A = _spread(seed=arg) if kind == "spread" else _integer(arg)
    A64 = A.double()
    assert lo < float(torch.linalg.cond(A64)) < hi
    _, R64 = _positive(*torch.linalg.qr(A64))
    Q, R, ok = sparse._CholQR3.apply(A)
    assert bool(ok)
    orth, res, rgap = _gaps(Q, R, A64, R64)
    assert orth < 2 * U32 and res < 2 * U32 and rgap < 2 * U32, (orth, res, rgap)
    lib = _gaps(*torch.linalg.qr(A), A64, R64)
    assert orth < lib[0] and res < lib[1], (orth, res, lib)


def test_a_failed_factor_reads_not_ok_and_stays_finite():
    """A zero column makes the Gram singular: the shift lets the first
    factor succeed, but the second pass's Gram keeps the zero row and its
    factor fails: `ok` is False and Q and R are finite (the factor is
    replaced by the identity), so the objective's guard sees the failure."""
    A = _tall(1e2, rows=200, cols=8)
    A[:, 3] = 0.0
    Q, R, ok = sparse._CholQR3.apply(A)
    assert not bool(ok)
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())


def _cotangents(rows, cols, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, cols, dtype=torch.float64, generator=g).to(dtype),
            torch.triu(torch.randn(cols, cols, dtype=torch.float64, generator=g)).to(dtype))


def _householder_vjp(A64, dQ, dR):
    """dA of <dQ, Q> + <dR, R> through torch.linalg.qr, R's diagonal made
    positive (the sign a constant)."""
    A = A64.clone().requires_grad_()
    Q, R = _positive(*torch.linalg.qr(A))
    (dA,) = torch.autograd.grad((Q * dQ).sum() + (R * dR).sum(), A)
    return dA


def _cholqr_vjp(A, dQ, dR):
    A = A.clone().requires_grad_()
    Q, R, _ = sparse._CholQR3.apply(A)
    (dA,) = torch.autograd.grad((Q * dQ).sum() + (R * dR).sum(), A)
    return dA


def test_vjp_matches_householder_in_float64():
    """In float64 the two routes factor the same A to ~1e-15, and their VJPs
    are the same formula: 1e-10 relative (read 1.8e-15)."""
    A64 = _tall(1e2, rows=500, cols=24).double()
    dQ, dR = _cotangents(500, 24, torch.float64)
    got, want = _cholqr_vjp(A64, dQ, dR), _householder_vjp(A64, dQ, dR)
    gap = float(torch.linalg.matrix_norm(got - want) / torch.linalg.matrix_norm(want))
    assert gap < 1e-10, gap


@pytest.mark.parametrize("cond", [1e2, 1e5])
def test_vjp_in_float32_against_float64(cond):
    """The float32 VJP (Q and R from the float32 route, the formula in
    float32) against the float64 Householder gradient of the same float32
    matrix. Its error grows as u32 cond(A) (the solve against R^T): within
    100 u32 cond(A) (read 1.9e-7 at cond 1e2 and 4.8e-7 at 1e5), and no more
    than twice the library's float32 Householder's gap on the same matrix
    (8.9e-7 and 2.9e-4: its R is the less accurate)."""
    A = _tall(cond, rows=1000, cols=32)
    dQ, dR = _cotangents(1000, 32, torch.float32)
    want = _householder_vjp(A.double(), dQ.double(), dR.double())

    def gap(dA):
        return float(torch.linalg.matrix_norm(dA.double() - want) / torch.linalg.matrix_norm(want))

    got = gap(_cholqr_vjp(A, dQ, dR))
    lib = gap(_householder_vjp(A, dQ, dR))
    assert got < 100 * U32 * cond and got < 2 * lib, (got, lib)


def _model(kind, dtype, n=2000, m=32):
    """A sparse model on configuration #4's draw at n points and m inducing
    rows; FSA over 8 blocks of the points ordered along x_0."""
    cfg = copy.deepcopy(CFG)
    cfg["m"] = m
    X, y, rows = conf.draw(cfg, n)
    Xt, yt = torch.from_numpy(X).to(dtype), torch.from_numpy(y).to(dtype)
    Xu = Xt[torch.from_numpy(rows)]
    kw = dict(kernel=gp.SE(0.0, 0.0), lognoise=0.0, device="cpu")
    if kind == "FSA":
        order = np.argsort(X[:, 0])
        blocks = [order[k * n // 8:(k + 1) * n // 8].tolist() for k in range(8)]
        return gp.FSA(Xt, Xu, blocks, yt, **kw)
    return getattr(gp, kind)(Xt, Xu, yt, **kw)


def _f32_constants(kernel, Xu, X):
    """`sparse._common_pieces` with float32's jitter on Kuu (1e-4 of its
    scale), for a float64 model held to a float32 one."""
    Kuu = kernel.gram(Xu)
    scale = torch.clamp(torch.max(Kuu.diagonal()), min=1.0)
    Luu, ok = safe_cholesky(add_diag(Kuu, 1e-4 * scale))
    return Kuu, Luu, ok, kernel.gram(Xu, X)


def _rel(v, g, vr, gr):
    return (abs(float(v) - float(vr)) / abs(float(vr)),
            float(torch.linalg.vector_norm(g.double() - gr.double())
                  / torch.linalg.vector_norm(gr.double())))


@pytest.mark.parametrize("kind", KINDS)
def test_strategies_in_float32_match_float64(kind, monkeypatch):
    """Each strategy's float32 value and gradient, through the float32
    route, against its float64 model with the float32 constants (Kuu's
    jitter 1e-4 of its scale, the floors 1e-5) over the start box: the
    tolerances of test_torch_fitc_config.py's float32 test, 3e-5 and 1e-3
    (read: at most 6.2e-6 and 3.6e-6)."""
    vg32 = _model(kind, torch.float32).make_objective()[0]
    vg64 = _model(kind, torch.float64).make_objective()[0]
    sparse.QR_ROUTES.clear()
    got = [vg32(torch.tensor(t, dtype=torch.float32)) for t in BOX]
    assert set(k[0] for k in sparse.QR_ROUTES) == {"cholqr3"}
    monkeypatch.setattr(sparse, "_common_pieces", _f32_constants)
    monkeypatch.setattr(sparse, "default_jitter", lambda dtype: 1e-5)
    for t, (v, g) in zip(BOX, got):
        value, grad = _rel(v, g, *vg64(torch.tensor(t, dtype=torch.float64)))
        assert value < 3e-5 and grad < 1e-3, (t, value, grad)


class _ExactQR(sparse._CholQR3):
    """The float32 matrix's QR from float64 Householder, rounded once: the
    QR a float32 route can at best return; the VJP the route's own."""

    @staticmethod
    def forward(A):
        Q, R = _positive(*torch.linalg.qr(A.double()))
        return Q.to(A.dtype), R.to(A.dtype), torch.ones((), dtype=torch.bool)


@pytest.mark.parametrize("kind", KINDS)
def test_strategies_in_float32_match_an_exact_qr(kind, monkeypatch):
    """Each strategy's float32 value and gradient against the same float32
    model whose QR is exact (`_ExactQR`), over the box and at the fits' end:
    3e-5 and 1e-3, what the route itself adds (read: at most 1.1e-5 and
    6.8e-4, FSA's gradient at the fits' end, where the library's float32
    Householder reads 3.0e-3). There, against float64, the float32 model
    reads up to 3.5e-5 in the value and 4.7e-3 in the gradient whichever
    QR it takes (the exact one 2.4e-5 and 4.7e-3): the whitening and the
    sums before and after the QR round in float32."""
    vg = _model(kind, torch.float32).make_objective()[0]
    points = [torch.tensor(t, dtype=torch.float32) for t in BOX + OPTIMUM]
    got = [vg(t) for t in points]
    monkeypatch.setattr(sparse._CholQR3, "apply", _ExactQR.apply)
    for t, (v, g) in zip(points, got):
        value, grad = _rel(v, g, *vg(t))
        assert value < 3e-5 and grad < 1e-3, (t.tolist(), value, grad)


def _fitc(dtype, n=200, m=8):
    return _model("FITC", dtype, n, m)


@pytest.mark.parametrize("kind", ["SoR", "DTC", "FITC"])
def test_the_samplers_vmap_the_float32_route(kind):
    """`gp.mcmc` vmaps a model's target and its gradient over chains
    (`inference/hmc.batched_value_and_grad`): on a float32 model that runs
    `_CholQR3` under `torch.func.vmap`. Three chains' values and gradients
    match a loop over the chains (1e-6 relative: the same float32 work, in
    batched products; read at most 1.5e-7), and two HMC iterations of two
    chains run to finite draws. (FSA's target vmaps its blocks inside, which
    the gram op's one chain dimension does not take under a second vmap,
    with either QR.)"""
    from gaussianprocesses_jl_tpu_torch.inference.hmc import batched_value_and_grad

    model = _model(kind, torch.float32, n=200, m=8)
    logprob, x0, _, _ = model.make_logprob()
    g = torch.Generator().manual_seed(5)
    thetas = x0 + 0.3 * torch.randn((3, x0.shape[0]), generator=g, dtype=x0.dtype)
    sparse.QR_ROUTES.clear()
    values, grads = batched_value_and_grad(logprob)(thetas)
    assert set(k[0] for k in sparse.QR_ROUTES) == {"cholqr3"}
    for theta, v, gr in zip(thetas, values, grads):
        want_g, want_v = torch.func.grad_and_value(logprob)(theta)
        value, grad = _rel(v, gr, want_v, want_g)
        assert value < 1e-6 and grad < 1e-6, (value, grad)
    res = gp.mcmc(model, n_iter=2, chains=2, verbose=False)
    assert res.samples.shape[:2] == (2, 2) and bool(torch.isfinite(res.samples).all())


def test_the_route_vmaps_over_padded_stacks():
    """`_qr` under `torch.func.vmap` over three stacked matrices with zero
    rows at their ends, as FSA pads its blocks: Q, R, ok and the gradient
    of a function of Q and R match each matrix's own (1e-6 relative; read
    0)."""
    A = torch.stack([_tall(10.0 ** (2 + k), rows=300, cols=12, seed=k) for k in range(3)])
    A[0, 250:] = 0.0
    A[2, 280:] = 0.0
    dQ, dR = _cotangents(300, 12, torch.float32)

    def loss(a):
        Q, R, ok = sparse._qr(a)
        return (Q * dQ).sum() + (R * dR).sum(), (Q, R, ok)

    grads, (Q, R, ok) = torch.func.vmap(torch.func.grad(loss, has_aux=True))(A)
    assert bool(ok.all())
    for k in range(3):
        want_g, (want_Q, want_R, _) = torch.func.grad(loss, has_aux=True)(A[k])
        for got, want in ((Q[k], want_Q), (R[k], want_R), (grads[k], want_g)):
            gap = float(torch.linalg.matrix_norm(got - want) / torch.linalg.matrix_norm(want))
            assert gap < 1e-6, (k, gap)


def test_routes_by_dtype():
    """A float32 objective counts "cholqr3", a float64 one "householder",
    each as many as `QR_SHAPES` counts forwards."""
    for dtype, route in ((torch.float32, "cholqr3"), (torch.float64, "householder")):
        vg, x0, _, _ = _fitc(dtype).make_objective()
        sparse.QR_SHAPES.clear()
        sparse.QR_ROUTES.clear()
        vg(x0)
        vg(x0)
        assert dict(sparse.QR_ROUTES) == {(route, 208, 8): 2}
        assert sparse.QR_SHAPES[("qr", 208, 8)] == 2


def test_replays_add_the_routes_the_capture_counted(emulated):  # noqa: F811
    """Through the graph layer: each call counts one route, the warm-up's
    and the capture's taken back; optimize(method='optax') counts one an
    evaluation, as many as `QR_SHAPES` counts forwards."""
    model = _fitc(torch.float32)
    vg, x0, _, _ = model.make_objective()
    sparse.QR_ROUTES.clear()
    for _ in range(3):
        vg(x0)
    assert dict(sparse.QR_ROUTES) == {("cholqr3", 208, 8): 3}
    sparse.QR_ROUTES.clear()
    sparse.QR_SHAPES.clear()
    res = model.optimize(method="optax", maxiter=3)
    evaluations = int(res.message.split()[0])
    assert evaluations >= 3 * (1 + lbfgs.TRIAL_BLOCK)
    assert dict(sparse.QR_ROUTES) == {("cholqr3", 208, 8): evaluations}
    assert sparse.QR_SHAPES[("qr", 208, 8)] == evaluations
    assert any(c is sparse.QR_ROUTES for c in graphs._COUNTERS)


def test_markers_bracket_the_float32_route(monkeypatch):
    """In float32 the three Cholesky factors of the route run between the
    forward's markers, and the VJP's markers follow in the backward."""
    calls = []
    chol = sparse._chol_inv_t

    def recording(G):
        calls.append("chol")
        return chol(G)

    monkeypatch.setattr(profiling, "mark", lambda tag, end, like: calls.append((tag, end)))
    monkeypatch.setattr(sparse, "_chol_inv_t", recording)
    vg, x0, _, _ = _fitc(torch.float32).make_objective()
    vg(x0)
    assert calls == [("gp.qr.fwd", False), "chol", "chol", "chol", ("gp.qr.fwd", True),
                     ("gp.qr.vjp", False), ("gp.qr.vjp", True)]
