"""The port's sparse models (models/sparse.py: SoR, DTC, FITC, FSA) against
the JAX package on the same numpy inputs made from a seed, in f64.

The JAX model's inducing points and padded partition reach the port through
`convert.load_sparse`. Tolerances, stated at each assertion: mll rtol 1e-10
and its gradient rtol 1e-8 (atol 1e-9), since both take a Householder QR of
the same stacked matrix through different LAPACK builds; the factorized
algebra against the densified matrix at 1e-9 of its scale; predictions atol
1e-9. The golden mll pins of the sparse notebook test hold at 1e-3, N =
1000, on the port alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu_torch.convert import load_sparse
from gaussianprocesses_jl_tpu_torch.models.gpe import gpe_factorize
from gaussianprocesses_jl_tpu_torch.perf.anchors import SPARSE_GOLDEN, sparse_golden

N, M = 120, 8
# ragged, out of order, so the padded layout and its masks are exercised
BLOCKS = [list(range(0, 37)), list(range(80, 120)), list(range(37, 80))]
KINDS = ["SoR", "DTC", "FITC", "FSA"]


def _data():
    rng = np.random.RandomState(1)
    x = 2 * np.pi * rng.rand(N)
    y = np.sin(x) + 0.3 * rng.randn(N)
    return x, y, np.linspace(0, 2 * np.pi, M)


def _jax_model(kind, mean=None):
    x, y, ind = _data()
    kw = dict(kernel=gj.SE(0.3, 0.1), lognoise=-0.6,
              mean=mean if mean is not None else gj.MeanZero())
    if kind == "FSA":
        return gj.FSA(x, ind, BLOCKS, y, **kw)
    return getattr(gj, kind)(x, ind, y, **kw)


def _pair(kind, mean="zero"):
    """The same sparse model in both packages: the port's built from the JAX
    model's strategy by load_sparse."""
    x, y, _ = _data()
    means = {"zero": (gj.MeanZero(), gt.MeanZero()),
             "const": (gj.MeanConst(beta=np.array(0.2)), gt.MeanConst(beta=0.2))}[mean]
    mj = _jax_model(kind, means[0])
    mt = gt.GPE(x, y, means[1], gt.SE(0.3, 0.1), lognoise=-0.6, device="cpu")
    cs = mj.covstrat
    blocks = (cs.block_idx, cs.block_mask) if kind == "FSA" else (None, None)
    load_sparse(mt, type(cs).__name__, np.asarray(cs.inducing), *blocks)
    return mj, mt


@pytest.mark.parametrize("kind", KINDS)
def test_mll_and_gradient_match_jax(kind):
    mj, mt = _pair(kind, "const")
    tj, gj_ = mj.target_and_dtarget()
    tt, gt_ = mt.target_and_dtarget()
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-10)
    np.testing.assert_allclose(gt_.numpy(), np.asarray(gj_), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(mt.mll), float(mj.mll), rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_factorized_algebra_against_the_densified_matrix(kind):
    """solve, logdet, quad and trace of LowRankPD against numpy on pd.dense()
    (the FSA partition is ragged): 1e-9 of each quantity's scale. dense()
    itself equals Qff + Lambda built entry by entry."""
    _, mt = _pair(kind)
    pd = gpe_factorize(mt.params, mt.x, mt.covstrat)
    S = pd.dense().numpy()
    np.testing.assert_allclose(S, S.T, atol=1e-12)
    kern = mt.kernel
    Kuf = kern.gram(mt.covstrat.inducing, mt.x).numpy()
    Kuu = kern.gram(mt.covstrat.inducing).numpy()
    Luu = pd.Luu.numpy()
    Qff = Kuf.T @ np.linalg.solve(Luu @ Luu.T, Kuf)
    s2 = float(np.exp(-1.2))
    Kff = kern.gram(mt.x).numpy()
    if kind in ("SoR", "DTC"):
        ref = Qff + s2 * np.eye(N)
    elif kind == "FITC":
        ref = Qff + np.diag(np.diag(Kff - Qff) + s2)
    else:
        ref = Qff + s2 * np.eye(N)
        for b in BLOCKS:
            ref[np.ix_(b, b)] += Kff[np.ix_(b, b)] - Qff[np.ix_(b, b)]
    assert np.abs(Luu @ Luu.T - Kuu).max() < 1e-8
    np.testing.assert_allclose(S, ref, atol=1e-9 * np.abs(ref).max())
    sign, ld = np.linalg.slogdet(S)
    assert sign > 0
    np.testing.assert_allclose(float(pd.logdet()), ld, rtol=1e-9)
    B = np.random.RandomState(0).randn(N, 3)
    X_np = np.linalg.solve(S, B)
    np.testing.assert_allclose(pd.solve(torch.as_tensor(B)).numpy(), X_np,
                               atol=1e-9 * np.abs(X_np).max())
    np.testing.assert_allclose(pd.solve(torch.as_tensor(B[:, 0])).numpy(), X_np[:, 0],
                               atol=1e-9 * np.abs(X_np).max())
    np.testing.assert_allclose(float(pd.quad(torch.as_tensor(B[:, 1]))), B[:, 1] @ X_np[:, 1],
                               rtol=1e-9)
    np.testing.assert_allclose(float(pd.trace()), np.trace(S), rtol=1e-9)
    assert bool(pd.ok)


@pytest.mark.parametrize("kind", KINDS)
def test_predictions_match_jax(kind):
    """predict_f (variance and full covariance) and predict_y at 9 points
    beyond the data's ends: atol 1e-9."""
    mj, mt = _pair(kind, "const")
    xs = np.linspace(-0.5, 2 * np.pi + 0.5, 9)
    for full_cov in (False, True):
        muj, cj = mj.predict_f(jnp.asarray(xs), full_cov=full_cov)
        mut, ct = mt.predict_f(xs, full_cov=full_cov)
        np.testing.assert_allclose(mut.numpy(), np.asarray(muj), atol=1e-9)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-9)
    np.testing.assert_allclose(mt.predict_y(xs)[1].numpy(),
                               np.asarray(mj.predict_y(jnp.asarray(xs))[1]), atol=1e-9)


def test_fsa_blockindpred_matches_jax_and_changes_the_prediction():
    """FSA's cross-block correction with ragged assignments, an empty block
    and an unassigned test point: atol 1e-9 against the JAX package, and it
    moves the mean away from the unblocked prediction."""
    mj, mt = _pair("FSA")
    xs = np.linspace(-0.5, 2 * np.pi + 0.5, 9)
    bip = [[0, 3, 7], [], [1, 5]]
    for full_cov in (False, True):
        muj, cj = mj.predict_f(jnp.asarray(xs), full_cov=full_cov, blockindpred=bip)
        mut, ct = mt.predict_f(xs, full_cov=full_cov, blockindpred=bip)
        np.testing.assert_allclose(mut.numpy(), np.asarray(muj), atol=1e-9)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-9)
    mu0, _ = mt.predict_f(xs)
    assert np.abs(mu0.numpy() - mut.numpy()).max() > 1e-6


def test_partition_and_blockindpred_validation():
    x = np.random.RandomState(0).randn(12, 1)
    y = np.random.RandomState(1).randn(12)
    with pytest.raises(ValueError, match="partition"):
        gt.FSA(x, x[:3], [[0, 1, 2]], y, kernel=gt.SE(0.0, 0.0), device="cpu")
    blocks = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    m = gt.FSA(x, x[:4], blocks, y, kernel=gt.SE(0.0, 0.0), device="cpu")
    xs = np.linspace(-1, 1, 5)[:, None]
    with pytest.raises(ValueError, match="one entry per training block"):
        m.predict_f(xs, blockindpred=[[0], [1]])
    with pytest.raises(ValueError, match="twice"):
        m.predict_f(xs, blockindpred=[[0], [0], [1]])
    with pytest.raises(ValueError, match="out of range"):
        m.predict_f(xs, blockindpred=[[0], [5], [1]])
    with pytest.raises(ValueError, match="assigns no test points"):
        m.predict_f(xs, blockindpred=[[], [], []])
    me = gt.GPE(x, y, kernel=gt.SE(0.0, 0.0), device="cpu")
    with pytest.raises(TypeError, match="FSA"):
        me.predict_f(xs, blockindpred=[[0], [1], [2]])
    with pytest.raises(ValueError, match="partition"):
        load_sparse(me, "FullScaleApproxStrat", x[:3], [[0, 1], [2, 2]], [[1.0, 1.0], [1.0, 0.0]])
    with pytest.raises(ValueError, match="no blocks"):
        load_sparse(me, "FullyIndepStrat", x[:3], [[0]], [[1.0]])
    with pytest.raises(ValueError, match="unknown sparse strategy"):
        load_sparse(me, "FITC", x[:3])
    with pytest.raises(TypeError, match="whitened-latent"):
        gt.GPA(x, y, None, gt.SE(0.0, 0.0), gt.BernLik(),
               covstrat=gt.FullyIndepStrat(inducing=torch.as_tensor(x[:3])), device="cpu")


def test_constructors_default_to_the_card_and_take_the_data_dtype():
    x, y, ind = _data()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gt.FITC(x, ind, y)
    m = gt.SoR(x.astype(np.float32), ind, y, device="cpu")
    assert m.covstrat.inducing.dtype == torch.float32 and m.covstrat.inducing.shape == (M, 1)


# the notebook test's golden mlls (N = 1000, 12 inducing points, lognoise
# -0.3; perf/anchors.py, which the card runs too) and the sparse test's
# (lognoise -0.6), f64
GOLDEN = {
    -0.3: SPARSE_GOLDEN,
    -0.6: {"exact": -492.5982769852, "SoR": -492.5982425163, "DTC": -492.5982425163,
           "FITC": -492.5983466590, "FSA": -492.5983604624},
}


@pytest.mark.parametrize("lognoise,noise_sd", [(-0.3, 0.5), (-0.6, 0.3)])
def test_sparse_mll_golden_pins(lognoise, noise_sd):
    """abs 1e-3 from the golden values; SoR and DTC equal (abs 1e-9)."""
    rng = np.random.RandomState(1)
    n = 1000
    x = 2 * np.pi * rng.rand(n)
    y = np.sin(x) + noise_sd * rng.randn(n)
    ind = np.linspace(0, 2 * np.pi, 12)
    blocks = [list(range(i, min(i + 100, n))) for i in range(0, n, 100)]
    kw = dict(kernel=gt.SE(0.3, 0.1), lognoise=lognoise, device="cpu")
    golden = GOLDEN[lognoise]
    mlls = {"exact": float(gt.GPE(x, y, **kw).mll),
            "SoR": float(gt.SoR(x, ind, y, **kw).mll),
            "DTC": float(gt.DTC(x, ind, y, **kw).mll),
            "FITC": float(gt.FITC(x, ind, y, **kw).mll),
            "FSA": float(gt.FSA(x, ind, blocks, y, **kw).mll)}
    for name, v in mlls.items():
        assert v == pytest.approx(golden[name], abs=1e-3), name
        assert abs(v - mlls["exact"]) < 10.0
    assert mlls["SoR"] == pytest.approx(mlls["DTC"], abs=1e-9)
    if lognoise == -0.3:
        assert sparse_golden("cpu") == {"mll": mlls, "within": True}


def test_sparse_optimize_raises_the_target():
    _, mt = _pair("FITC")
    t0 = float(mt.target)
    mt.optimize(maxiter=25)
    assert float(mt.target) >= t0
