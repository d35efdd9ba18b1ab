"""The port's examples (gaussianprocesses_jl_tpu_torch/examples/) on the
CPU, each `main` at a cut depth, against the JAX package on the same data,
f64. The samplers draw from torch generators where the JAX examples draw
from keys, so only the deterministic parts are compared: the ML fits (the
same scipy L-BFGS-B on values equal to rounding: rtol 1e-6, as the GPE
tests hold `optimize`), the starting mlls and targets (rtol 1e-9), the
sparse mlls and forecasts (rtol 1e-9, atol 1e-8); the sampled parts must
be finite."""
import jax.numpy as jnp
import numpy as np
import pytest

import gaussianprocesses_jl_tpu as gj
from gaussianprocesses_jl_tpu.utils.priors import Normal as JNormal
from gaussianprocesses_jl_tpu_torch.examples import (classification, distributed, mauna_loa,
                                                     poisson_regression, regression,
                                                     robust_regression, sparse_approximations)

CPU = ["--device", "cpu"]


def test_regression(capsys):
    out = regression.main(CPU + ["--n-iter", "10"])
    x, y = regression.data()
    mj = gj.GPE(x, y, gj.MeanZero(), gj.SE(0.0, 0.0), lognoise=-1.0)
    mj.optimize()
    np.testing.assert_allclose(out["mll"], float(mj.mll), rtol=1e-6)
    np.testing.assert_allclose(out["params"], np.asarray(mj.get_params()), rtol=1e-6, atol=1e-9)
    assert np.isfinite(out["hmc_mean"]).all() and np.isfinite(out["ess_mean"]).all()
    assert "HMC posterior mean params" in capsys.readouterr().out


def test_classification():
    out = classification.main(CPU + ["--n-iter", "20"])
    assert 0.0 <= out["accuracy"] <= 1.0 and out["draws"] > 0
    X, y = classification.data()
    mj = gj.GPA(X, y, gj.MeanZero(), gj.Matern(1.5, jnp.zeros(5), 0.0), gj.BernLik())
    mj.set_priors(kern=[JNormal(0.0, 2.0)] * 6)
    np.testing.assert_allclose(float(classification.model("cpu").target), float(mj.target),
                               rtol=1e-9)


def test_robust_regression():
    out = robust_regression.main(CPU + ["--n-iter", "10"])
    x, f, y = robust_regression.data()
    gpe = gj.GPE(x, y, kernel=gj.SE(0.0, 0.0), lognoise=-1.0)
    gpe.optimize(maxiter=100)
    mu, _ = gpe.predict_f(x)
    np.testing.assert_allclose(out["rmse_g"], robust_regression.rmse(mu, f), rtol=1e-6)
    assert np.isfinite(out["rmse_t"])


def test_sparse_approximations():
    out = sparse_approximations.main(CPU + ["--n", "300"])
    x, y, ind, blocks = sparse_approximations.data(300)
    kw = dict(kernel=gj.SE(0.3, 0.1), lognoise=-0.3)
    models = {"exact": gj.GPE(x, y, **kw), "SoR": gj.SoR(x, ind, y, **kw),
              "DTC": gj.DTC(x, ind, y, **kw), "FITC": gj.FITC(x, ind, y, **kw),
              "FSA": gj.FSA(x, ind, blocks, y, **kw)}
    xs = np.linspace(0, 2 * np.pi, 100)
    for name, mj in models.items():
        np.testing.assert_allclose(out[name]["mll"], float(mj.mll), rtol=1e-9)
        if name != "exact":
            mu, _ = mj.predict_f(xs)
            rmse = float(np.sqrt(np.mean((np.asarray(mu) - np.sin(xs)) ** 2)))
            np.testing.assert_allclose(out[name]["rmse"], rmse, rtol=1e-9, atol=1e-8)


def test_mauna_loa():
    out = mauna_loa.main(CPU + ["--maxiter", "3"])
    year, co2 = mauna_loa.load_data()
    train = year < 2004
    ymean = co2[train].mean()
    mj = gj.GPE(year[train], co2[train] - ymean, gj.MeanZero(), mauna_loa.kernel(gj),
                lognoise=-2.0)
    np.testing.assert_allclose(float(mauna_loa.model("cpu")[0].mll), float(mj.mll), rtol=1e-9)
    mj.optimize(maxiter=3)
    mu, _ = mj.predict_y(year[~train])
    ref = float(np.sqrt(np.mean((np.asarray(mu) + ymean - co2[~train]) ** 2)))
    np.testing.assert_allclose(out["rmse"], ref, rtol=1e-6)


def test_poisson_regression():
    out = poisson_regression.main(CPU + ["--n-iter", "10", "--vi-iters", "20"])
    assert -1.0 <= out["corr_mcmc"] <= 1.0 and -1.0 <= out["corr_vi"] <= 1.0
    m, X, y = poisson_regression.model("cpu")
    mj = gj.GPA(X, y, gj.MeanZero(), gj.Matern(1.5, 0.0, 0.0), gj.PoisLik())
    np.testing.assert_allclose(float(m.target), float(mj.target), rtol=1e-9)


def test_distributed_on_one_process(capsys):
    out = distributed.main(CPU + ["--depth", "0.05"])
    assert "[chains x j] skipped (needs >= 2 devices)" in capsys.readouterr().out
    assert out["chains_x_j"] is None and out["chains"]["finite"] and out["split"]["finite"]
    X, y, _ = distributed.dense_data(1)
    dense = gj.GPE(X, y, kernel=gj.SE(0.0, 0.0), lognoise=-1.0)
    np.testing.assert_allclose(out["dense"]["mll0"], float(dense.mll), rtol=1e-9)
    X, y, Xu = distributed.fitc_data(1)
    fitc = gj.FITC(X, Xu, y, kernel=gj.SE(0.0, 0.0), lognoise=-0.5)
    np.testing.assert_allclose(out["fitc"]["mll"], float(fitc.mll), rtol=1e-9)
    rng = np.random.RandomState(5)
    Xg = rng.randn(16, 2)
    yg = (np.sin(Xg[:, 0]) + 0.3 * rng.randn(16) > 0).astype(float)
    gpa = gj.GPA(Xg, yg, gj.MeanZero(), gj.Matern(1.5, 0.0, 0.0), gj.BernLik())
    np.testing.assert_allclose(out["gpa"]["target"], float(gpa.target), rtol=1e-9)
