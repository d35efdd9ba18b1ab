"""The notebook anchors through the port on the CPU (perf/anchors.py), at a
few sampler iterations: shapes and finite results. The anchors' thresholds
are checked on the card by chip_smoke.py at the examples' depths.

Mauna Loa is held against the JAX package on the same synthetic series: the
L-BFGS-B optimum of both packages from the same start (maxiter 200, f64),
mll within abs 1e-2 (the two runs took 72 and 75 iterations and ended
3.7e-4 apart; the JAX notebook test allows 2.0 for path wobble), and the
forecast's rmse under the anchor's 3.5 ppm.
"""
import numpy as np
import pytest

import gaussianprocesses_jl_tpu as gj
from gaussianprocesses_jl_tpu_torch.perf import anchors


def test_robust_regression_runs():
    out = anchors.robust_regression("cpu", n_iter=10)
    assert out["finite"] and np.isfinite(out["rmse_g"]) and np.isfinite(out["rmse_t"])
    # the GPE half is deterministic: L-BFGS-B from the example's start
    # reaches the notebook's golden rmse 0.323 (abs 5e-3)
    assert out["rmse_g"] == pytest.approx(0.323, abs=5e-3)


def test_poisson_mcmc_and_vi_run():
    out = anchors.poisson("cpu", n_iter=10, vi_iters=20)
    assert out["finite"] and np.isfinite(out["elbo"])
    assert -1.0 <= out["corr_mcmc"] <= 1.0 and -1.0 <= out["corr_vi"] <= 1.0


def test_regression_quickstart_runs():
    out = anchors.regression("cpu", n_iter=10)
    assert out["finite"] and len(out["hmc_mean"]) == 3 and len(out["ess_mean"]) == 3


def test_mauna_loa_optimum_matches_jax_and_f32_cannot_start():
    year, co2 = anchors.mauna_loa_data()
    assert year.shape == (598,)
    train = year < 2004
    ymean = co2[train].mean()
    mj = gj.GPE(year[train], co2[train] - ymean, gj.MeanZero(), anchors.mauna_loa_kernel(gj),
                lognoise=-2.0)
    mj.optimize(maxiter=200)
    out = anchors.mauna_loa("cpu", maxiter=200)
    assert out["mll"] == pytest.approx(float(mj.mll), abs=1e-2)
    assert out["rmse"] < anchors.MAUNA_LOA_RMSE
    # why the card runs this anchor in f64: at the start the noise variance
    # is e^-4 against the SE(4, 4) term's e^8, below f32's resolution, and
    # the f32 gram does not factor
    f32 = anchors.mauna_loa("cpu", maxiter=1, dtype=np.float32)
    assert f32["mll0"] == -np.inf
