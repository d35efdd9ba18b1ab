"""The notebook anchors through the port's examples on the CPU (their `run`
functions; perf/anchors.py holds the thresholds), at a few sampler
iterations: shapes and finite results. The anchors' thresholds
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
from gaussianprocesses_jl_tpu_torch.examples import (mauna_loa, poisson_regression, regression,
                                                     robust_regression)
from gaussianprocesses_jl_tpu_torch.perf import anchors


def test_robust_regression_runs():
    out = robust_regression.run("cpu", n_iter=10, verbose=False)
    assert out["finite"] and np.isfinite(out["rmse_g"]) and np.isfinite(out["rmse_t"])
    # the GPE half is deterministic: L-BFGS-B from the example's start
    # reaches the notebook's golden rmse 0.323 (abs 5e-3)
    assert out["rmse_g"] == pytest.approx(0.323, abs=5e-3)


def test_poisson_mcmc_and_vi_run():
    out = poisson_regression.run("cpu", n_iter=10, vi_iters=20, verbose=False)
    assert out["finite"] and np.isfinite(out["elbo"])
    assert -1.0 <= out["corr_mcmc"] <= 1.0 and -1.0 <= out["corr_vi"] <= 1.0


def test_regression_quickstart_runs():
    out = regression.run("cpu", n_iter=10, verbose=False)
    assert out["finite"] and len(out["hmc_mean"]) == 3 and len(out["ess_mean"]) == 3


def test_mauna_loa_optimum_matches_jax_and_f32_cannot_start():
    year, co2 = mauna_loa.load_data()
    assert year.shape == (598,)
    train = year < 2004
    ymean = co2[train].mean()
    mj = gj.GPE(year[train], co2[train] - ymean, gj.MeanZero(), mauna_loa.kernel(gj),
                lognoise=-2.0)
    mj.optimize(maxiter=200)
    out = mauna_loa.run("cpu", maxiter=200, verbose=False)
    assert out["mll"] == pytest.approx(float(mj.mll), abs=1e-2)
    assert out["rmse"] < anchors.MAUNA_LOA_RMSE
    # why the card runs this anchor in f64: at the start the noise variance
    # is e^-4 against the SE(4, 4) term's e^8, below f32's resolution, and
    # the f32 gram does not factor: the mll is -inf and the forecast, which
    # would belong to K = I, raises
    m32, train, _ = mauna_loa.model("cpu", np.float32)
    assert float(m32.mll) == -np.inf
    with pytest.raises(ValueError, match="not positive definite"):
        m32.predict_y(year[~train].astype(np.float32))
