"""The notebook anchors of the JAX package's `tests/test_notebook_parity.py`
for the port's examples (`gaussianprocesses_jl_tpu_torch/examples/`, whose
`run` functions drive each anchor's model on the examples' synthetic data,
as they make it when the notebooks' CSVs are absent).

The thresholds are the parity tests' and are checked by `chip_smoke.py` on
the card against the examples' numbers; the tests run the same `run`
functions on the CPU at a few iterations. `sparse_golden` evaluates the
sparse example's models against the notebook test's golden mlls.
"""
from __future__ import annotations

import numpy as np

from gaussianprocesses_jl_tpu_torch.examples import sparse_approximations as sa

__all__ = ["sparse_golden", "ROBUST_RMSE_T", "POISSON_CORR", "POISSON_GAP", "MAUNA_LOA_RMSE",
           "SPARSE_GOLDEN"]

# examples/robust_regression.py: rmse_t < rmse_g and rmse_t < 0.15
ROBUST_RMSE_T = 0.15
# examples/poisson_regression.py: both correlations > 0.5, |c_m - c_v| < 0.15
POISSON_CORR, POISSON_GAP = 0.5, 0.15
# examples/mauna_loa.py: the 2004+ forecast's rmse < 3.5 ppm
MAUNA_LOA_RMSE = 3.5
# the sparse notebook test's golden mlls (N = 1000, 12 inducing points,
# lognoise -0.3, f64), held at abs 1e-3
SPARSE_GOLDEN = {"exact": -871.2615224318861, "SoR": -871.2615035337278,
                 "DTC": -871.2615035337278, "FITC": -871.2615489920295,
                 "FSA": -871.2615636292248}


def sparse_golden(device, dtype=np.float64) -> dict:
    """The exact GP and SoR, DTC, FITC and FSA (10 blocks of 100) at N = 1000
    on the notebook test's data: each mll, and whether all stand within
    1e-3 of SPARSE_GOLDEN."""
    mlls = {k: float(m.mll) for k, m in sa.models(device, dtype).items()}
    return {"mll": mlls,
            "within": all(abs(v - SPARSE_GOLDEN[k]) <= 1e-3 for k, v in mlls.items())}
