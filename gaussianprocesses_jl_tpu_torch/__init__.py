"""gaussianprocesses_jl_tpu_torch: the Gaussian-process library on PyTorch
and an NVIDIA H100.

The port of `gaussianprocesses_jl_tpu` (JAX on a TPU), held against it by
the tests. This slice carries the exact-GP path: kernels and means with the
flat-parameter protocol, the GPE log target and its gradient, prediction and
the L-BFGS-B optimizer. Stationary grams run on a hand-written CUDA kernel
(`csrc/gram.cu`). Models run on the CUDA device unless built with
`device="cpu"`. The Cholesky study (`perf/cholesky_study.py`) drives the
panel, single-launch and launch-probe kernels of `csrc/cholesky.cu`; the
package's own factorization does not route through them.

    import gaussianprocesses_jl_tpu_torch as gp
    k = gp.SE(0.0, 0.0) + gp.RQ(0.0, 0.0, 0.0)
    m = gp.GPE(x, y, gp.MeanZero(), k, lognoise=-1.0)
    m.optimize()
    mu, var = m.predict_y(xtest)
"""

from .ops.kernels import (
    SE,
    RQ,
    Lin,
    Matern,
    SEIso,
    SEArd,
    Mat12Iso,
    Mat32Iso,
    Mat52Iso,
    Mat12Ard,
    Mat32Ard,
    Mat52Ard,
    RQIso,
    RQArd,
    Periodic,
    LinIso,
    LinArd,
    Poly,
    Noise,
    Const,
    SumKernel,
    ProdKernel,
    Masked,
    FixedKernel,
    Kernel,
    fix,
    free,
)
from .ops.means import (
    Mean,
    MeanZero,
    MeanConst,
    MeanLin,
    MeanPoly,
    MeanPeriodic,
    SumMean,
    ProdMean,
)
from .models.covariance import FullCovariance
from .models.gpe import GPE, GP, GPEParams, noise_variance
from .inference.optimize import optimize
from .utils import priors
from .utils.params import Param
from .utils.modules import Module
from .convert import load_flat

__version__ = "0.1.0"
