"""gaussianprocesses_jl_tpu_torch: the Gaussian-process library on PyTorch
and an NVIDIA H100.

The port of `gaussianprocesses_jl_tpu` (JAX on a TPU), held against it by
the tests. It carries the exact-GP path (kernels and means with the
flat-parameter protocol, the GPE log target and its gradient, prediction,
the L-BFGS-B and on-device L-BFGS optimizers), the sparse SoR, DTC, FITC
and FSA models, analytic cross-validation, GPA classification (the
likelihoods, the whitened-latent GPA model, the HMC, split-HMC and
elliptical-slice samplers over a batch of chains, the multi-chain ESS and
R-hat), mean-field variational inference, the elastic GP that grows by
appends, the scikit-learn style `GPRegressor`, the plotting helpers,
checkpoints, and process meshes on `torch.distributed` with the
chain-sharded samplers, the distributed dense Cholesky
(`DistributedFullCovariance`), the ring gram, the observation-sharded FITC
and the sharded VI of `parallel/`. Stationary grams
run on hand-written CUDA kernels (`csrc/gram.cu`), one launch for every
chain of a batch. Models run on the CUDA device unless built with
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
from .ops.likelihoods import (
    Likelihood,
    GaussLik,
    BernLik,
    PoisLik,
    StuTLik,
    ExpLik,
    BinLik,
)
from .models.covariance import FullCovariance
from .models.gpe import GPE, GP, GPEParams, noise_variance
from .models.gpa import GPA, GPAParams
from .models.elastic import ElasticGPE
from .models.sparse import (
    SubsetOfRegsStrategy,
    DeterminTrainCondStrat,
    FullyIndepStrat,
    FullScaleApproxStrat,
    SoR,
    DTC,
    FITC,
    FSA,
)
from .inference.mcmc import mcmc, ess
from .inference.split import split_hmc, SplitHMCResult
from .inference.optimize import optimize
from .inference.vi import vi, elbo, Approx, vi_predict_f, vi_predict_y
from .inference.crossvalidation import (
    predict_LOO,
    logp_LOO,
    dlogp_LOO,
    predict_CVfold,
    logp_CVfold,
    dlogp_CVfold,
)
from .inference.diagnostics import effective_sample_size, split_rhat
from .utils import priors
from .utils.checkpoint import save_checkpoint, load_checkpoint
from .utils.params import Param
from .utils.modules import Module
from .plot import plot_gp, plot_gp_2d
from .sklearn import GPRegressor
from .parallel.mesh import make_mesh
from .parallel.dense import DistributedFullCovariance
from .parallel.gram import ring_gram
from .parallel.vi import sharded_vi, sharded_elbo, sharded_vi_train
from .convert import load_approx, load_chains, load_flat, load_sparse

__version__ = "0.1.0"
