"""The port's top-level namespace covers the JAX package's: the
reference's export list and the JAX package's additions, as
tests/test_api_surface.py lists them."""
import gaussianprocesses_jl_tpu_torch as gp

REFERENCE_SURFACE = [
    "GP", "GPE", "GPA", "ElasticGPE", "Approx",
    "Kernel", "Likelihood", "SumKernel", "ProdKernel", "Masked",
    "FixedKernel", "fix", "free",
    "Noise", "Const", "SE", "SEIso", "SEArd", "Periodic", "Poly",
    "RQ", "RQIso", "RQArd", "Lin", "LinIso", "LinArd",
    "Matern", "Mat12Iso", "Mat12Ard", "Mat32Iso", "Mat32Ard",
    "Mat52Iso", "Mat52Ard",
    "MeanZero", "MeanConst", "MeanLin", "MeanPoly", "SumMean", "ProdMean",
    "MeanPeriodic",
    "GaussLik", "BernLik", "ExpLik", "StuTLik", "PoisLik", "BinLik",
    "mcmc", "ess", "optimize", "vi", "elbo", "noise_variance",
]

ADDITIONS = [
    "SoR", "DTC", "FITC", "FSA",
    "predict_LOO", "logp_LOO", "dlogp_LOO",
    "predict_CVfold", "logp_CVfold", "dlogp_CVfold",
    "effective_sample_size", "split_rhat", "split_hmc",
    "save_checkpoint", "load_checkpoint",
    "plot_gp", "plot_gp_2d", "GPRegressor",
    "vi_predict_f", "vi_predict_y", "Param", "Module", "priors",
    "make_mesh", "DistributedFullCovariance", "ring_gram",
    "sharded_vi", "sharded_elbo", "sharded_vi_train",
]


def test_reference_export_surface():
    missing = [n for n in REFERENCE_SURFACE if not hasattr(gp, n)]
    assert not missing, f"missing reference exports: {missing}"


def test_package_additions():
    missing = [n for n in ADDITIONS if not hasattr(gp, n)]
    assert not missing, f"missing package exports: {missing}"


def test_parallel_exports_what_is_ported():
    from gaussianprocesses_jl_tpu_torch import parallel

    for name in parallel.__all__:
        assert hasattr(parallel, name), name
    assert {"make_mesh", "make_pod_mesh", "initialize_distributed", "sharded_hmc",
            "sharded_split_hmc", "sharded_ess"} <= set(parallel.__all__)
    # everything the JAX package's parallel/__init__.py exports
    assert {"build_tiles", "choose_tile_size", "distributed_cholesky", "distributed_chol_solve",
            "distributed_mll", "distributed_quad_logdet", "distributed_solve_lower",
            "distributed_solve_upper", "distributed_unwhiten", "tile_and_shard", "untile",
            "DistributedFullCovariance", "DistributedPD", "ring_gram"} <= set(parallel.__all__)


def test_model_methods():
    for meth in ["set_params", "predict_f", "predict_y", "optimize", "rand"]:
        assert hasattr(gp.GPE, meth), meth
        assert hasattr(gp.ElasticGPE, meth), meth
    for meth in ["set_params", "predict_f", "predict_y"]:
        assert hasattr(gp.GPA, meth), meth
    assert hasattr(gp.ElasticGPE, "append")
    assert hasattr(gp.PoisLik, "var_exp")
    assert hasattr(gp.PoisLik, "dv_var_exp")
