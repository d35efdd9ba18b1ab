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


# The JAX package's public names whose counterparts are not of the same
# name in the module of the same path, with where they are or why none is.
ELSEWHERE = {
    # the gram kernel's module: the port's kernel sits under Kernel.gram
    "ops.pallas_gram": ("ops.gram", {"stationary_gram_pallas": "gram"}),
}
NO_COUNTERPART = {
    # the port takes every stationary gram on the card through its kernel:
    # no size gate to ask for or to tune
    ("ops.pallas_gram", "pallas_gram_supported"), ("ops.pallas_gram", "PALLAS_GRAM_MIN_N"),
    # jax.sharding's own types, re-exported
    ("parallel.mesh", "NamedSharding"), ("parallel.mesh", "P"),
    # read by nothing of the port: a step timer's best-of statistic hides
    # stalls (the benchmark times whole windows), and the benchmark reads
    # the allocator's peak itself
    ("utils.profiling", "StepTimer"), ("utils.profiling", "live_device_bytes"),
}


def _modules():
    import importlib
    import pkgutil

    import gaussianprocesses_jl_tpu as jp

    for info in pkgutil.walk_packages(jp.__path__, "gaussianprocesses_jl_tpu."):
        mod = importlib.import_module(info.name)
        if hasattr(mod, "__all__"):
            yield info.name.split(".", 1)[1], mod


def _methods(cls):
    return {k for k, v in vars(cls).items() if callable(v) and not k.startswith("_")}


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """Each name in the `__all__` of each module of the JAX package is in
    the port's module of the same path (or where ELSEWHERE says), but for
    NO_COUNTERPART; each public method of a class of the package's own
    there, and of the sparse models' Lambda classes, is a method of the
    port's class."""
    import importlib

    from gaussianprocesses_jl_tpu.models import sparse as j_sparse
    from gaussianprocesses_jl_tpu_torch.models import sparse as t_sparse

    missing = []
    for path, jmod in _modules():
        tpath, renamed = ELSEWHERE.get(path, (path, {}))
        tmod = importlib.import_module(f"gaussianprocesses_jl_tpu_torch.{tpath}")
        for name in jmod.__all__:
            if (path, name) in NO_COUNTERPART:
                continue
            tname = renamed.get(name, name)
            if not hasattr(tmod, tname):
                missing.append(f"{path}.{name}")
                continue
            jv, tv = getattr(jmod, name), getattr(tmod, tname)
            # a class of the package's own (not one of JAX's, re-exported)
            if isinstance(jv, type) and jv.__module__.startswith("gaussianprocesses_jl_tpu"):
                missing += [f"{path}.{name}.{m}" for m in _methods(jv) if not hasattr(tv, m)]
    for cls in ("_DiagLambda", "_BlockDiagLambda"):
        jc, tc = getattr(j_sparse, cls), getattr(t_sparse, cls)
        missing += [f"models.sparse.{cls}.{m}" for m in _methods(jc) if not hasattr(tc, m)]
    assert not missing, missing


def test_the_names_nothing_calls_match_jax():
    """Mean.grad_stack, _DiagLambda.solve and matvec, _BlockDiagLambda.solve
    and modules.asarray_fields on the same numpy inputs as the JAX
    package's, f64, rtol 1e-12."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    import gaussianprocesses_jl_tpu as gj
    from gaussianprocesses_jl_tpu.models import sparse as j_sparse
    from gaussianprocesses_jl_tpu.utils import modules as j_modules
    from gaussianprocesses_jl_tpu_torch.models import sparse as t_sparse
    from gaussianprocesses_jl_tpu_torch.utils import modules as t_modules

    def close(got, ref):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-12, atol=1e-14)

    rng = np.random.RandomState(12)
    X = rng.randn(9, 2)
    for make in (lambda g: g.MeanLin(np.array([0.5, -0.3])),
                 lambda g: g.MeanPoly(np.array([[0.2, 0.1], [0.3, -0.4]])),
                 lambda g: g.MeanConst(beta=0.7) + g.MeanLin(np.array([1.0, 2.0])),
                 lambda g: g.MeanConst(beta=0.7) * g.MeanLin(np.array([1.0, 2.0]))):
        close(make(gp).grad_stack(torch.as_tensor(X)), make(gj).grad_stack(jnp.asarray(X)))

    d = rng.uniform(0.5, 2.0, 9)
    B = rng.randn(9, 3)
    jd, td = j_sparse._DiagLambda(d=jnp.asarray(d)), t_sparse._DiagLambda(d=torch.as_tensor(d))
    for b in (B, B[:, 0]):
        close(td.solve(torch.as_tensor(b)), jd.solve(jnp.asarray(b)))
        close(td.matvec(torch.as_tensor(b)), jd.matvec(jnp.asarray(b)))

    blocks = [[0, 3, 5, 8], [1, 2], [4, 6, 7]]
    bmax = 4
    idx = tuple(tuple(b) + (0,) * (bmax - len(b)) for b in blocks)
    mask = tuple((1.0,) * len(b) + (0.0,) * (bmax - len(b)) for b in blocks)
    chols = np.tile(np.eye(bmax), (3, 1, 1))
    for k, b in enumerate(blocks):
        A = rng.randn(len(b), len(b))
        chols[k, :len(b), :len(b)] = np.linalg.cholesky(A @ A.T + len(b) * np.eye(len(b)))
    jb = j_sparse._BlockDiagLambda(chols=jnp.asarray(chols), ok=jnp.asarray(True),
                                   block_idx=idx, block_mask=mask)
    tb = t_sparse._BlockDiagLambda(chols=torch.as_tensor(chols), ok=torch.tensor(True),
                                   block_idx=torch.as_tensor(idx),
                                   block_mask=torch.as_tensor(mask, dtype=torch.float64), n=9)
    for b in (B, B[:, 0]):
        close(tb.solve(torch.as_tensor(b)), jb.solve(jnp.asarray(b)))

    kw = dict(a=1, b=[0.5, 2.0], c=np.arange(3))
    jf, tf = j_modules.asarray_fields(**kw), t_modules.asarray_fields(**kw)
    assert list(tf) == list(jf)
    for k in kw:
        assert tf[k].dtype == torch.float64 and tf[k].shape == jf[k].shape
        close(tf[k], jf[k])
