"""The port's Cholesky study (ops/cholesky_kernels.py, perf/cholesky_study.py)
against the JAX study `perf/pallas_cholesky_study.py`.

The study's Pallas kernels run in interpret mode on the CPU; the port's CPU
path is each kernel's plain version. The CUDA kernels run only on the card,
where chip_smoke.py holds them against these plain versions. Inputs are made
with numpy from a seed and handed to both.

`single_launch_cholesky` in the study divides an int32 program id by a
Python int, which fails under this suite's x64 mode; it runs under
`jax.enable_x64(False)`, as on the TPU.
"""
import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gaussianprocesses_jl_tpu_torch.ops import cholesky_kernels as ck
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.perf import cholesky_study as cs

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "pallas_cholesky_study", ROOT / "perf" / "pallas_cholesky_study.py")
study = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(study)


def _spd(n, rank=64, seed=0):
    """The study's test matrix W W^T + n I, f32."""
    W = np.random.RandomState(seed).randn(n, rank).astype(np.float32)
    return W @ W.T + n * np.eye(n, dtype=np.float32)


def _close(got, ref, rel):
    """max|got - ref| <= rel * max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


# f32 factorizations of the same well-conditioned matrix by two summation
# orders: each is within ~5e-7 of f64 at these sizes, so 1e-5 of max|.|
@pytest.mark.parametrize("B", [256, 512])
def test_chol_inv_panel_matches_pallas(B):
    A = _spd(B, seed=B)
    L_pl, Linv_pl = study.chol_inv_panel(jnp.asarray(A), T=128)
    L, Linv = ck.chol_inv_panel(torch.from_numpy(A), T=128)
    assert L.dtype == torch.float32 and L.shape == (B, B)
    _close(L, L_pl, 1e-5)
    _close(Linv, Linv_pl, 1e-5)
    assert not torch.triu(L, 1).any() and not torch.triu(Linv, 1).any()


def test_single_launch_cholesky_matches_pallas():
    K = _spd(512, seed=3)
    with jax.enable_x64(False):
        L_pl = np.asarray(study.single_launch_cholesky(jnp.asarray(K), B=128, R=256))
    Kt = torch.from_numpy(K)
    L = ck.single_launch_cholesky(Kt, B=128, R=256)
    _close(L, L_pl, 1e-5)
    assert not torch.triu(L, 1).any()  # exact zeros above the diagonal
    assert torch.equal(Kt, torch.from_numpy(K))  # the caller's K untouched
    # and the study's own check against an f64 factorization
    _close(L, np.linalg.cholesky(K.astype(np.float64)), 1e-4)


def test_cholesky_blocked_panels_matches_pallas():
    K = _spd(512, seed=4)
    L_pl = study.cholesky_blocked_pallas(jnp.asarray(K), block=256)
    L = cs.cholesky_blocked_panels(torch.from_numpy(K), block=256)
    _close(L, L_pl, 1e-5)
    assert not torch.triu(L, 1).any()


def test_se_gram_study_matches_pallas():
    """Tolerance 1e-5 e^p0: the Pallas kernel clamps the expansion
    s1 + s2 - 2 x.x', which rounds r2 to a few ulp of |x|^2; the port's
    diagonal is exactly e^p0."""
    X = np.random.RandomState(0).randn(300, 10).astype(np.float32)
    params = cs.study_params("cpu")
    assert params.dtype == torch.float32
    np.testing.assert_allclose(params.numpy(), [2 * 0.2, math.exp(-2 * 0.3)], rtol=1e-7)
    K_pl = np.asarray(study.pallas_se_gram(jnp.asarray(X), jnp.asarray(params.numpy())))
    K = cs.se_gram_study(torch.from_numpy(X), params)
    assert K.dtype == torch.float32 and K.shape == (300, 300)
    p0 = float(params[0])
    np.testing.assert_allclose(K.numpy(), K_pl, rtol=0, atol=1e-5 * math.exp(p0))
    assert torch.equal(K.diagonal(), torch.exp(params[:1]).expand(300))
    with pytest.raises(ValueError, match="params"):
        cs.se_gram_study(torch.from_numpy(X), params[:1])


def _pallas_probe(n_iter):
    """The study's `study_launch_overhead` pallas_call, as written there."""

    def kern(n_iter, a_ref, o_ref):
        acc = jax.lax.fori_loop(0, n_iter, lambda j, x: x + 1.0, jnp.float32(0.0))
        o_ref[:] = a_ref[0:8, 0:128] + acc

    return pl.pallas_call(
        functools.partial(kern, n_iter),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )


@pytest.mark.parametrize("n_iter", [512, 4096])
def test_launch_probe_matches_pallas(n_iter):
    A = np.random.RandomState(n_iter).randn(512, 512).astype(np.float32)
    o_pl = np.asarray(_pallas_probe(n_iter)(jnp.asarray(A)))
    o = ck.launch_probe(torch.from_numpy(A), n_iter)
    assert o.shape == (8, 128) and o.dtype == torch.float32
    np.testing.assert_array_equal(o.numpy(), o_pl)  # the same f32 add


def test_indefinite_panel_gives_nan_in_both():
    A = _spd(256, seed=5)
    A[200, 200] = -1e4  # pivot 200 goes negative
    L_pl, Linv_pl = (np.asarray(t) for t in study.chol_inv_panel(jnp.asarray(A)))
    L, Linv = ck.chol_inv_panel(torch.from_numpy(A))
    for port, ref in ((L.numpy(), L_pl), (Linv.numpy(), Linv_pl)):
        assert np.isnan(ref).any() and np.isnan(port).any()
        # the micro-panel before the bad pivot is finite and agrees
        assert not np.isnan(port[:128, :128]).any()
        _close(port[:128, :128], ref[:128, :128], 1e-5)
    assert not np.isnan(L.numpy()[:, :128]).any()


@pytest.mark.parametrize("call", [
    lambda: ck.chol_inv_panel(torch.eye(200), T=128),  # B % T != 0
    lambda: ck.chol_inv_panel(torch.zeros(4, 5)),  # not square
    lambda: ck.single_launch_cholesky(torch.eye(384), B=256, R=384),  # n % B != 0
    lambda: ck.single_launch_cholesky(torch.eye(1024), B=256, R=768),  # n % R != 0
    lambda: ck.single_launch_cholesky(torch.eye(768), B=256, R=384),  # R % B != 0
    lambda: ck.single_launch_cholesky(torch.eye(512), B=64, R=256),  # B % 128 != 0
    lambda: ck.launch_probe(torch.ones(8, 64), 512),  # narrower than 8 x 128
    lambda: ck.launch_probe(torch.ones(8, 128), -1),
    lambda: cs.cholesky_blocked_panels(torch.eye(640), block=256),  # n % block != 0
], ids=["panel-B%T", "panel-shape", "single-n%B", "single-n%R", "single-R%B",
        "single-B%128", "probe-shape", "probe-n_iter", "blocked-n%block"])
def test_wrappers_raise_where_the_study_truncated(call):
    with pytest.raises(ValueError):
        call()


def test_kernel_entries_raise_off_the_cpu_without_cuda():
    """A tensor neither on the CPU nor on CUDA has no kernel; the CUDA-only
    entries (the gram launch, the study's command line) refuse a CPU run."""
    meta = torch.empty((256, 256), device="meta")
    for call in (lambda: ck.chol_inv_panel(meta),
                 lambda: ck.single_launch_cholesky(meta, B=128, R=256),
                 lambda: ck.launch_probe(meta, 8)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
    X = torch.zeros((16, 10))
    p = torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        gram_op.launch_gram(gram_op.SE, p, X)
    if not torch.cuda.is_available():
        assert cs.main(["launch"]) == 1
    assert ck.LAUNCHES == {"launch_probe": 0, "chol_inv_panel": 0,
                           "single_launch_cholesky": 0}


def test_study_experiments_run_on_the_cpu_at_small_size(capsys):
    """Each study experiment end to end on CPU tensors (plain versions, host
    clock), at sizes cut to fit a unit test."""
    probe = cs.study_launch_overhead("cpu", n_iters=(8,), reps=1)
    assert probe[8][0] > 0 and probe[8][1] is None
    gram = cs.study_gram("cpu", ns=(64,), reps=1)
    assert gram[64][1] is None and gram[64][3] <= 1e-5
    panel = cs.study_panel("cpu", Bs=(128,), gram_B=128, reps=1)
    assert all(v[3] < 1e-5 and v[4] < 1e-4 for v in panel.values())
    single = cs.study_single_launch("cpu", n=1024, n_check=512, reps=1)
    assert single["rel_err"] < 1e-4
    full = cs.study_full("cpu", n=1024, reps=1)
    assert len(full) == 4 and all(v > 0 for v in full.values())
    assert "TFLOP/s" in capsys.readouterr().out
