"""The port's `bench.py` tables (perf/bench_study.py) on the CPU, f64: the
ten compositions of the BASELINE kernel table, built by the port and by
`bench.py::kernels` on the same `RandomState(42)` data at n = 60, hold the
JAX package's `gpe_mll` and its gradient (value rtol 1e-10, gradient rtol
1e-8 with atol 1e-10 of max|g|), and evaluate their stationary leaves once
each (the plain versions counted, forward and backward); then each part
runs end to end at a small size.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import gaussianprocesses_jl_tpu as gj
from gaussianprocesses_jl_tpu.models.covariance import FullCovariance as JFull
from gaussianprocesses_jl_tpu.models.gpe import GPEParams as JParams
from gaussianprocesses_jl_tpu.models.gpe import gpe_mll as j_gpe_mll
from gaussianprocesses_jl_tpu.utils.params import wrap_param
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.perf import bench_study as bs

N = 60


def _data():
    return bs.bench_data(N, np.random.RandomState(bs.SEED))


@pytest.fixture
def counted(monkeypatch):
    """Calls of the gram's plain versions, forward and backward."""
    calls = {"gram": 0, "gram_vjp": 0}
    for name, fn in (("gram", gram_op.gram_plain), ("gram_vjp", gram_op.gram_vjp_plain)):
        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(gram_op, f"{name}_plain", wrapped)
    return calls


def test_the_compositions_are_the_benchs():
    assert list(bs.compositions()) == list(bench.kernels(gj, jnp)) == list(bs.LEAVES)


@pytest.mark.parametrize("name", list(bs.LEAVES))
def test_composition_mll_and_gradient_match_jax(name, counted):
    X, y = _data()
    got = bs.mll_and_grad(bs.bench_params(bs.compositions()[name], torch.float64, "cpu"),
                          torch.as_tensor(X), torch.as_tensor(y))
    assert (counted["gram"], counted["gram_vjp"]) == (bs.LEAVES[name],) * 2
    params = JParams(lognoise=wrap_param(-1.0), mean=gj.MeanZero(),
                     kernel=bench.kernels(gj, jnp)[name])
    vj, gj_ = jax.value_and_grad(
        lambda v: j_gpe_mll(params.with_flat_params(v), jnp.asarray(X), jnp.asarray(y),
                            JFull())[0])(params.flat_params())
    gj_ = np.asarray(gj_)
    np.testing.assert_allclose(float(got[0]), float(vj), rtol=1e-10)
    np.testing.assert_allclose(got[1].numpy(), gj_, rtol=1e-8,
                               atol=1e-10 * np.abs(gj_).max())


def test_gaps_and_the_bar():
    got = (torch.tensor(-100.05, dtype=torch.float64), torch.tensor([1.0, -2.0]))
    ref = (torch.tensor(-100.0, dtype=torch.float64), torch.tensor([1.0, -2.1]))
    gap = bs.gaps(got, ref)
    assert gap == pytest.approx((5e-4, 0.1 / 2.1))


def test_micro_and_table_rows_on_the_cpu(capsys):
    rows = bs.micro("cpu", sizes=(40,), reps=1)
    assert [r["name"] for r in rows] == list(bs.LEAVES)
    assert all(r["value_gap"] <= bs.HEADLINE_BAR[0] and r["grad_gap"] <= bs.HEADLINE_BAR[1]
               and r["gram_launches"] is None for r in rows)
    rows = bs.table16k("cpu", n=80, reps=1)
    assert all(r["ok"] and r["verdict"] == "within the bar of f64" for r in rows)


def test_cholesky_rows_on_the_cpu(monkeypatch):
    monkeypatch.setattr(bs, "CHOL_BLOCKS", (128, 200))
    monkeypatch.setattr(bs, "GEMM_M", 256)
    rows = bs.cholesky("cpu", n=600, reps=1)
    names = [r["name"] for r in rows]
    assert names == ["cholesky_ex", "blocked_cholesky(block=128)",
                     "blocked_cholesky(block=200)", "gemm_anchor", "nominal_f32_peak"]
    for r in rows[:3]:
        assert r["max_rel_err_vs_f64"] <= bs.CHOL_TOL
        assert r["frac_gemm_anchor"] == pytest.approx(r["tflops"] / rows[3]["tflops"])


def test_chains_row_on_the_cpu(monkeypatch):
    # the bench's 400 outer iterations cut to 4 (1 warm-up) for the CPU
    monkeypatch.setattr(bs.gpa_study, "run",
                        functools.partial(bs.gpa_study.run, n_iter=4, warmup=1))
    row = bs.chains("cpu", 16)
    assert row["chains"] == 16 and row["iters"] == 4 and row["draws_finite"]
    assert np.isfinite(row["ess_per_sec_median"]) and np.isfinite(row["rhat_max"])
