"""The port's precision study (perf/chol_precision_study.py) on the CPU:
its blocked driver with the full-f32 product hook is `ops/linalg.py`'s
`blocked_cholesky` to the bit, the hi/lo split keeps TF32's mantissa and
its product holds f64's to f32's rounding, the TF32 switch restores the
flag, and the study's rows run at n = 1024 (the TF32 rows are the card's:
on the CPU they are listed as not measured)."""
import numpy as np
import pytest
import torch

from gaussianprocesses_jl_tpu_torch.ops.linalg import blocked_cholesky
from gaussianprocesses_jl_tpu_torch.perf import chol_precision_study as cps


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,block", [(512, 128), (600, 128)])
def test_blocked_driver_is_blocked_cholesky(n, block, dtype):
    K0, _ = cps.gp_gram(n)
    K = torch.as_tensor(K0 + 1e-2 * np.eye(n), dtype=dtype)
    L = cps.blocked_cholesky_with(K, cps.mm_f32, block)
    assert torch.equal(L, blocked_cholesky(K, block=block)[0])


def test_hi_lo_split_and_its_product():
    rng = np.random.RandomState(2)
    A64, B64 = rng.randn(200, 300), rng.randn(300, 100)
    A, B = torch.as_tensor(A64, dtype=torch.float32), torch.as_tensor(B64, dtype=torch.float32)
    hi = cps.tf32_round(A)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)  # 10 mantissa bits kept
    assert float(((A - hi).abs() / A.abs()).max()) <= 2.0**-11
    ref = A.double().numpy() @ B.double().numpy()
    err = np.abs(cps.mm_3xtf32(A, B).double().numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-6  # f32's rounding, not TF32's 2^-11
    assert cps.product_error(cps.mm_f32, "cpu", n=128) <= 1e-6


def test_tf32_switch_restores_the_flag():
    assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(RuntimeError):
        with cps.tf32(True):
            assert torch.backends.cuda.matmul.allow_tf32
            raise RuntimeError
    assert not torch.backends.cuda.matmul.allow_tf32


def test_study_rows_on_the_cpu():
    out = cps.run("cpu", n=1024, block=256, noises=(1e-1, 1e-3))
    assert out["not_measured"] == ["blocked_tf32", "blocked_3xtf32"]
    assert out["tf32_after"] is False
    for key in ("nugget_0.1", "nugget_0.001"):
        rows = out[key]
        for name in ("cholesky_ex", "single_launch_cholesky", "blocked_f32"):
            assert rows[name]["finite"] and rows[name]["max_dL"] < 1e-3
            assert rows[name]["quad_rel_err"] < 1e-3
