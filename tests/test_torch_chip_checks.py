"""chip_smoke.py's checks of the gram kernels at the path's own inputs, run
on the CPU with the launchers stood in for by counting plain versions (the
kernels themselves run only on the card): `captured_launches` keeps the
last launch of each family, dtype and shape and gives the launchers back;
`check_captured` replays them against the plain version in f64 and fails
on a launcher that is off by more than phase 3's tolerances; the shared
`launches` helper counts from 0, by shape too."""
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op  # noqa: E402
from gaussianprocesses_jl_tpu_torch.perf import gram_study  # noqa: E402


def _stand_ins(monkeypatch, off=0.0):
    """Launchers that count as the real ones do and compute the plain
    versions, the forward `off` from it."""
    def gram(family, p, X1, X2=None, grid=0):
        gram_op.LAUNCHES["gram"] += 1
        gram_op.LAUNCH_SHAPES["gram", X1.shape[-2], (X1 if X2 is None else X2).shape[-2],
                              X2 is not None] += 1
        return gram_op.gram_plain(family, p, X1, X2) + off

    def vjp(family, p, X1, X2, G, needs=(True, True, True), grid=0):
        gram_op.LAUNCHES["gram_vjp"] += 1
        gram_op.LAUNCH_SHAPES["gram_vjp", X1.shape[-2], (X1 if X2 is None else X2).shape[-2],
                              X2 is not None] += 1
        return gram_op.gram_vjp_plain(family, p, X1, X2, G, needs)

    monkeypatch.setattr(gram_op, "launch_gram", gram)
    monkeypatch.setattr(gram_op, "launch_gram_vjp", vjp)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return gram, vjp


def _operands(dtype):
    rng = np.random.RandomState(0)
    X1 = torch.as_tensor(rng.randn(70, 1) * 5.0, dtype=dtype)  # |x|^2 up to ~600
    X2 = torch.as_tensor(rng.randn(33, 1) * 5.0, dtype=dtype)
    p = torch.tensor([0.1, np.log(0.5), 0.0], dtype=dtype)
    G = torch.as_tensor(rng.randn(70, 33), dtype=dtype)
    return p, X1, X2, G


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_captured_launches_replay_against_the_plain_version(monkeypatch, dtype):
    gram, vjp = _stand_ins(monkeypatch)
    p, X1, X2, G = _operands(dtype)

    def path():
        for i in range(3):  # the same shapes again: the last kept
            q = p + i
            gram_op.launch_gram(gram_op.MAT32, q, X1)
            gram_op.launch_gram(gram_op.MAT32, q, X1, X2)
            gram_op.launch_gram_vjp(gram_op.MAT32, q, X1, X2, G, (True, True, False))

    with cs.captured_launches() as seen:
        _, n = gram_study.launches(path)
    assert n == (6, 3)
    assert dict(gram_op.LAUNCH_SHAPES) == {("gram", 70, 70, False): 3, ("gram", 70, 33, True): 3,
                                            ("gram_vjp", 70, 33, True): 3}
    assert gram_study.by_shape() == {"gram 70x70": 3, "gram cross 70x33": 3,
                                     "gram_vjp cross 70x33": 3}
    assert gram_op.launch_gram is gram and gram_op.launch_gram_vjp is vjp
    assert len(seen) == 3
    assert all(torch.equal(args[1], p + 2) for args in seen.values())
    errs = cs.check_captured("test", seen)
    assert errs["gram"] <= (1e-5 if dtype == torch.float32 else 1e-12) * np.exp(2 * 2.1)
    _, n = gram_study.launches(lambda: None)
    assert n == (0, 0) and not gram_op.LAUNCH_SHAPES


def test_check_captured_fails_on_a_kernel_off_its_tolerance(monkeypatch):
    """A forward 1e-4 off (f32) passes phase 3's atol 1e-5 sigma^2: the
    replay fails."""
    p, X1, X2, _ = _operands(torch.float32)
    _stand_ins(monkeypatch)
    with cs.captured_launches() as seen:
        gram_op.launch_gram(gram_op.MAT32, p, X1, X2)
    _stand_ins(monkeypatch, off=1e-4)
    with pytest.raises(RuntimeError, match="disagrees with its plain version"):
        cs.check_captured("test", seen)


def test_check_vjp_takes_underflow_as_zero_and_holds_the_rest():
    """An f32 output of 0 where the f64 reference is ~1e-38 (every term
    below f32's range: a chain far out in its length scale and variance)
    passes; a gap of 1e-4 of the scale on ordinary values fails, in f32
    and in f64."""
    tiny = torch.tensor([[0.0, 3.98e-38, 0.0]], dtype=torch.float64)
    _, ratio = cs.check_vjp((torch.zeros((1, 3)),), (tiny,), (torch.zeros((1, 3),
                                                                           dtype=torch.float64),),
                            1e-5)
    assert ratio <= 1.0
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        ref = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
        scale = torch.full((3,), 10.0, dtype=torch.float64)
        got = (ref + 10 * tol * 10).to(dtype)
        _, ratio = cs.check_vjp((got,), (ref,), (scale,), tol)
        assert ratio > 1.0
