"""Configuration #4's FITC (`models/sparse.py`) against the benchmark's plain
reference (`gpbench/reference/fitc_se_n100k.py`) on the CPU, at n = 2 000,
m = 32, d = 4, with the configuration's own data draw; the reference's
Woodbury route against the dense Gaussian likelihood of Qff + Lambda; the
QR's device markers in their order, and the QR counter, eager and through
the graph layer's replays (capture emulated as in test_torch_graphs.py)."""
import copy
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.inference import lbfgs
from gaussianprocesses_jl_tpu_torch.models import sparse
from gaussianprocesses_jl_tpu_torch.ops.linalg import default_jitter
from gaussianprocesses_jl_tpu_torch.utils import graphs, profiling
from gpbench.configs import fitc_se_n100k as conf
from gpbench.reference import fitc_se_n100k as ref
from gpbench.reference.gp import se_iso_gram

from test_torch_graphs import emulated  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "gpbench" / "configs" / "fitc_se_n100k.json").read_text())
N, M = 2000, 32
# the benchmark's start box [-1, 1]^3 ([log noise, log l, log sigma]) and its corners
BOX = [(-1.0, 0.0, 0.0), (0.25, -0.5, 0.75), (0.9, 0.9, -0.9), (-1.0, -1.0, 1.0),
       (1.0, 1.0, 1.0), (-1.0, 1.0, -1.0)]
# where the fits end: noise variance 0.01 and l = 2.7, at which Qff's diagonal is
# within ~1e-4 of Kff's, so Lambda's residual diag(Kff - Qff) is a difference of
# nearly equal numbers that two routes round apart
OPTIMUM = [(-2.3, 1.05, 0.0)]


def _cfg(dtype, m=M):
    """The configuration at m inducing rows, its constants those the port
    applies in `dtype` (float64: a jitter of 1e-10 and a floor of 1e-10)."""
    cfg = copy.deepcopy(CFG)
    cfg["m"] = m
    if dtype == torch.float64:
        cfg["constants"].update(kuu_jitter_rel=1e-10, lambda_floor=default_jitter(dtype))
    return cfg


def _pair(dtype, n=N, m=M):
    """(the port's vg, the reference's f64 vg) on the configuration's draw."""
    cfg = _cfg(dtype, m)
    X, y, rows = conf.draw(cfg, n)
    Xt, yt = torch.from_numpy(X).to(dtype), torch.from_numpy(y).to(dtype)
    model = gp.FITC(Xt, Xt[torch.from_numpy(rows)], yt, kernel=gp.SE(0.0, 0.0), lognoise=0.0,
                    device="cpu")
    vgr = ref.objective(cfg, torch.from_numpy(X).double(), torch.from_numpy(y).double(), "f64")
    return model.make_objective()[0], vgr


def _gaps(vg, vgr, theta, dtype):
    t = torch.tensor(theta, dtype=dtype)
    v, g = vg(t)
    vr, gr = vgr(t.double())
    return (abs(float(v) - float(vr)) / abs(float(vr)),
            float(torch.linalg.vector_norm(g.double() - gr) / torch.linalg.vector_norm(gr)))


def test_the_draw_is_the_bench_s():
    """X, y and the inducing rows as bench.py's bench_fitc100k draws them."""
    cfg = copy.deepcopy(CFG)
    X, y, rows = conf.draw(cfg, 3000)
    rng = np.random.RandomState(0)
    Xb = rng.randn(3000, 4).astype(np.float32)
    yb = (np.sin(Xb[:, 0]) + 0.5 * np.cos(Xb[:, 1]) + 0.1 * rng.randn(3000)).astype(np.float32)
    np.testing.assert_array_equal(X, Xb)
    np.testing.assert_array_equal(y, yb)
    np.testing.assert_array_equal(rows, rng.choice(3000, 512, replace=False))
    np.testing.assert_array_equal(conf.inducing_rows(cfg, 3000), rows)


def test_constants_are_the_port_s():
    """The configuration states the jitter and the floor the port applies in float32."""
    assert CFG["precision"] == "float32" and CFG["tf32"] is False
    assert CFG["constants"]["lambda_floor"] == default_jitter(torch.float32)
    Xu = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    kern = gp.SE(0.5, 0.3).to(dtype=torch.float32, device="cpu")
    Kuu, Luu, _, _ = sparse._common_pieces(kern, Xu, Xu)
    jitter = CFG["constants"]["kuu_jitter_rel"] * max(1.0, float(Kuu.diagonal().max()))
    torch.testing.assert_close(Luu @ Luu.T, Kuu + jitter * torch.eye(8), rtol=0, atol=1e-5)


@pytest.mark.parametrize("theta", BOX + OPTIMUM)
def test_port_matches_the_reference_in_f64(theta):
    """float64: the QR route against the Woodbury route, to 1e-9 in the
    start box (1e-15 to 1e-12 read where l <= 1, 1.1e-10 at l = e, sigma =
    1/e, where Lambda's residual starts to cancel); at the fits' end, where
    it cancels most, to 1e-8 in the value and 1e-7 in the gradient (1.1e-9
    and 2.9e-8 read)."""
    vg, vgr = _pair(torch.float64)
    value, grad = _gaps(vg, vgr, theta, torch.float64)
    tol = (1e-9, 1e-9) if theta in BOX else (1e-8, 1e-7)
    assert value < tol[0] and grad < tol[1], (value, grad)


def test_port_matches_the_reference_in_f32():
    """float32 against the float64 reference with the float32 constants:
    the value to 3e-5, the gradient to 1e-3. float32 rounds each of the n =
    2 000 terms of the likelihood's sums (~sqrt(n) 6e-8 = 3e-6 of the value)
    and Lambda's residual at the fits' end; the largest read here are 8.3e-6
    (value, at (-1, 1, -1)) and 1.4e-4 (gradient, at the fits' end)."""
    vg, vgr = _pair(torch.float32)
    for theta in BOX + OPTIMUM:
        value, grad = _gaps(vg, vgr, theta, torch.float32)
        assert value < 3e-5 and grad < 1e-3, (theta, value, grad)


@pytest.mark.parametrize("theta", [(-1.0, 0.0, 0.0), (0.5, 0.7, -0.3), (-2.3, 1.05, 0.0)])
def test_woodbury_matches_the_dense_likelihood(theta):
    """The reference's value and gradient against the dense n x n Gaussian
    negative log likelihood of Qff + Lambda, at n = 300, m = 16."""
    n, m = 300, 16
    cfg = _cfg(torch.float64, m)
    X, y, rows = conf.draw(cfg, n)
    X, y = torch.from_numpy(X).double(), torch.from_numpy(y).double()
    Xu, consts = X[torch.from_numpy(rows)], cfg["constants"]

    def dense(t):
        Kuu = se_iso_gram(Xu, Xu, t[1], t[2], "f64")
        Kuu = Kuu + consts["kuu_jitter_rel"] * torch.clamp_min(Kuu.diagonal().max(), 1.0) * (
            torch.eye(m, dtype=torch.float64))
        Kuf = se_iso_gram(Xu, X, t[1], t[2], "f64")
        Q = Kuf.T @ torch.linalg.solve(Kuu, Kuf)
        lam = torch.exp(2 * t[0]) + torch.clamp_min(torch.exp(2 * t[2]) - Q.diagonal(), 0.0)
        S = Q + torch.diag(torch.clamp_min(lam, consts["lambda_floor"]))
        L = torch.linalg.cholesky(S)
        w = torch.linalg.solve_triangular(L, y[:, None], upper=False)
        return 0.5 * (torch.sum(w * w) + 2 * torch.sum(torch.log(L.diagonal()))
                      + n * math.log(2 * math.pi))

    t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    want = dense(t)
    (gwant,) = torch.autograd.grad(want, t)
    value, grad = ref.objective(cfg, X, y, "f64")(t.detach())
    torch.testing.assert_close(value, want.detach(), rtol=1e-9, atol=0)
    torch.testing.assert_close(grad, gwant, rtol=1e-7, atol=1e-9)


def test_marks_follow_the_kernels_of_marker_cu():
    """`profiling.MARKS` in the order of csrc/marker.cu's kernels, each a
    begin then an end."""
    src = (ROOT / "gaussianprocesses_jl_tpu_torch" / "csrc" / "marker.cu").read_text()
    body = re.search(r"#define GP_MARKS\(X\)(.*?)\n\n", src, re.S).group(1)
    kernels = re.findall(r"X\((\w+)\)", body)
    assert kernels == [profiling.mark_kernel(tag, end) for tag in profiling.MARKS
                       for end in (False, True)]
    assert profiling.mark_kernel("gp.qr.fwd", False) == "gp_qr_fwd_begin"


def _model(n=200, m=8, dtype=torch.float64):
    cfg = _cfg(dtype, m)
    X, y, rows = conf.draw(cfg, n)
    Xt, yt = torch.from_numpy(X).to(dtype), torch.from_numpy(y).to(dtype)
    return gp.FITC(Xt, Xt[torch.from_numpy(rows)], yt, kernel=gp.SE(0.0, 0.0), lognoise=-1.0,
                   device="cpu")


def test_markers_bracket_the_qr_and_its_vjp(monkeypatch):
    """One value and gradient launches the forward's begin and end around
    the QR, then, in the backward, the VJP's begin and end around the QR's
    backward; a CPU tensor launches nothing."""
    calls = []
    qr = torch.linalg.qr

    def recording_qr(A, mode="reduced"):
        calls.append("qr")
        return qr(A, mode=mode)

    monkeypatch.setattr(profiling, "mark", lambda tag, end, like: calls.append((tag, end)))
    monkeypatch.setattr(torch.linalg, "qr", recording_qr)
    vg, x0, _, _ = _model().make_objective()
    vg(x0)
    assert calls == [("gp.qr.fwd", False), "qr", ("gp.qr.fwd", True), ("gp.qr.vjp", False),
                     ("gp.qr.vjp", True)]


def test_qr_counter_counts_each_evaluation_eagerly():
    model = _model()
    sparse.QR_SHAPES.clear()
    vg, x0, _, _ = model.make_objective()
    vg(x0)
    assert dict(sparse.QR_SHAPES) == {("qr", 208, 8): 1, ("qr_vjp", 208, 8): 1}
    float(model.mll)  # a value alone: no VJP
    assert dict(sparse.QR_SHAPES) == {("qr", 208, 8): 2, ("qr_vjp", 208, 8): 1}


def test_replays_add_what_the_capture_counted(emulated):  # noqa: F811
    """Through the graph layer: each call of the objective counts one QR
    and one VJP, the warm-up's and the capture's taken back; an
    optimize(method='optax') counts one of each an evaluation."""
    model = _model()
    vg, x0, _, _ = model.make_objective()
    sparse.QR_SHAPES.clear()
    for _ in range(3):
        vg(x0)
    assert dict(sparse.QR_SHAPES) == {("qr", 208, 8): 3, ("qr_vjp", 208, 8): 3}
    sparse.QR_SHAPES.clear()
    res = model.optimize(method="optax", maxiter=3)
    evaluations = int(res.message.split()[0])
    assert evaluations >= 3 * (1 + lbfgs.TRIAL_BLOCK)
    assert dict(sparse.QR_SHAPES) == {("qr", 208, 8): evaluations,
                                      ("qr_vjp", 208, 8): evaluations}
    assert any(c is sparse.QR_SHAPES for c in graphs._COUNTERS)
