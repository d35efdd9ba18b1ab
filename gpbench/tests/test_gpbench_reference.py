"""The plain reference computes what the program computes: in float64 on
the CPU, the package's targets, gradients, L-BFGS iterates and
split-HMC transitions agree with the reference's to rounding; the frozen
ESS and R-hat equal the package's. The TF32 rounding rounds as TF32 does."""
import json

import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu_torch as gp
import gaussianprocesses_jl_tpu_torch.models.gpa as gpa_mod
from gaussianprocesses_jl_tpu_torch.inference import diagnostics as port_diag
from gaussianprocesses_jl_tpu_torch.inference.split import split_hmc
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal
from gpbench import harness, port
from gpbench.reference import diagnostics, lbfgs, precision, split_hmc as ref_split


def _cfg(name):
    with open(harness.ROOT / "configs" / f"{name}.json") as f:
        return json.load(f)


def _data(name, n, seed=3):
    cfg = _cfg(name)
    X, y = harness._module("configs", name).make_data(cfg, n, torch.Generator().manual_seed(seed))
    return cfg, X.double(), y.double()


def _gpa(cfg, X, y, monkeypatch):
    # the configuration's nugget, which the package takes in float32, in float64 too
    monkeypatch.setattr(gpa_mod, "GPA_NUGGET", cfg["nugget"])
    m = gp.GPA(X, y, gp.MeanZero(), gp.Matern(1.5, np.zeros(cfg["d"]), 0.0), gp.BernLik(),
               device="cpu")
    return m.set_priors(kern=[Normal(*cfg["kernel_prior"])] * (cfg["d"] + 1))


def test_gpe_objective_and_lbfgs():
    cfg, X, y = _data("gpe_se_d10", 120)
    ref = harness._module("reference", "gpe_se_d10")
    vg = ref.objective(cfg, X, y, "f64")
    m = gp.GPE(X, y, gp.MeanZero(), gp.SE(0.0, 0.0), lognoise=0.0, device="cpu")
    x0 = torch.tensor([0.3, -0.2, 0.5], dtype=torch.float64)
    m.set_params(x0)
    t, g = m.target_and_dtarget()
    v, gr = vg(x0)
    assert float(v) == pytest.approx(-float(t), rel=1e-12)
    torch.testing.assert_close(gr, -g, rtol=1e-10, atol=1e-10)
    for maxiter in (1, 3, 12):
        m.set_params(x0)
        res = m.optimize(method="optax", maxiter=maxiter)
        x, n_iter, evals = lbfgs.minimize(vg, x0, maxiter)
        np.testing.assert_allclose(res.x, x.numpy(), rtol=0, atol=1e-9)
        assert res.n_iter == n_iter and res.message == f"{evals} evaluations"


def test_follow_reads_the_packages_iterates_as_its_own():
    """The iterates that the package's optimize runs, read through its loop's
    trace, are the reference's own to rounding in float64: every counted
    direction agrees, no step rises, and the count of iterates is the
    iterations' and the end point's."""
    cfg, X, y = _data("gpe_se_d10", 120)
    vg = harness._module("reference", "gpe_se_d10").objective(cfg, X, y, "f64")
    m = gp.GPE(X, y, gp.MeanZero(), gp.SE(0.0, 0.0), lognoise=0.0, device="cpu")
    x0 = torch.tensor([0.3, -0.2, 0.5], dtype=torch.float64)
    m.set_params(x0)
    xs = []
    with port.lbfgs_iterates(xs):
        res = m.optimize(method="optax", maxiter=12)
    xs.append(torch.as_tensor(res.x))
    assert len(xs) == res.n_iter + 1
    torch.testing.assert_close(xs[0], x0)
    rows, rise, values = lbfgs.follow(vg, xs, 1e-3)
    assert len(rows) >= 5 and max(r[2] for r in rows) < 1e-7
    assert rise == 0.0 and values[-1] < values[0]


def test_gpa_objective_and_lbfgs(monkeypatch):
    cfg, X, y = _data("gpa_bern_mat32", 50)
    m = _gpa(cfg, X, y, monkeypatch)
    ref = harness._module("reference", "gpa_bern_mat32")
    vg = ref.objective(cfg, X, y, "f64")
    g = torch.Generator().manual_seed(2)
    x0 = torch.cat([0.1 * torch.randn(50, generator=g, dtype=torch.float64),
                    2 * torch.rand(cfg["d"] + 1, generator=g, dtype=torch.float64) - 1])
    m.set_params(x0)
    t, gr = m.target_and_dtarget()
    v, gref = vg(x0)
    assert float(v) == pytest.approx(-float(t), rel=1e-12)
    torch.testing.assert_close(gref, -gr, rtol=1e-9, atol=1e-10)
    for maxiter in (1, 3, 10):
        m.set_params(x0)
        res = m.optimize(method="optax", maxiter=maxiter)
        np.testing.assert_allclose(res.x, lbfgs.minimize(vg, x0, maxiter)[0].numpy(), rtol=0,
                                   atol=1e-8)


def test_split_hmc_outer_iteration(monkeypatch):
    """One outer iteration of the package's sampler and of the reference,
    from the same chains and the same generator state: the same states
    after every update, whether the reference carries its own states or
    takes the package's."""
    cfg, X, y = _data("gpa_bern_mat32", 30)
    cfg = dict(cfg, precision="float64")
    m = _gpa(cfg, X, y, monkeypatch)
    s = cfg["sampler"]
    C, n = 6, 30
    g0 = torch.Generator().manual_seed(9)
    x = 0.3 * torch.randn((C, n + cfg["d"] + 1), generator=g0, dtype=torch.float64)
    state = g0.get_state()
    res = split_hmc(*m.make_split_logprob()[:3], x[:, :n], x[:, n:], g0, n_iter=2,
                    a_iters=s["a_iters"], eps_a=s["eps_a"], eps_b=s["eps_b"], Lmin=s["Lmin"],
                    Lmax=s["Lmax"])
    k = s["a_iters"]
    for j in (0, 1):  # the second outer iteration from its state, the draws skipped to it
        start = (x[:, :n], x[:, n:]) if j == 0 else (res.samples[:, k - 1, :n],
                                                       res.samples[:, k, n:])
        given = res.samples[:, j * k: j * k + k, :n].transpose(0, 1)
        b_out = res.samples[:, k, n:] if j == 0 else res.final[:, n:]
        for follow in (None, given):
            gen = torch.Generator()
            gen.set_state(state)
            ref_split.skip(gen, C, n, cfg["d"] + 1, cfg, j)
            a_steps, b_new, acc, margin = ref_split.outer_iteration(*start, gen, X, y, cfg,
                                                                    "f64", given_a=follow)
            torch.testing.assert_close(a_steps, given, rtol=1e-9, atol=1e-9)
            torch.testing.assert_close(b_new, b_out, rtol=1e-9, atol=1e-9)
        assert 0 < float(acc.double().mean()) <= 1
        assert bool((margin[acc] > 0).all())


def test_diagnostics_are_the_packages():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(8, 300, 5, generator=g, dtype=torch.float64).cumsum(1) * 0.1
    x = x + torch.randn(8, 300, 5, generator=g, dtype=torch.float64)
    torch.testing.assert_close(diagnostics.effective_sample_size(x),
                               port_diag.effective_sample_size(x), rtol=0, atol=0)
    torch.testing.assert_close(diagnostics.split_rhat(x), port_diag.split_rhat(x), rtol=0, atol=0)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.14159265],
                     dtype=torch.float32)
    r = precision.tf32(x)
    assert r[0] == 1.0
    assert r[1] == 1.0 + 2.0 ** -10  # the half-way case rounds away from zero
    assert r[2] == 1.0 + 2.0 ** -10
    mant = r.view(torch.int32) & 0x1FFF
    assert bool((mant == 0).all())
    assert abs(float(r[3]) + 3.14159265) < 2.0 ** -10 * 4
    # its gradient passes straight through
    y = x.clone().requires_grad_()
    precision.tf32(y).sum().backward()
    assert bool((y.grad == 1).all())
