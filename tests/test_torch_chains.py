"""The port's chain-sharded samplers (parallel/chains.py) against the JAX
package's, on one process: the JAX package's draws (each chain's key folded
with the global iteration, rebuilt as it splits them) replayed through the
port's iteration-keyed streams give JAX's samples, adapted step sizes, mass
matrix and acceptance, rtol 1e-10 (and atol 1e-10 of the largest value), f64.
Then the port's own guarantees: a resumed or segmented run, and a run over
two gloo processes, give the bits of one uninterrupted run.

On configuration #5's Student-t GPA (cut to n = 12, cond(K) ~ 6e6) the two
packages' gradients stand up to ~2e-10 apart, and HMC there amplifies any
difference, down to the last bit of a sum, to ~1e-5 over 24 adapted
iterations. So the adaptive run on it is held iteration by iteration: each
of its 32 iterations starts from the JAX sampler's state at that iteration
(its checkpoint), on JAX's own target, and must give JAX's next state
within 1e-9 (`STEP_RTOL`); the port's target is held against JAX's at each
of those states within 1e-10, and its gradient within `STEP_RTOL`."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
from gaussianprocesses_jl_tpu.inference.ess import _MAX_SHRINK
from gaussianprocesses_jl_tpu.parallel import chains as j_chains
from gaussianprocesses_jl_tpu.parallel.mesh import make_mesh as j_make_mesh
from gaussianprocesses_jl_tpu_torch.parallel import chains
from gaussianprocesses_jl_tpu_torch.parallel.mesh import make_mesh
from gaussianprocesses_jl_tpu_torch.perf import student_t_study
from jax_draws import Replay, ess_draws, jax_target, sharded_hmc_draws, sharded_split_draws

import torch_ranks

RTOL = 1e-10
# one iteration of the Student-t GPA from JAX's state, on JAX's own target:
# the largest gap measured over the 32 iterations was 2.5e-10 of its field
# (the step size after iteration 4), the leapfrog amplifying 1-ulp
# differences in the arithmetic of either package
STEP_RTOL = 1e-9
N_OBS = 12  # configuration #5's data cut to 12 points


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref, dtype=float)
    np.testing.assert_allclose(np.asarray(got, dtype=float), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _jax_gpa():
    x, y = student_t_study.config5_data(N_OBS)
    m = gj.GPA(x.astype(float), y.astype(float), gj.MeanZero(), gj.SE(0.0, 0.0),
               gj.StuTLik(lsigma=jnp.asarray(-1.0), nu=3))
    m.set_priors(kern=[gj.priors.Normal(0.0, 2.0)] * 2, lik=[gj.priors.Normal(-1.0, 1.0)])
    return m


def _gaussian():
    mu, sd = np.array([1.0, -2.0, 0.5]), np.array([0.5, 2.0, 1.0])
    return (lambda th: -0.5 * jnp.sum(((th - mu) / sd) ** 2),
            lambda th: -0.5 * torch.sum(((th - torch.as_tensor(mu)) / torch.as_tensor(sd)) ** 2),
            np.zeros(3))


def _student_t():
    lpj, x0, _, _ = _jax_gpa().make_logprob()
    lpt, _, _, _ = student_t_study.config5_model("cpu", np.float64, N_OBS).make_logprob()
    return lpj, lpt, np.asarray(x0)


@pytest.mark.parametrize("target,n_warmup", [("gaussian", 24), ("student_t", 0)])
def test_sharded_hmc_matches_jax(target, n_warmup):
    """4 chains, n_warmup + 8 iterations: the kept samples, final states and
    targets, eps_final, minv_final and the accept rates. The 3-D Gaussian
    with 24 warmup iterations (mass updates at 12 and 18); the Student-t
    GPA at its start step size."""
    lpj, lpt, x0 = {"gaussian": _gaussian, "student_t": _student_t}[target]()
    C, D = 4, x0.shape[0]
    theta0 = x0[None] + 0.05 * np.random.RandomState(1).randn(C, D)
    kw = dict(n_iter=8, n_warmup=n_warmup, eps0=0.05, Lmin=2, Lmax=5)
    key = jax.random.PRNGKey(5)
    rj = j_chains.sharded_hmc(lpj, jnp.asarray(theta0), key, j_make_mesh({"chains": 1}), **kw)
    draws = sharded_hmc_draws(key, C, n_warmup + 8, D, kw["Lmin"], kw["Lmax"])
    rt = chains.sharded_hmc(lpt, torch.as_tensor(theta0), lambda it: Replay(hmc=[draws[it]]),
                            make_mesh(device="cpu"), **kw)
    assert np.allclose(np.asarray(rj.minv_final), 1.0) == (n_warmup == 0)
    for f in ("samples", "final", "final_target", "eps_final", "minv_final", "accept_rate"):
        _close(getattr(rt, f), getattr(rj, f))


def test_every_sharded_hmc_iteration_matches_jax(monkeypatch):
    """The Student-t GPA at n = 12, 4 chains, 24 warmup + 8 iterations: the
    JAX sampler's state after every iteration (its checkpoints, every
    iteration) against one port iteration, on JAX's target, from JAX's
    state before it: the states, targets, gradients, accept counts, the
    dual-averaging state, the mass matrix (updated at iterations 11 and 17)
    and the window sums; and the port's own target and gradient at each
    state against JAX's."""
    lpj, lpt, x0 = _student_t()
    C, D, n_warmup, total = 4, x0.shape[0], 24, 32
    theta0 = x0[None] + 0.05 * np.random.RandomState(1).randn(C, D)
    kw = dict(n_warmup=n_warmup, eps0=0.05, Lmin=2, Lmax=5)
    key = jax.random.PRNGKey(5)
    states = []
    monkeypatch.setattr(j_chains, "save_checkpoint",
                        lambda path, st: states.append(jax.tree.map(np.asarray, st["carry"])))
    rj = j_chains.sharded_hmc(lpj, jnp.asarray(theta0), key, j_make_mesh({"chains": 1}),
                              n_iter=total - n_warmup, checkpoint_every=1,
                              checkpoint_path="never-written", **kw)
    final = (rj.final, rj.final_target, None, None, rj.accept_rate * (total - n_warmup),
             rj.eps_final, None, None, None, None, rj.minv_final[None])
    assert len(states) == total - 1
    draws = sharded_hmc_draws(key, C, total, D, kw["Lmin"], kw["Lmax"])
    fleet = chains._Fleet(make_mesh(device="cpu"), "chains", C,
                          lambda it: Replay(hmc=[draws[it]]))
    sch = chains._Schedule(n_warmup, kw["Lmin"], kw["Lmax"], 0.8)
    vg = chains.batched_value_and_grad(jax_target(lpj))
    vg_port = chains.batched_value_and_grad(lpt)
    t0, g0 = vg(torch.as_tensor(theta0))
    T = lambda a, **k: torch.tensor(np.asarray(a), **k)  # noqa: E731
    for it in range(total):
        if it == 0:
            carry = {"theta": T(theta0), "tgt": t0, "grad": g0,
                     "acc": torch.zeros(C, dtype=torch.float64),
                     "da": tuple(T(v, dtype=torch.float64) for v in
                                 (0.05, np.log(0.5), np.log(0.05), 0.0, 0.0)),
                     "minv": torch.ones(D, dtype=torch.float64),
                     "s1": torch.zeros((C, D), dtype=torch.float64),
                     "s2": torch.zeros((C, D), dtype=torch.float64), "n_win": 0}
        else:
            (th, tg, gr, _, acc, eps, mu, leb, hbar, t, minv, s1, s2, cnt) = states[it - 1]
            # the window's sum over chains, as JAX holds it, in chain 0's row
            rows = lambda s: torch.cat([T(s), torch.zeros((C - 1, D), dtype=torch.float64)])  # noqa: E731,E501
            carry = {"theta": T(th), "tgt": T(tg), "grad": T(gr), "acc": T(acc),
                     "da": tuple(map(T, (eps, mu, leb, hbar, t))), "minv": T(minv[0]),
                     "s1": rows(s1), "s2": rows(s2), "n_win": int(round(float(cnt[0]) / C))}
        with torch.no_grad():
            chains._hmc_step(carry, it, vg, fleet, sch)
        ref = states[it] if it < total - 1 else final
        got = (carry["theta"], carry["tgt"], carry["grad"], None, carry["acc"],
               *carry["da"], carry["minv"][None], carry["s1"].sum(0, keepdim=True),
               carry["s2"].sum(0, keepdim=True), float(carry["n_win"] * C))
        for g, r in zip(got, ref):
            if g is not None and r is not None:
                _close(g, r, STEP_RTOL)
        t_port, g_port = vg_port(T(ref[0]))
        t_jax, g_jax = vg(T(ref[0]))
        _close(t_port, t_jax)
        # the gradient at STEP_RTOL, as every state field: at cond(K) ~ 6e6
        # the two packages' gradients stood up to 1.04e-10 of max|g| apart
        # over the 32 states (AMD EPYC, MKL), past rtol 1e-10 on some hosts
        _close(g_port, g_jax, STEP_RTOL)


def test_sharded_split_hmc_matches_jax():
    """Configuration #5's split target at n = 12, 4 chains, 2 warmup + 2
    outer iterations of 2 A updates: the warmup and kept draws (each a_i
    with the b in force), the final state and target, the collective step
    sizes and the accept rates."""
    mj = _jax_gpa()
    pj, laj, lbj, aj, bj = mj.make_split_logprob()
    pt, lat, lbt, at, bt = student_t_study.config5_model("cpu", np.float64,
                                                         N_OBS).make_split_logprob()
    na, C = aj.shape[0], 4
    x0 = np.concatenate([np.asarray(aj), np.asarray(bj)])
    theta0 = x0[None] + 0.05 * np.random.RandomState(2).randn(C, x0.shape[0])
    kw = dict(n_iter=2, n_warmup=2, a_iters=2, eps_a0=0.2, eps_b0=0.05, Lmin=2, Lmax=4,
              Lmin_b=1, Lmax_b=3)
    key = jax.random.PRNGKey(6)
    rj = j_chains.sharded_split_hmc(pj, laj, lbj, jnp.asarray(theta0), key,
                                    j_make_mesh({"chains": 1}), na, **kw)
    draws = sharded_split_draws(key, C, 4, 2, na, bj.shape[0], 2, 4, 1, 3)
    rt = chains.sharded_split_hmc(pt, lat, lbt, torch.as_tensor(theta0),
                                  lambda it: Replay(hmc=draws[it]), make_mesh(device="cpu"), na,
                                  **kw)
    for f in ("samples", "warmup_samples", "final", "final_target", "eps_a_final",
              "eps_b_final", "accept_rate_a", "accept_rate_b"):
        _close(getattr(rt, f), getattr(rj, f))


def test_sharded_ess_matches_jax():
    """The GPE counterpart at n = 12, 4 chains, 4 iterations: the samples,
    final log likelihoods and the fleet's mean proposal count."""
    x, y = student_t_study.config5_data(N_OBS)
    mj = gj.GPE(x.astype(float), y.astype(float), kernel=gj.SE(0.0, 0.0), lognoise=-1.0)
    llj, x0, _, _ = mj.make_logprob(include_priors=False)
    llt, _, _, _ = student_t_study.config5_gpe("cpu", np.float64, N_OBS).make_logprob(
        include_priors=False)
    mu, sigma = np.asarray(student_t_study.PRIOR_MU), np.asarray(student_t_study.PRIOR_SIGMA)
    C = 4
    theta0 = np.asarray(x0)[None] + 0.05 * np.random.RandomState(3).randn(C, 3)
    key = jax.random.PRNGKey(7)
    rj = j_chains.sharded_ess(llj, jnp.asarray(theta0), jnp.asarray(mu), jnp.asarray(sigma), key,
                              j_make_mesh({"chains": 1}), n_iter=4)
    st, sh = ess_draws(jax.random.split(key, C), 4, 3, _MAX_SHRINK)
    rt = chains.sharded_ess(llt, torch.as_tensor(theta0), mu, sigma,
                            lambda it: Replay(ess_starts=[st[it]], ess_shrinks=[sh[it]]),
                            make_mesh(device="cpu"), n_iter=4)
    for f in ("samples", "final", "final_loglik"):
        _close(getattr(rt, f), getattr(rj, f))
    assert float(rt.mean_proposals) == float(rj.mean_proposals)


def _same(a, b, fields):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


HMC_FIELDS = ("samples", "accept_rate", "eps_final", "minv_final", "final", "final_target")


def test_resume_and_segments_give_the_same_bits(tmp_path):
    """sharded_hmc stopped after its first checkpoint and resumed from the
    file, or run in segments of 5, gives the uninterrupted run's bits; so
    does sharded_split_hmc in segments of 1. Seeded by an int."""
    logprob, theta0 = torch_ranks.problem()
    m = make_mesh(device="cpu")
    whole = chains.sharded_hmc(logprob, theta0, torch_ranks.SEED, m, **torch_ranks.HMC_KW)
    _same(chains.sharded_hmc(logprob, theta0, torch_ranks.SEED, m, segment_iters=5,
                             **torch_ranks.HMC_KW), whole, HMC_FIELDS)
    path = str(tmp_path / "hmc.ckpt.npz")
    torch_ranks.interrupted(logprob, theta0, m, path)
    assert os.path.exists(path)
    resumed = chains.sharded_hmc(logprob, theta0, torch_ranks.SEED, m, checkpoint_every=8,
                                 checkpoint_path=path, **torch_ranks.HMC_KW)
    _same(resumed, whole, HMC_FIELDS)

    target = student_t_study.config5_model("cpu", np.float64, torch_ranks.N_OBS)
    pc, la, lb, a0, b0 = target.make_split_logprob()
    th = torch.cat([a0, b0]) + 0.05 * torch.as_tensor(np.random.RandomState(4).randn(4, 15))
    kw = dict(n_iter=2, n_warmup=2, a_iters=2, Lmin=2, Lmax=3)
    one = chains.sharded_split_hmc(pc, la, lb, th, 9, m, a0.numel(), **kw)
    seg = chains.sharded_split_hmc(pc, la, lb, th, 9, m, a0.numel(), segment_iters=1, **kw)
    _same(seg, one, ("samples", "warmup_samples", "accept_rate_a", "accept_rate_b",
                     "eps_a_final", "eps_b_final", "final", "final_target"))
    assert not torch.equal(one.eps_a_final, torch.tensor(0.2, dtype=torch.float64))


def test_arguments_are_validated():
    lp = lambda th: -0.5 * torch.sum(th * th)  # noqa: E731
    th = torch.zeros((3, 2), dtype=torch.float64)
    m = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="together"):
        chains.sharded_hmc(lp, th, 0, m, n_iter=2, checkpoint_every=1)
    with pytest.raises(ValueError, match="together"):
        chains.sharded_hmc(lp, th, 0, m, n_iter=2, checkpoint_path="x.npz")
    two = m.__class__(("chains",), {"chains": 2}, {"chains": 0}, {"chains": None}, m.device)
    for call in (lambda: chains.sharded_hmc(lp, th, 0, two, n_iter=2),
                 lambda: chains.sharded_ess(lp, th, 0.0, 1.0, 0, two, n_iter=2)):
        with pytest.raises(ValueError, match="not divisible"):
            call()


def test_two_gloo_processes_give_the_bits_of_one(tmp_path):
    """sharded_hmc over two gloo processes on the CPU (2 chains each), whole
    and resumed by both ranks from the checkpoint rank 0 wrote, gives the
    bits of the same run in this one process; the pod meshes of the two
    ranks lay them out as (2, 1) and (1, 2)."""
    logprob, theta0 = torch_ranks.problem()
    one = chains.sharded_hmc(logprob, theta0, torch_ranks.SEED, make_mesh(device="cpu"),
                             **torch_ranks.HMC_KW)
    script = os.path.join(os.path.dirname(__file__), "torch_ranks.py")
    init = tmp_path / "rendezvous"
    procs = [subprocess.Popen([sys.executable, script, str(r), "2", str(init), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for run in ("whole", "resumed"):
            for f in HMC_FIELDS:
                np.testing.assert_array_equal(got[f"{run}_{f}"], getattr(one, f).numpy())
        np.testing.assert_array_equal(got["pod1_shape"], [2, 1])
        np.testing.assert_array_equal(got["pod1_coords"], [r, 0])
        np.testing.assert_array_equal(got["pod2_shape"], [1, 2])
        np.testing.assert_array_equal(got["pod2_coords"], [0, r])
