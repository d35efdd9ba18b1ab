"""The fused leapfrog of split HMC's block A (ops/leapfrog.py, the kernel's
plain version on the CPU): one transition against `hmc_transition` on
`block_a(logprob_a)` from the same draws, the split sampler's choice of
route, and whole outer iterations on the fused route against the JAX
package's `split_hmc` from its own draws."""
import math

import jax
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu_torch.inference import split
from gaussianprocesses_jl_tpu_torch.inference.hmc import hmc_transition
from gaussianprocesses_jl_tpu_torch.models.gpa import fused_block_a
from gaussianprocesses_jl_tpu_torch.ops import leapfrog
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal
from jax_draws import Replay, split_draws

N, D, C, LMAX = 10, 2, 8, 5


def _model(dtype, lik=None, mean=None, n=N, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, D)
    y = (np.sin(X[:, 0]) + 0.3 * rng.randn(n) > 0).astype(float)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    m = gt.GPA(X.astype(np_dt), y.astype(np_dt), mean or gt.MeanZero(),
               gt.Matern(1.5, np.zeros(D), 0.0), lik or gt.BernLik(), device="cpu")
    m.set_priors(kern=[Normal(0.0, 2.0)] * (D + 1))
    return m


def _case(dtype, case):
    """A transition's inputs: C chains around the model's state, path
    lengths cycling through 1..LMAX, chain 0 set up for `case`."""
    m = _model(dtype)
    pre, la, _, a0, b0 = m.make_split_logprob()
    g = torch.Generator().manual_seed(1)
    a = a0[None] + 0.5 * torch.randn((C, N), generator=g, dtype=dtype)
    b = b0[None] + 0.3 * torch.randn((C, D + 1), generator=g, dtype=dtype)
    aux = split._cached(pre, b)
    nu0 = torch.randn((C, N), generator=g, dtype=dtype)
    steps = torch.arange(C) % LMAX + 1
    log_u = torch.log(torch.rand((C,), generator=g, dtype=dtype))
    eps = torch.linspace(0.15, 0.35, C, dtype=dtype)
    big = math.sqrt(torch.finfo(dtype).max)
    if case == "not_pd":  # the factor failed: safe_cholesky's identity, ok False
        aux = aux.with_tensors((aux.L.clone(), aux.ok.clone()))
        aux.L[0] = torch.eye(N, dtype=dtype)
        aux.ok[0] = False
    elif case == "overflow":  # the first step's position overflows: frozen
        nu0[0, 0] = torch.finfo(dtype).max
        eps[0], steps[0] = 4.0, LMAX
    elif case == "glide":  # |v|^2 overflows at the start and the first step, not later
        L = aux.L.clone()
        L[0] = L[0] * (1e3 / big)  # f stays moderate
        aux = aux.with_tensors((L, aux.ok))
        a[0, 0], nu0[0, 0] = 1.1 * big, 0.0
        eps[0], steps[0] = 0.3, 3
    vg = split.block_a(la)
    t, gr = vg(a, aux, b)
    gr = torch.where(torch.isfinite(gr), gr, torch.zeros_like(gr))
    block = fused_block_a(m.params, m.x, m.y, m.covstrat)
    return vg, block, aux, b, (a, t, gr, nu0, steps, log_u, eps)


TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["lengths", "not_pd", "overflow", "glide"])
def test_plain_transition_matches_hmc_transition(case, dtype):
    """The kernel's plain version from the same states and draws as
    `hmc_transition(block_a(logprob_a), ...)`: every output within 1e-10
    (f64) or 1e-5 (f32) relative, the accept decisions equal. Path lengths
    1..LMAX, and chain 0: a failed factor (rejected, state kept), an
    overflowing momentum (frozen, rejected) or a path through targets of
    -inf from a start at one (the glide: accepted at a finite endpoint)."""
    vg, block, aux, b, (a, t, gr, nu0, steps, log_u, eps) = _case(dtype, case)
    seen = []

    def recording(th, *rest):
        out = vg(th, *rest)
        seen.append(bool(torch.isfinite(out[0][0])))
        return out

    ref = hmc_transition(recording, a, t, gr, nu0, steps, log_u, eps, LMAX, rest=(aux, b))
    got = leapfrog.transition(block, aux, block.prior(b), a, t, gr, nu0, steps, log_u, eps, LMAX)
    names = ("theta", "target", "gradient", "accept_prob")
    for name, x, r in zip(names, got, ref):
        scale = float(r[torch.isfinite(r)].abs().max().clamp_min(1.0))
        np.testing.assert_allclose(x.numpy(), r.numpy(), rtol=TOL[dtype], atol=TOL[dtype] * scale,
                                   err_msg=name)
    assert torch.equal(got[4], ref[4])
    if case == "not_pd" or case == "overflow":
        assert not bool(got[4][0]) and float(got[3][0]) == 0.0
        assert torch.equal(got[0][0], a[0]) and torch.equal(got[2][0], gr[0])
    if case == "glide":
        assert not math.isfinite(float(t[0])) and seen[:2] == [False, True]
        assert bool(got[4][0]) and math.isfinite(float(got[1][0]))


def _route_model(kind):
    if kind == "student_t":
        return _model(torch.float32, lik=gt.StuTLik(0.0, 3))
    if kind == "mean_with_params":
        return _model(torch.float32, mean=gt.MeanConst(0.1))
    return _model(torch.float64 if kind == "float64" else torch.float32)


@pytest.mark.parametrize("kind", ["bernoulli", "student_t", "mean_with_params", "float64"])
def test_split_hmc_route(kind, monkeypatch):
    """With the chains counted as on the card: a float32 probit GPA whose
    block A is v alone takes the fused route for every A transition and
    gives the graphed route's draws within float32 rounding; a Student-t
    likelihood (a parameter in block A), a mean with a parameter and a
    float64 target keep the graphed route, the fused count at 0."""
    m = _route_model(kind)
    pre, la, lb, a0, b0 = m.make_split_logprob()
    x0 = torch.cat([a0, b0])[None] + 0.05 * torch.randn(
        (4, a0.numel() + b0.numel()), generator=torch.Generator().manual_seed(2), dtype=a0.dtype)
    na = a0.numel()
    kw = dict(n_iter=2, a_iters=3, eps_a=0.2, eps_b=0.1, Lmin=2, Lmax=4)

    def run(on_card):
        monkeypatch.setattr(split, "_on_card", lambda a: on_card)
        before = dict(split.ROUTES)
        res = split.split_hmc(pre, la, lb, x0[:, :na], x0[:, na:],
                              torch.Generator().manual_seed(4), **kw)
        return res, {k: split.ROUTES[k] - before[k] for k in before}

    res, moved = run(True)
    fused = kind == "bernoulli"
    assert moved == ({"fused": 6, "graphed": 0} if fused else {"fused": 0, "graphed": 6})
    assert (la.fused is not None) == fused
    if fused:
        ref, moved_ref = run(False)
        assert moved_ref == {"fused": 0, "graphed": 6}
        for field in ("samples", "final", "accept_rate_a", "accept_rate_b"):
            np.testing.assert_allclose(getattr(res, field).numpy(), getattr(ref, field).numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=field)


KW = dict(a_iters=2, eps_a=0.2, eps_b=0.1, Lmin=2, Lmax=4)


@pytest.mark.parametrize("chains", [None, 2])
def test_fused_route_follows_jax(chains, monkeypatch):
    """The fused route (the kernel's plain version, f64) through one warmup
    and one sampling outer iteration from the JAX package's own draws: its
    draws, final state and target, accept rates and adapted step sizes
    equal JAX's `split_hmc` within 1e-10."""
    rng = np.random.RandomState(5)
    X = rng.randn(8, 2)
    y = (np.sin(X[:, 0]) + 0.3 * rng.randn(8) > 0).astype(float)
    mj = gj.GPA(X, y, gj.MeanZero(), gj.SE(0.0, 0.0), gj.BernLik())
    mt = gt.GPA(X, y, gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik(), device="cpu")
    mj.set_priors(kern=[gj.priors.Normal(0.0, 1.0)] * 2)
    mt.set_priors(kern=[gt.priors.Normal(0.0, 1.0)] * 2)
    pj, laj, lbj, aj, bj = mj.make_split_logprob()
    pt, lat, lbt, at, bt = mt.make_split_logprob()
    lat.fused = fused_block_a(mt.params, mt.x, mt.y, mt.covstrat)
    monkeypatch.setattr(split, "_on_card", lambda a: True)
    C = chains or 1
    a0 = np.asarray(aj)[None] + 0.1 * rng.randn(C, aj.shape[0])
    b0 = np.asarray(bj)[None] + 0.1 * rng.randn(C, bj.shape[0])
    keys = [jax.random.PRNGKey(11 + c) for c in range(C)]

    def run_jax(a, b, k):
        return gj.split_hmc(pj, laj, lbj, a, b, k, n_iter=1, n_warmup=1, **KW)

    if chains is None:
        rj = run_jax(a0[0], b0[0], keys[0])
    else:
        rj = jax.vmap(run_jax)(a0, b0, jax.numpy.stack(keys))
    stream = Replay(hmc=split_draws(keys, 2, KW["a_iters"], aj.shape[0], bj.shape[0],
                                    KW["Lmin"], KW["Lmax"]))
    a_in, b_in = torch.as_tensor(a0), torch.as_tensor(b0)
    if chains is None:
        a_in, b_in = a_in[0], b_in[0]
    before = split.ROUTES["fused"]
    rt = split.split_hmc(pt, lat, lbt, a_in, b_in, stream, n_iter=1, n_warmup=1, **KW)
    assert stream.exhausted() and split.ROUTES["fused"] - before == 2 * KW["a_iters"]
    for field in ("samples", "warmup_samples", "final", "final_target", "accept_rate_a",
                  "accept_rate_b", "eps_a_final", "eps_b_final"):
        got, ref = getattr(rt, field), np.asarray(getattr(rj, field))
        assert tuple(got.shape) == ref.shape, field
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12, err_msg=field)


@pytest.mark.parametrize("dtype,n_max", [(torch.float32, 239), (torch.float64, 169)])
def test_fits_follows_shared_memory(dtype, n_max):
    """A block holds the factor up to n = 239 in float32 and 169 in float64
    (227 KB of dynamic shared memory), and at most one element a thread."""
    assert leapfrog.fits(n_max, dtype) and not leapfrog.fits(n_max + 1, dtype)
    assert leapfrog.smem_bytes(n_max, dtype) <= leapfrog.SMEM_LIMIT
    assert leapfrog.fits(200, torch.float32) and not leapfrog.fits(0, dtype)
