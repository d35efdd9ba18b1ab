"""The graph layer (`utils/graphs.py`) on the CPU, f64.

A CUDA graph cannot be captured here, so three things are checked:

* the CPU path is the eager function: the headline's and the GPA's value
  and gradient, one HMC transition and one split transition give, bit for
  bit, what they give inside `graphs.eager()` and what the plain autograd
  of the target gives;
* every capture region reads nothing back to the host (`host_reads.py`:
  host reads and copies of host data made to raise), here on meshes of
  size 1 and in tests/torch_parallel_ranks.py at P = 2 and 4;
* the layer's own logic, with the capture emulated: a replay that re-runs
  the captured function on the static input buffers, as a CUDA graph
  re-runs its kernels on them. Its keys (a new shape or structure captures
  anew, new values replay), its copies in and out, its launch counts, the
  graphs' lifetime (with their model, the last `PER_OWNER` an owner) and
  the pool's, and the refusal of a collective inside a capture; and the
  owners of the later paths: a fit's objective (VI's Adam step), the
  elastic model (one graph a capacity and block size), the model's
  cross-validation graphs (a fold set of the same padded shape replays),
  the elliptical-slice sampler's two graphs.
"""
import dataclasses
import gc
import types
import weakref

import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu_torch.inference.hmc import hmc
from gaussianprocesses_jl_tpu_torch.inference.split import split_hmc
from gaussianprocesses_jl_tpu_torch.models import sparse
from gaussianprocesses_jl_tpu_torch.models.gpe import gpe_target
from gaussianprocesses_jl_tpu_torch.ops import cholesky_kernels, leapfrog
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.parallel import collectives
from gaussianprocesses_jl_tpu_torch.parallel.chains import sharded_hmc, sharded_split_hmc
from gaussianprocesses_jl_tpu_torch.parallel.dense import (AmbientFullCovariance,
                                                           DistributedFullCovariance)
from gaussianprocesses_jl_tpu_torch.parallel.mesh import make_mesh, make_pod_mesh
from gaussianprocesses_jl_tpu_torch.perf.gram_study import eagerly
from gaussianprocesses_jl_tpu_torch.utils import graphs
from gaussianprocesses_jl_tpu_torch.utils.priors import Normal

from host_reads import checked_run
from gaussianprocesses_jl_tpu_torch.inference import crossvalidation as cv
from gaussianprocesses_jl_tpu_torch.inference import lbfgs
from gaussianprocesses_jl_tpu_torch.inference.ess import ess
from gaussianprocesses_jl_tpu_torch.inference.vi import make_neg_elbo
from gaussianprocesses_jl_tpu_torch.models.elastic import ElasticGPE
from gaussianprocesses_jl_tpu_torch.parallel.chains import sharded_ess
from gaussianprocesses_jl_tpu_torch.perf.fitc_study import FitcAdam
from gaussianprocesses_jl_tpu_torch.perf.parallel_study import ShardedFitcAdam


def _gpe(n=30, seed=0, kernel=None):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3)
    y = np.sin(X[:, 0]) + 0.1 * rng.randn(n)
    kern = gt.SE(0.1, -0.2) + gt.Matern(1.5, np.zeros(3), 0.0) if kernel is None else kernel
    return gt.GPE(X, y, gt.MeanConst(beta=0.3), kern, lognoise=-1.0, device="cpu")


def _gpa(n=10, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 2)
    y = (np.sin(X[:, 0]) + 0.3 * rng.randn(n) > 0).astype(float)
    m = gt.GPA(X, y, gt.MeanZero(), gt.SE(0.0, 0.0), gt.BernLik(), device="cpu")
    m.set_priors(kern=[Normal(0.0, 1.0)] * 2)
    return m


def _autograd(m, target):
    vec = m.params.flat_params().detach().requires_grad_()
    t = target(m.params.with_flat_params(vec), m.x, m.y, m.covstrat)[0]
    (g,) = torch.autograd.grad(t, vec)
    return t.detach(), g


def _kept(owner) -> int:
    """How many graphs the layer keeps for `owner`."""
    return len(graphs._GRAPHS.get(owner, ()))


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _hmc_run(eager):
    lp, x0, _, _ = _gpa().make_logprob()
    starts = x0 + 0.1 * torch.as_tensor(np.random.RandomState(1).randn(3, x0.numel()))
    gen = torch.Generator().manual_seed(4)
    res = (eagerly(hmc) if eager else hmc)(lp, starts, gen, n_iter=1, eps=0.05, Lmin=2, Lmax=4)
    return res.samples, res.final_target, res.accept_rate


def _split_run(eager, n_iter=1, m=None):
    precompute, la, lb, a0, b0 = (m or _gpa()).make_split_logprob()
    rng = np.random.RandomState(2)
    a = a0 + 0.1 * torch.as_tensor(rng.randn(3, a0.numel()))
    b = b0 + 0.1 * torch.as_tensor(rng.randn(3, b0.numel()))
    gen = torch.Generator().manual_seed(6)
    res = (eagerly(split_hmc) if eager else split_hmc)(
        precompute, la, lb, a, b, gen, n_iter=n_iter, a_iters=2, eps_a=0.2, eps_b=0.1, Lmin=2,
        Lmax=4)
    return res.samples, res.final_target, res.accept_rate_a, res.accept_rate_b


def _ess_run(rounds=2, sharded=False):
    m = _gpe(n=20)
    ll, x0, _, _ = m.make_logprob(include_priors=False)
    th = x0 + 0.1 * torch.as_tensor(np.random.RandomState(4).randn(3, x0.numel()))
    mu, sigma = np.zeros(x0.numel()), np.full(x0.numel(), 2.0)
    if sharded:
        r = sharded_ess(ll, th, mu, sigma, 5, make_mesh(device="cpu"), n_iter=3, rounds=rounds)
    else:
        r = ess(ll, th, mu, sigma, torch.Generator().manual_seed(3), n_iter=3, rounds=rounds)
    return r.samples, r.final_loglik, r.mean_proposals


def _vi_run(method="adam"):
    m = _gpa(n=12)
    Q = gt.vi(m, nits=4, method=method)
    return Q.m, Q.v


def _elastic_run():
    rng = np.random.RandomState(8)
    X, y = rng.randn(20, 2), rng.randn(20)
    m = ElasticGPE(2, kernel=gt.SE(0.1, 0.0), lognoise=-1.0, capacity=12, stepsize=8,
                   device="cpu", dtype=torch.float64)
    out = []
    for i in range(0, 20, 4):
        m.append(X[i:i + 4], y[i:i + 4])
        out.append(m._L.clone())
    return out


FOLDS = [[0, 3, 4], [1, 2], [5, 6, 7, 8, 9]]
CV_CALLS = {
    "predict_LOO": lambda m: list(cv.predict_LOO(m)),
    "logp_LOO": lambda m: [cv.logp_LOO(m)],
    "dlogp_LOO": lambda m: [cv.dlogp_LOO(m, noise=False)],
    "predict_CVfold": lambda m: [t for mv in cv.predict_CVfold(m, FOLDS) for t in mv],
    "logp_CVfold": lambda m: [cv.logp_CVfold(m, FOLDS)],
    "dlogp_CVfold": lambda m: [cv.dlogp_CVfold(m, FOLDS)],
}


def _predict_run(kind):
    xs = np.random.RandomState(9).randn(7, 3 if kind == "gpe" else 2)
    if kind == "gpe":
        return list(_gpe().predict_f(xs)) + list(_gpe().predict_f(xs, full_cov=True))
    m = _gpa()
    m.set_params(np.linspace(-0.5, 0.5, m.num_params()))
    return list(m.predict_f(xs)) + list(m.predict_f(xs, full_cov=True))


def _lbfgs_run(kind, rounds=lbfgs.TRIAL_BLOCK):
    """method='optax' for 4 iterations on a GPE or a GPA."""
    m = _gpe() if kind == "gpe" else _gpa()
    vg, x0, _, _ = m.make_objective()
    r = lbfgs.minimize(vg, x0, 4, rounds=rounds)
    return [r.x, r.value, r.trials]


def _fitc_run(sharded=False):
    rng = np.random.RandomState(10)
    X = rng.randn(40, 2)
    y = np.sin(X[:, 0]) + 0.1 * rng.randn(40)
    model = gt.FITC(X, X[::5].copy(), y, kernel=gt.SE(0.0, 0.0), lognoise=-1.0, device="cpu")
    trainer = (ShardedFitcAdam(model, make_mesh({"data": 1}, device="cpu")) if sharded
               else FitcAdam(model))
    losses = [torch.tensor(trainer.step()) for _ in range(3)]
    return [*losses, *trainer.state]


@pytest.mark.parametrize("case", ["headline", "gpa", "hmc", "split", "ess", "vi", "elastic",
                                  "cv", "fitc", "lbfgs"])
def test_cpu_path_is_the_eager_function(case):
    """On CPU tensors the layer calls the function itself: the same bits as
    inside `graphs.eager()`, and for the targets as the plain autograd of
    the target."""
    if case == "headline":
        m = _gpe()
        _equal(m.target_and_dtarget(), eagerly(m.target_and_dtarget)())
        _equal(m.target_and_dtarget(), _autograd(m, gpe_target))
    elif case == "gpa":
        m = _gpa()
        m.set_params(np.linspace(-0.5, 0.5, m.num_params()))
        _equal(m.target_and_dtarget(), eagerly(m.target_and_dtarget)())
        _equal(m.target_and_dtarget(), _autograd(m, gt.models.gpa.gpa_target))
    elif case == "hmc":
        _equal(_hmc_run(False), _hmc_run(True))
    elif case == "split":
        _equal(_split_run(False), _split_run(True))
    elif case == "ess":
        _equal(_ess_run(), eagerly(_ess_run)())
    elif case == "vi":
        _equal(_vi_run(), eagerly(_vi_run)())
    elif case == "elastic":
        _equal(_elastic_run(), eagerly(_elastic_run)())
    elif case == "cv":
        for call in CV_CALLS.values():
            _equal(call(_gpe(n=10)), eagerly(call)(_gpe(n=10)))
    elif case == "lbfgs":
        _equal(_lbfgs_run("gpa"), eagerly(_lbfgs_run)("gpa"))
    else:
        _equal(_fitc_run(), eagerly(_fitc_run)())


@pytest.mark.parametrize("case", ["headline", "headline_n300", "fix_and_mask", "gpa",
                                  "objective", "hmc", "split", "sharded_hmc",
                                  "sharded_split_hmc", "distributed", "ambient_hmc",
                                  "ess", "sharded_ess", "vi_adam", "vi_lbfgs", "elastic",
                                  *(f"cv_{k}" for k in CV_CALLS), "predict_f_gpe",
                                  "predict_f_gpa", "fitc_step", "sharded_fitc_step",
                                  "sharded_vi", "sharded_vi_train", "lbfgs_gpe", "lbfgs_gpa",
                                  "lbfgs_gpe_blocks_of_2"])
def test_capture_regions_read_nothing_from_the_host(case, monkeypatch):
    """Each region the layer captures runs with host reads refused; the
    regions run (a count) and give the unchecked run's bits. At n = 300 the
    backward's triangular inverse pads to two blocks."""
    regions = []

    def checked(owner, fn, *args, static=()):
        regions.append(static)
        return checked_run(owner, fn, *args)

    def run():
        if case in ("ess", "sharded_ess"):
            return _ess_run(sharded=case == "sharded_ess")
        if case.startswith("vi_"):
            return _vi_run("adam" if case == "vi_adam" else "lbfgs")
        if case == "elastic":
            return _elastic_run()
        if case.startswith("cv_"):
            return CV_CALLS[case[3:]](_gpe(n=10))
        if case.startswith("predict_f"):
            return _predict_run(case.split("_")[-1])
        if case.startswith("lbfgs_"):
            return _lbfgs_run(case.split("_")[1], 2 if case.endswith("_2") else 1)
        if case == "sharded_vi":
            r = gt.sharded_vi(_gpa(n=12), make_mesh({"chains": 1}, device="cpu"), restarts=2,
                              nits=3)
            return r.approx.m, r.approx.v, r.elbos
        if case == "sharded_vi_train":
            r = gt.sharded_vi_train(_gpa(n=12), make_mesh({"data": 1}, device="cpu"), nits=3)
            return r.approx.m, r.approx.v, r.elbo_trace
        if case.endswith("fitc_step"):
            return _fitc_run(sharded=case.startswith("sharded"))
        if case == "headline_n300":
            return _gpe(n=300).target_and_dtarget()
        if case == "distributed":
            m = _gpe(n=24)
            m.covstrat = DistributedFullCovariance(make_mesh({"j": 1}, device="cpu"), "j", 8)
            return m.target_and_dtarget()
        if case == "ambient_hmc":
            m = _gpa(n=16)
            pod = make_pod_mesh({"j": 1}, device="cpu")
            m.covstrat = AmbientFullCovariance(pod, B=8)
            lp, x0, _, _ = m.make_logprob()
            th = x0 + 0.05 * torch.as_tensor(np.random.RandomState(3).randn(2, x0.numel()))
            r = sharded_hmc(lp, th, 7, pod, n_iter=2, eps0=0.05, Lmin=2, Lmax=3)
            return r.samples, r.final_target
        if case in ("headline", "fix_and_mask"):
            kern = None if case == "headline" else (
                gt.fix(gt.SE(0.2, 0.1), "ll")
                + gt.Masked(gt.RQ(0.0, 0.1, 0.2), (0, 2)))
            return _gpe(kernel=kern).target_and_dtarget()
        if case == "gpa":
            return _gpa().target_and_dtarget()
        if case == "objective":
            vg, x0, _, _ = _gpe().make_objective(noise=False)
            return vg(x0 + 0.1)
        if case == "hmc":
            return _hmc_run(False)
        if case == "split":
            return _split_run(False)
        m = student_gpa()
        mesh = make_mesh(device="cpu")
        if case == "sharded_hmc":
            lp, x0, _, _ = m.make_logprob()
            th = x0 + 0.05 * torch.as_tensor(np.random.RandomState(3).randn(2, x0.numel()))
            r = sharded_hmc(lp, th, 7, mesh, n_iter=2, n_warmup=2, eps0=0.05, Lmin=2, Lmax=3)
            return r.samples, r.final_target, r.eps_final
        precompute, la, lb, a0, b0 = m.make_split_logprob()
        x0 = torch.cat([a0, b0])
        th = x0 + 0.05 * torch.as_tensor(np.random.RandomState(3).randn(2, x0.numel()))
        r = sharded_split_hmc(precompute, la, lb, th, 7, mesh, a0.numel(), n_iter=1, n_warmup=1,
                              a_iters=2, Lmin=2, Lmax=3)
        return r.samples, r.final_target, r.eps_a_final, r.eps_b_final

    plain = run()
    monkeypatch.setattr(graphs, "run", checked)
    _equal(run(), plain)
    assert regions


def student_gpa(n=8):
    """Configuration #5's Student-t GPA, cut to n points."""
    rng = np.random.RandomState(1)
    x = np.sort(2 * np.pi * rng.rand(n))
    y = np.sin(x) + 0.15 * rng.randn(n)
    m = gt.GPA(x, y, gt.MeanZero(), gt.SE(0.0, 0.0), gt.StuTLik(lsigma=-1.0, nu=3),
               device="cpu")
    m.set_priors(kern=[Normal(0.0, 2.0)] * 2, lik=[Normal(-1.0, 1.0)])
    return m


@pytest.fixture
def emulated(monkeypatch):
    """The layer's graph path on CPU tensors, its capture emulated: the
    warm-up and the captured call run as on the card, and a replay re-runs
    the function on the static input buffers, writing its outputs into the
    captured ones."""

    def capture(fn, args, device, pool):
        fn(*args)
        warm = graphs._snapshot()
        out = fn(*args)
        launches = graphs._delta(warm)
        held = []
        graphs._flatten(out, held)

        def replay():
            before = graphs._snapshot()
            new = []
            graphs._flatten(fn(*args), new)
            graphs._restore(before)
            for h, t in zip(held, new):
                h.copy_(t)

        return replay, out, launches

    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "_device", lambda leaves: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    graphs.clear()
    yield
    graphs.clear()


def test_emulated_graph_keys_and_copies(emulated):
    """New values replay the kept graph and give the eager bits; a new shape
    (`push`) or structure (`set_priors`) captures a graph of its own; `fit`
    with data of the same shape replays with the new data; outputs are
    copies the next replay leaves alone."""
    m = _gpe()
    eager = eagerly(m.target_and_dtarget)
    first = m.target_and_dtarget()
    _equal(first, eager())
    assert _kept(m) == 1
    m.set_params(m.get_params() + 0.05)
    again = m.target_and_dtarget()
    _equal(again, eager())
    assert not torch.equal(again[1], first[1])
    assert _kept(m) == 1
    rng = np.random.RandomState(9)
    m.fit(rng.randn(30, 3), rng.randn(30))
    _equal(m.target_and_dtarget(), eager())
    assert _kept(m) == 1
    m.push(rng.randn(4, 3), rng.randn(4))
    _equal(m.target_and_dtarget(), eager())
    assert _kept(m) == 2
    m.set_priors(noise=[Normal(-1.0, 1.0)])
    _equal(m.target_and_dtarget(), eager())
    assert _kept(m) == 3
    kept = m.target_and_dtarget()
    snapshot = [t.clone() for t in kept]
    m.set_params(m.get_params() - 0.1)
    m.target_and_dtarget()
    _equal(kept, snapshot)


def test_emulated_samplers_keep_their_graphs(emulated):
    """The samplers through emulated graphs give the eager bits, and keep
    their graphs for their log targets: a second run of the same target
    captures nothing."""
    _equal(_hmc_run(False), _hmc_run(True))
    m = _gpa()
    _equal(_split_run(False, 2, m), _split_run(True, 2, m))
    target = m.make_split_logprob()
    a, b = target[3][None].repeat(3, 1), target[4][None].repeat(3, 1)
    for _ in range(2):
        split_hmc(*target[:3], a, b, torch.Generator().manual_seed(0), n_iter=1, a_iters=2,
                  Lmin=2, Lmax=3)
        assert [_kept(f) for f in target[:3]] == [1, 2, 2]


def test_emulated_replays_count_one_evaluation_of_launches(emulated):
    """A function that counts a launch as the kernels' wrappers do: the
    first call (warm-up, capture, replay) and every later replay count one
    launch each; eager calls count theirs."""

    def counted(x):
        gram_op.LAUNCHES["gram"] += 1
        gram_op.LAUNCH_SHAPES["gram", 3, 3, False] += 1
        return x * 2.0

    x = torch.ones(3)
    base = gram_op.LAUNCHES["gram"], gram_op.LAUNCH_SHAPES["gram", 3, 3, False]
    for k in range(1, 4):
        assert torch.equal(graphs.run(counted, counted, x), 2.0 * x)
        assert (gram_op.LAUNCHES["gram"], gram_op.LAUNCH_SHAPES["gram", 3, 3, False]) == \
            (base[0] + k, base[1] + k)
    eagerly(graphs.run)(counted, counted, x)
    assert gram_op.LAUNCHES["gram"] == base[0] + 4


# every counter of launches a replay must add again: (module, name, a key)
COUNTERS = [(gram_op, "LAUNCHES", "gram_vjp"), (gram_op, "LAUNCH_SHAPES", ("gram", 5, 7, True)),
            (cholesky_kernels, "LAUNCHES", "chol_inv_panel"), (sparse, "QR_SHAPES", ("qr", 9, 3)),
            (sparse, "QR_ROUTES", ("cholqr3", 9, 3)), (leapfrog, "LAUNCHES", "leapfrog")]


@pytest.mark.parametrize("module, name, key", COUNTERS,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}.{n}" for m, n, _ in COUNTERS])
def test_emulated_replays_count_every_registered_counter(emulated, module, name, key):
    """Each counter is registered with the graph layer (`graphs.counted`),
    so the first call and every replay of a graph that adds to it count
    once each, as an eager call does."""
    c = getattr(module, name)
    assert any(r is c for r in graphs._COUNTERS)

    def adds(x):
        c[key] = c.get(key, 0) + 1
        return x + 1.0

    x = torch.ones(2)
    base = c.get(key, 0)
    for k in range(1, 4):
        assert torch.equal(graphs.run(adds, adds, x), x + 1.0)
        assert c[key] == base + k


def test_emulated_graph_keys_a_module_with_an_unhashable_static_field(emulated):
    """A distributed strategy's static mesh (a dataclass of dicts) keys its
    graph by identity: the same mesh replays, another captures anew."""
    m = _gpe(n=24)
    eager = eagerly(m.target_and_dtarget)
    mesh = make_mesh({"j": 1}, device="cpu")
    m.covstrat = DistributedFullCovariance(mesh, "j", 8)
    _equal(m.target_and_dtarget(), eager())
    m.target_and_dtarget()
    assert _kept(m) == 1
    m.covstrat = DistributedFullCovariance(make_mesh({"j": 1}, device="cpu"), "j", 8)
    _equal(m.target_and_dtarget(), eager())
    assert _kept(m) == 2


def test_the_layer_refuses_mixed_devices_and_unknown_arguments():
    with pytest.raises(TypeError, match="cannot take"):
        graphs.run(_gpe, lambda x: x, object())
    on = lambda d: types.SimpleNamespace(device=torch.device(d))  # noqa: E731
    assert graphs._device([on("cpu"), on("cpu")]) is None
    assert graphs._device([on("cuda:0")]) == torch.device("cuda:0")
    with pytest.raises(ValueError, match="one CUDA device"):
        graphs._device([on("cpu"), on("cuda:0")])


def test_emulated_graphs_go_with_their_model_and_the_pool_with_its_last_graph(emulated):
    """A model's graphs are kept for the model: dropping it drops them, its
    objective's and its target's, and the last graph of a pool takes the
    pool with it, so the next capture starts a new one."""
    m = _gpe()
    m.target_and_dtarget()
    vg, x0, _, _ = m.make_objective(noise=False)
    vg(x0 + 0.1)
    assert _kept(m) == 2
    pool = graphs._POOLS[None]
    assert pool.live == 2
    other = _gpe(seed=1)
    other.target_and_dtarget()
    assert pool.live == 3
    gone = weakref.ref(m)
    del m, vg
    gc.collect()
    assert gone() is None and pool.live == 1 and graphs._POOLS[None] is pool
    del other
    gc.collect()
    assert pool.live == 0 and None not in graphs._POOLS
    again = _gpe()
    again.target_and_dtarget()
    assert graphs._POOLS[None] is not pool and graphs._POOLS[None].live == 1


def test_emulated_owner_keeps_its_last_graphs(emulated):
    """An owner keeps its `PER_OWNER` most recently replayed graphs: a new
    shape past them drops the least recently replayed, which captures anew
    when it comes back; the pool counts the graphs kept."""
    calls = []

    def double(x):
        calls.append(x.shape[0])
        return 2.0 * x

    n = graphs.PER_OWNER
    for k in range(1, n + 1):
        graphs.run(double, double, torch.ones(k))
    graphs.run(double, double, torch.ones(1))  # 1 is now the most recent
    calls.clear()
    graphs.run(double, double, torch.ones(n + 1))  # drops 2
    assert _kept(double) == n and graphs._POOLS[None].live == n
    graphs.run(double, double, torch.ones(1))
    assert calls == [n + 1] * 3 + [1]  # warm-up, capture, replay; a replay
    calls.clear()
    graphs.run(double, double, torch.ones(2))
    assert calls == [2] * 3


def test_a_collective_is_refused_inside_a_capture(emulated):
    """A distributed strategy over an axis of two processes: outside a
    capture its collectives run (here up to the missing process group), and
    a capture, warm-up included, refuses the first one with the way round
    it, `graphs.eager()`."""
    mesh = make_mesh({"j": 1}, device="cpu")
    two = dataclasses.replace(mesh, shape={"j": 2}, groups={"j": object()})
    m = _gpe(n=32)
    m.covstrat = DistributedFullCovariance(two, "j", 8)
    with pytest.raises(RuntimeError, match=r"graphs\.eager\(\)"):
        m.target_and_dtarget()
    assert None not in graphs._POOLS  # the failed capture's pool is retired
    x = torch.ones(2)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        graphs.run(x, lambda t: collectives.allreduce_(t, two, "j"), x)
    with pytest.raises(Exception) as eager:  # no process group: gloo is not set up here
        eagerly(graphs.run)(x, lambda t: collectives.allreduce_(t, two, "j"), x)
    assert "cannot be captured" not in str(eager.value)


def test_emulated_later_paths_keep_their_graphs(emulated):
    """Through emulated graphs: VI's Adam step is captured once for the
    fit's objective and replayed for every step; the elastic model keeps one
    append graph for each (capacity, block size), whatever n; a second fold
    set of the same padded shape replays the model's fold graphs, one of
    another shape captures anew; the sampler keeps a start and a shrink
    graph for its log likelihood. Each gives the eager bits."""
    m = _gpa(n=12)
    neg_elbo, theta0, _ = make_neg_elbo(m)
    calls = []

    def counted(theta):
        calls.append(1)
        return neg_elbo(theta)

    theta, _ = gt.inference.vi.adam(counted, theta0, 5, 0.05)
    assert _kept(counted) == 1 and len(calls) == 2 + 5  # warm-up, capture, 5 replays
    assert torch.equal(theta, eagerly(gt.inference.vi.adam)(neg_elbo, theta0, 5, 0.05)[0])

    _equal(_elastic_run(), eagerly(_elastic_run)())
    rng = np.random.RandomState(8)
    e = ElasticGPE(2, kernel=gt.SE(0.1, 0.0), lognoise=-1.0, capacity=16, stepsize=8,
                   device="cpu", dtype=torch.float64)
    for i in range(5):  # n = 4, 8, 12, 16: three extensions in one bucket
        e.append(rng.randn(4, 2), rng.randn(4))
    assert _kept(e) == 1
    e.append(rng.randn(3, 2), rng.randn(3))  # a new capacity: a rebuild, no graph
    e.append(rng.randn(3, 2), rng.randn(3))  # a new (capacity, k)
    assert _kept(e) == 2

    g = _gpe(n=10)
    for call in CV_CALLS.values():
        _equal(call(g), eagerly(call)(g))
    kept = _kept(g)
    other = [[9, 8, 7], [6, 5], [4, 3, 2, 1, 0]]  # the same padded shape (3, 5)
    _equal([cv.logp_CVfold(g, other)], [eagerly(cv.logp_CVfold)(g, other)])
    assert _kept(g) == kept
    cv.logp_CVfold(g, [[0, 1], [2, 3]])
    assert _kept(g) == kept + 1

    m = _gpe(n=20)
    ll, x0, _, _ = m.make_logprob(include_priors=False)
    th = x0 + 0.1 * torch.as_tensor(np.random.RandomState(4).randn(3, x0.numel()))
    args = (ll, th, np.zeros(x0.numel()), np.full(x0.numel(), 2.0))
    r = ess(*args, torch.Generator().manual_seed(3), n_iter=3, rounds=1)
    e_ = eagerly(ess)(*args, torch.Generator().manual_seed(3), n_iter=3, rounds=1)
    _equal((r.samples, r.final_loglik), (e_.samples, e_.final_loglik))
    assert _kept(ll) == 2


def test_emulated_lbfgs_keeps_a_start_and_a_block_graph(emulated, monkeypatch):
    """method='optax' through emulated graphs: the model keeps two graphs,
    the iteration's start and a block of trials, captured in the first
    iteration that needs each and replayed after; the model's data are
    inputs of them, so a run on new data of the same shape replays them
    and gives the eager bits."""
    captures = []
    capture = graphs._capture
    monkeypatch.setattr(graphs, "_capture", lambda *a: captures.append(a) or capture(*a))
    m = _gpe()
    vg, x0, _, _ = m.make_objective()
    trace = []
    r = lbfgs.minimize(vg, x0, 6, trace=trace)
    assert max(int(step.search.count) for _, step in trace) > 1  # a block ran
    assert _kept(m) == 2 and len(captures) == 2
    e = eagerly(lbfgs.minimize)(vg, x0, 6)
    _equal([r.x, r.value, r.trials], [e.x, e.value, e.trials])
    other = _gpe(seed=1)
    m.fit(other.x, other.y)
    vg, x0, _, _ = m.make_objective()
    r = lbfgs.minimize(vg, x0, 6)
    e = eagerly(lbfgs.minimize)(vg, x0, 6)
    assert len(captures) == 2 and _kept(m) == 2
    _equal([r.x, r.value, r.trials], [e.x, e.value, e.trials])
