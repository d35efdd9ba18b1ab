"""The port's distributed paths over 4 gloo processes on the CPU, against the
same port on one process and the JAX package on 4 devices, f64.

One job of 4 processes (`tests/torch_parallel_ranks.py`, rendezvous
through a `file://` in tmp_path) runs the dense target over
make_mesh({'j': 4}), the ring gram, FITC and VI over make_mesh({'data': 4}),
and chains x j over make_pod_mesh({'j': 2}). At P = 1 every collective is
the identity, so a wrong gradient rule of a collective (an all-reduce whose
backward all-reduces again, a missing sum of the shard-local shares) shows
only here: every rank must give the whole gradient of the replicated loss.

Tolerances, stated at each assertion: against one process rtol 1e-10 (the
same arithmetic, summed in another order; the dense mll's tiles are
distributed, so against the dense strategy the JAX tests' rtol 1e-9 for
values and 1e-6 for gradients); against the JAX package the tolerances of
test_torch_parallel_dense.py and test_torch_parallel_sharded.py; chains x j
against the single-axis dense run atol 1e-6 (the JAX test's)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.models.gpe import gpe_target as j_gpe_target
from gaussianprocesses_jl_tpu.parallel import vi as jvi
from gaussianprocesses_jl_tpu.parallel.fitc import fitc_mll_sharded_fn as j_fitc_fn
from gaussianprocesses_jl_tpu.parallel.fitc import shard_data as j_shard_data
from gaussianprocesses_jl_tpu.parallel.mesh import make_mesh as j_make_mesh
from gaussianprocesses_jl_tpu_torch.parallel import chains, vi as tvi
from gaussianprocesses_jl_tpu_torch.perf import comm_model

import torch_parallel_ranks as R

WORLD = 4


def _close(got, ref, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(ref, dtype=float),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's saved results, after one job of 4 gloo processes."""
    out = tmp_path_factory.mktemp("ranks")
    script = os.path.join(os.path.dirname(__file__), "torch_parallel_ranks.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(WORLD),
                               str(out / "rendezvous"), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _each(ranks, key, ref, rtol=0.0, atol=0.0):
    for got in ranks:
        _close(got[key], ref, rtol=rtol, atol=atol)


def _jmesh(axis):
    return j_make_mesh({axis: WORLD}, devices=jax.devices()[:WORLD])


def test_collective_gradients_over_four_processes(ranks):
    """Each rank's gradient of a replicated loss through each collective:
    copy gives the sum of every rank's share, all_gather this rank's slice,
    ppermute the next rank's weight, broadcast the owner alone."""
    shares = sum(np.array([r + 1.0, 2.0 * r]) for r in range(WORLD))
    w = np.linspace(0.5, 2.0, 3 * WORLD)
    for r, got in enumerate(ranks):
        _close(got["coll_copy"], shares, rtol=1e-15)
        _close(got["coll_all_gather"], w[3 * r:3 * r + 3], rtol=1e-15)
        _close(got["coll_ppermute"], np.full(3, (r + 1) % WORLD + 1.0), rtol=1e-15)
        _close(got["coll_broadcast"], 2 * (np.arange(3.0) + 10.0) if r == 1 else np.zeros(3),
               rtol=1e-15)


@pytest.mark.parametrize("B", [4, 8])
def test_dense_mll_over_four_processes(ranks, B):
    """The composite GPE target on DistributedFullCovariance over 'j' = 4
    (16 tiles at B = 4, 8 at B = 8): the one-process port's dense target
    and the JAX package's distributed one on 4 devices."""
    v1, g1 = R.gpe_value_grad(R.dense_model())
    _each(ranks, f"dense_B{B}_value", v1, rtol=1e-9)
    _each(ranks, f"dense_B{B}_grad", g1, rtol=1e-6, atol=1e-9 * np.abs(g1).max())
    X, y = R.dense_data(3)
    pj = gj.GPEParams(lognoise=gj.Param(value=jnp.asarray(-0.7)),
                      mean=gj.MeanLin(beta=jnp.asarray([0.1, -0.2, 0.05])),
                      kernel=gj.SE(0.2, 0.1) * gj.RQ(0.1, 0.0, 0.3) + gj.Matern(1.5, 0.0, -0.5))
    cs = gj.DistributedFullCovariance(mesh=_jmesh("j"), B=B)
    vj, gj_ = jax.jit(jax.value_and_grad(lambda v: j_gpe_target(
        pj.with_flat_params(v), jnp.asarray(X), jnp.asarray(y), cs)[0]))(pj.flat_params())
    _each(ranks, f"dense_B{B}_value", float(vj), rtol=1e-9)
    _each(ranks, f"dense_B{B}_grad", np.asarray(gj_), rtol=1e-6,
          atol=1e-9 * np.abs(np.asarray(gj_)).max())


def test_heteroscedastic_mll_over_four_processes(ranks):
    v1, g1 = R.hetero_value_grad(gt.DistributedFullCovariance(gt.make_mesh({"j": 1},
                                                                          device="cpu"), B=4))
    _each(ranks, "hetero_value", v1, rtol=1e-10)
    _each(ranks, "hetero_grad", g1, rtol=1e-10, atol=1e-12)


def test_nonpd_over_four_processes(ranks):
    """A non-PD K gives -inf on every rank (the failing tile has one owner;
    `ok` is the AND over the axis)."""
    for got in ranks:
        assert np.isneginf(got["nonpd"])


def test_gpa_latent_gradient_over_four_processes(ranks):
    v1, g1 = R.gpa_value_grad(R.gpa_model())
    _each(ranks, "gpa_value", v1, rtol=1e-10)
    _each(ranks, "gpa_grad", g1, rtol=1e-6, atol=1e-9 * np.abs(g1).max())


def test_factor_over_four_processes(ranks):
    X = R.dense_data(1)[0]
    K = X @ X.T + R.N_DENSE * np.eye(R.N_DENSE)
    ref = np.linalg.cholesky(K)
    _each(ranks, "chol_L", ref, atol=1e-10 * np.abs(ref).max())
    _each(ranks, "chol_logdet", np.linalg.slogdet(K)[1], rtol=1e-12)


def test_ring_gram_over_four_processes(ranks):
    """The gathered block-rows are k(X, X) (atol 1e-12), and the gradient of
    the replicated sum(K y y^T) is the one-process gradient (rtol 1e-10)."""
    kern, X, y = R.ring_problem()
    ref = kern.gram(X).numpy()
    _each(ranks, "ring_K", ref, atol=1e-12)
    vec = kern.flat_params().clone().requires_grad_()
    loss, _ = R.ring_loss(kern.with_flat_params(vec), X, y, y, gt.make_mesh({"data": 1},
                                                                         device="cpu"))
    (g,) = torch.autograd.grad(loss, vec)
    _each(ranks, "ring_loss", float(loss), rtol=1e-12)
    _each(ranks, "ring_grad", g.numpy(), rtol=1e-10)


def test_sharded_fitc_over_four_processes(ranks):
    """The sharded FITC mll and gradient over 'data' = 4: the port's FITC
    model (rtol 1e-6 / 1e-4, the JAX test's), one process's sharded mll
    (rtol 1e-10) and the JAX package's on 4 devices (1e-10 / 1e-6)."""
    m, X, y, Xu = R.fitc_problem()
    v1, g1 = R.fitc_value_grad(m, X, y, Xu, gt.make_mesh({"data": 1}, device="cpu"))
    _each(ranks, "fitc_value", v1, rtol=1e-10)
    _each(ranks, "fitc_grad", g1, rtol=1e-10, atol=1e-10)
    _, g_model = m.target_and_dtarget()
    _each(ranks, "fitc_value", float(m.mll), rtol=1e-6)
    _each(ranks, "fitc_grad", g_model.numpy(), rtol=1e-4, atol=1e-7)
    rng = np.random.RandomState(1)
    x = 2 * np.pi * rng.rand(R.N_FITC)
    yy = np.sin(x) + 0.3 * rng.randn(R.N_FITC)
    mj = gj.FITC(x, np.linspace(0, 2 * np.pi, 16), yy, kernel=gj.SE(0.3, 0.1), lognoise=-0.6)
    jm = _jmesh("data")
    Xs, ys = j_shard_data(jnp.asarray(x)[:, None], jnp.asarray(yy), jm)
    fn = j_fitc_fn(mj.params.kernel, jm)
    vj, gj_ = jax.jit(jax.value_and_grad(lambda v: fn(
        mj.params.with_flat_params(v), Xs, ys, mj.covstrat.inducing)))(mj.params.flat_params())
    _each(ranks, "fitc_value", float(vj), rtol=1e-10)
    _each(ranks, "fitc_grad", np.asarray(gj_), rtol=1e-6, atol=1e-10)


def test_sharded_elbo_over_four_processes(ranks):
    v1, gm1, gv1 = R.elbo_value_grad(R.vi_model(), gt.make_mesh({"data": 1}, device="cpu"))
    _each(ranks, "elbo_value", v1, rtol=1e-10)
    _each(ranks, "elbo_grad_m", gm1, rtol=1e-10, atol=1e-12)
    _each(ranks, "elbo_grad_v", gv1, rtol=1e-10, atol=1e-12)


def test_sharded_vi_train_over_four_processes(ranks):
    """20 Adam steps on the sharded ELBO over 'data' = 4: one process's run
    (rtol 1e-10) and the JAX package's on 4 devices (trace rtol 1e-8)."""
    m = R.vi_model()
    res = tvi.sharded_vi_train(m, gt.make_mesh({"data": 1}, device="cpu"), nits=R.VI_STEPS)
    _each(ranks, "vi_train_m", res.approx.m.numpy(), rtol=1e-10, atol=1e-12)
    _each(ranks, "vi_train_v", res.approx.v.numpy(), rtol=1e-10)
    _each(ranks, "vi_train_trace", res.elbo_trace.numpy(), rtol=1e-10)
    rng = np.random.RandomState(3)
    t = np.linspace(0, 10, R.N_VI)
    y = rng.poisson(np.exp(1.0 + 0.7 * np.sin(t))).astype(float)
    mj = gj.GPA(t[:, None], y, gj.MeanZero(), gj.Matern(1.5, 0.0, 0.0), gj.PoisLik())
    rj = jvi.sharded_vi_train(mj, _jmesh("data"), nits=R.VI_STEPS, lr=0.05)
    _each(ranks, "vi_train_trace", np.asarray(rj.elbo_trace), rtol=1e-8)


def test_chains_x_j_over_four_processes(ranks):
    """sharded_hmc over AmbientFullCovariance on the pod mesh ('chains',
    'j') = (2, 2): the draws of the single-axis run on the dense target in
    one process (atol 1e-6, the JAX test's), every rank the same."""
    logprob, theta0 = R.hmc_problem()
    ref = chains.sharded_hmc(logprob, theta0, R.HMC_SEED, gt.make_mesh(device="cpu"),
                             **R.HMC_KW)
    _each(ranks, "hmc_samples", ref.samples.numpy(), atol=1e-6)
    _each(ranks, "hmc_final_target", ref.final_target.numpy(), rtol=1e-8)
    assert sorted(tuple(got["pod"][2:]) for got in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for got in ranks:
        assert tuple(got["pod"][:2]) == (2, 2)


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_ess_over_processes_gives_the_bits_of_one(ranks, P):
    """sharded_ess over 'chains' of 2 and 4 processes, shrink rounds in
    blocks of 2 (a process runs blocks while its own chains shrink): the
    bits of one process's run, on every rank."""
    ref = chains.sharded_ess(*R.ess_problem(), R.ESS_SEED, gt.make_mesh(device="cpu"),
                             **R.ESS_KW)
    for got in ranks:
        for k in ("samples", "final_loglik", "mean_proposals"):
            np.testing.assert_array_equal(got[f"ess_P{P}_{k}"], getattr(ref, k).numpy())


# The traffic of each path of perf/comm_model.py over 4 processes, f32, as
# parallel/collectives.py counts it (bytes of the reduced tensor, the
# gathered output, the broadcast tensor, the shifted block). Three follow
# from the shapes alone: the ring gram shifts its (n/P, d) block P - 1
# times; FITC all-gathers P (m + 1)^2 R factors; the ELBO all-reduces the
# shares of m's and v's gradients (n each) and one scalar sum.
COMM_P4 = {
    "sharded_hmc": {"gather": {"count": 32, "bytes": 5760}},
    "sharded_split_hmc": {"gather": {"count": 13, "bytes": 12384}},
    "distributed_cholesky_vg": {"allreduce": {"count": 12, "bytes": 1040},
                                "broadcast": {"count": 24, "bytes": 327680},
                                "gather": {"count": 1, "bytes": 1024},
                                "shift": {"count": 3, "bytes": 196608}},
    "sharded_fitc_vg": {"allreduce": {"count": 6, "bytes": 16404},
                        "gather": {"count": 1, "bytes": WORLD * 65 * 65 * 4}},
    "sharded_elbo_vg": {"allreduce": {"count": 3, "bytes": 2 * 512 * 4 + 4}},
    "ring_gram": {"shift": {"count": WORLD - 1, "bytes": (WORLD - 1) * (512 // WORLD) * 4 * 4}},
}


@pytest.mark.parametrize("case", R.HOST_READ_CASES)
def test_capture_regions_read_nothing_from_the_host_over_processes(ranks, case):
    """The regions the graph layer captures, at P = 4 and 2: no host read
    and no copy of host data on any rank, and the same bits as the
    unchecked run."""
    for got in ranks:
        assert str(got[f"{case}_refused"]) == ""
        plain = sorted(k for k in got if k.startswith(f"{case}_plain_"))
        assert plain
        for key in plain:
            np.testing.assert_array_equal(got[key.replace("_plain_", "_checked_")], got[key])


@pytest.mark.parametrize("path", comm_model.PATHS)
def test_collective_bytes_over_four_processes(ranks, path):
    """The bytes and calls each rank handed to torch.distributed on one
    path: the same on every rank, and those above."""
    got = [json.loads(str(r["comm"]))[path]["ops"] for r in ranks]
    assert all(g == got[0] for g in got[1:])
    assert got[0] == COMM_P4[path]
