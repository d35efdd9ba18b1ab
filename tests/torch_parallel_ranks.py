"""One rank of a gloo job on the CPU that runs the port's distributed dense
and sparse paths (imported by tests/test_torch_parallel_ranks.py, which
starts it as a process and runs the same problems on one process):

    python tests/torch_parallel_ranks.py RANK WORLD INIT_FILE OUT_DIR

It joins a job of WORLD = 4 processes through a `file://` rendezvous and
runs, f64:
  * on make_mesh({'j': 4}): the gradients through each differentiable
    collective, the dense GPE target and its gradient through
    DistributedFullCovariance at B = 4 (16 tiles) and B = 8 (8 tiles), the
    heteroscedastic case, a non-PD K, the GPA target's gradient through
    the latent map, and untile of the factor;
  * on make_mesh({'data': 4}): ring_gram and its gradient, the sharded
    FITC mll and gradient, sharded_elbo and its gradient, and 20 steps of
    sharded_vi_train;
  * on make_pod_mesh({'j': 2}) (axes ('chains', 'j') of sizes (2, 2)):
    sharded_hmc over AmbientFullCovariance;
  * sharded_ess over 'chains' of make_mesh() (P = 4) and of the pod mesh
    (P = 2);
  * the bytes and calls of the collectives on each path of
    `perf/comm_model.py` (`measure_paths`, its own meshes of size 4);
  * the regions the CUDA graph layer would capture (`utils/graphs.py`),
    run with host reads refused (tests/host_reads.py): the dense GPE and
    GPA targets at P = 4 ('j' of make_mesh) and P = 2 ('j' of the pod
    mesh), sharded_hmc over AmbientFullCovariance at P = 2 and sharded_ess
    at P = 4 and 2, each beside its unchecked run;
and saves what this rank computed to OUT_DIR/rank{RANK}.npz.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import gaussianprocesses_jl_tpu_torch as gp  # noqa: E402
from gaussianprocesses_jl_tpu_torch.models.gpa import gpa_target  # noqa: E402
from gaussianprocesses_jl_tpu_torch.models.gpe import gpe_target  # noqa: E402
from gaussianprocesses_jl_tpu_torch.parallel import (  # noqa: E402
    chains, cholesky, collectives, fitc, mesh, vi)
from gaussianprocesses_jl_tpu_torch.parallel.collectives import gather_, psum  # noqa: E402
from gaussianprocesses_jl_tpu_torch.parallel.dense import AmbientFullCovariance  # noqa: E402
from gaussianprocesses_jl_tpu_torch.perf import comm_model  # noqa: E402
from gaussianprocesses_jl_tpu_torch.utils import graphs  # noqa: E402
from host_reads import checked_run  # noqa: E402

N_DENSE, N_GPA, N_RING, N_FITC, N_VI, N_HMC = 64, 64, 64, 1600, 48, 32
HMC_KW = dict(n_iter=6, n_warmup=4, eps0=0.05, Lmin=2, Lmax=4)
HMC_CHAINS, HMC_SEED = 4, 3
ESS_CHAINS, ESS_SEED, ESS_KW = 8, 11, dict(n_iter=3, rounds=2)
VI_STEPS = 20


def dense_data(seed, n=N_DENSE, d=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    return X, np.sin(X[:, 0]) + 0.2 * rng.randn(n)


def dense_model(covstrat=None):
    """The composite GPE of the JAX test of the distributed mll."""
    X, y = dense_data(3)
    kern = gp.SE(0.2, 0.1) * gp.RQ(0.1, 0.0, 0.3) + gp.Matern(1.5, 0.0, -0.5)
    return gp.GPE(X, y, gp.MeanLin(beta=np.array([0.1, -0.2, 0.05])), kern, lognoise=-0.7,
                  covstrat=covstrat, device="cpu")


def hetero_params():
    """(params, X, y) with a heteroscedastic lognoise vector."""
    X, y = dense_data(9)
    ln = 0.1 * np.random.RandomState(10).randn(N_DENSE) - 0.5
    params = gp.GPEParams(lognoise=gp.Param(value=torch.as_tensor(ln)), mean=gp.MeanZero(),
                          kernel=gp.SE(0.0, 0.0))
    return params, torch.as_tensor(X), torch.as_tensor(y)


def gpa_model(covstrat=None):
    rng = np.random.RandomState(31)
    X = rng.randn(N_GPA, 2)
    y = (np.sin(X[:, 0]) + 0.3 * rng.randn(N_GPA) > 0).astype(float)
    m = gp.GPA(X, y, gp.MeanConst(beta=0.1), gp.Matern(1.5, np.zeros(2), 0.1), gp.BernLik(),
               covstrat=covstrat, device="cpu")
    v = torch.as_tensor(0.3 * np.random.RandomState(32).randn(N_GPA))
    m.params = m.params.with_flat_params(torch.cat([v, m.params.flat_params()[N_GPA:]]))
    return m


def value_grad(fn, vec):
    vec = vec.detach().clone().requires_grad_()
    val = fn(vec)
    (g,) = torch.autograd.grad(val, vec)
    return val.detach().numpy(), g.numpy()


def gpe_value_grad(m):
    return value_grad(lambda v: gpe_target(m.params.with_flat_params(v), m.x, m.y,
                                           m.covstrat)[0], m.params.flat_params())


def gpa_value_grad(m):
    return value_grad(lambda v: gpa_target(m.params.with_flat_params(v), m.x, m.y,
                                           m.covstrat)[0], m.params.flat_params())


def hetero_value_grad(covstrat):
    params, X, y = hetero_params()
    return value_grad(lambda v: gpe_target(params.with_flat_params(v), X, y, covstrat)[0],
                      params.flat_params())


def nonpd_target(covstrat):
    X, y = dense_data(12)
    params = gp.GPEParams(lognoise=gp.Param(value=torch.tensor(-200.0)), mean=gp.MeanZero(),
                          kernel=gp.Const(20.0))
    return gpe_target(params, torch.as_tensor(X), torch.as_tensor(y), covstrat)[0].numpy()


def ring_problem():
    X, y = dense_data(14, N_RING)
    return gp.SE(0.1, 0.2) + gp.Periodic(0.0, 0.0, 0.5), torch.as_tensor(X), torch.as_tensor(y)


def ring_loss(kern, X_loc, y_loc, y, m):
    """psum over the axis of sum(K_loc * y_loc y^T): the replicated sum(K * y y^T)."""
    K_loc = gp.ring_gram(kern, X_loc, m, "data")
    return psum(torch.sum(K_loc * torch.outer(y_loc, y)), m, "data"), K_loc


def fitc_problem():
    """The JAX test's FITC model: (fitc GPE, X, y, Xu), N = 1600, 16 inducing points."""
    rng = np.random.RandomState(1)
    x = 2 * np.pi * rng.rand(N_FITC)
    y = np.sin(x) + 0.3 * rng.randn(N_FITC)
    ind = np.linspace(0, 2 * np.pi, 16)
    m = gp.FITC(x, ind, y, kernel=gp.SE(0.3, 0.1), lognoise=-0.6, device="cpu")
    return m, m.x, m.y, m.covstrat.inducing


def fitc_value_grad(m_fitc, X_loc, y_loc, Xu, mm):
    fn = fitc.fitc_mll_sharded_fn(m_fitc.params.kernel, mm)
    return value_grad(lambda v: fn(m_fitc.params.with_flat_params(v), X_loc, y_loc, Xu),
                      m_fitc.params.flat_params())


def vi_model():
    """The JAX VI tests' Poisson GPA (n = 48)."""
    rng = np.random.RandomState(3)
    t = np.linspace(0, 10, N_VI)
    y = rng.poisson(np.exp(1.0 + 0.7 * np.sin(t))).astype(float)
    return gp.GPA(t[:, None], y, gp.MeanZero(), gp.Matern(1.5, 0.0, 0.0), gp.PoisLik(),
                  device="cpu")


def vi_point():
    rng = np.random.RandomState(0)
    return (torch.as_tensor(0.5 + 0.3 * rng.randn(N_VI)),
            torch.as_tensor(np.exp(0.5 * rng.randn(N_VI))))


def elbo_value_grad(m, mm, axis="data"):
    fn = vi.sharded_elbo_fn(m, mm, axis)
    mv, vv = vi_point()
    mv, vv = mv.requires_grad_(), vv.requires_grad_()
    val = fn(mv, vv)
    gm, gv = torch.autograd.grad(val, (mv, vv))
    return val.detach().numpy(), gm.numpy(), gv.numpy()


def hmc_problem(covstrat=None):
    """(logprob, theta0 (C, D)) of the chains x j run: the JAX test's GPE at n = 32."""
    rng = np.random.RandomState(0)
    X = rng.randn(N_HMC, 2)
    y = np.sin(X[:, 0]) + 0.3 * rng.randn(N_HMC)
    m = gp.GPE(X, y, kernel=gp.SE(0.0, 0.0), lognoise=-1.0, covstrat=covstrat, device="cpu")
    logprob, x0, _, _ = m.make_logprob()
    return logprob, x0 + 0.05 * torch.as_tensor(np.random.RandomState(5).randn(HMC_CHAINS,
                                                                               x0.numel()))


def ess_problem():
    """(loglik, theta0 (C, 3), prior mu, prior sigma) of the sharded_ess
    runs: configuration #5's GPE counterpart at n = 12."""
    from gaussianprocesses_jl_tpu_torch.perf import student_t_study as st

    loglik, x0, _, _ = st.config5_gpe("cpu", np.float64, 12).make_logprob(include_priors=False)
    theta0 = x0 + 0.05 * torch.as_tensor(np.random.RandomState(6).randn(ESS_CHAINS, 3))
    return loglik, theta0, st.PRIOR_MU, st.PRIOR_SIGMA


def ess_run(m):
    """sharded_ess of `ess_problem` over m's 'chains' axis: [samples, final
    log likelihoods, mean proposals]."""
    r = chains.sharded_ess(*ess_problem(), ESS_SEED, m, **ESS_KW)
    return [r.samples, r.final_loglik, r.mean_proposals]


def collective_grads(m, axis):
    """The gradients of replicated losses through each differentiable
    collective on this process: copy (the sum of the shares, through a
    psum), all_gather (its own slice), ppermute (shifted back) and
    broadcast (the owner's only)."""
    me = m.coords[axis]
    theta = torch.tensor([1.0, -2.0], dtype=torch.float64, requires_grad=True)
    x = torch.arange(3.0, dtype=torch.float64).add(10.0 * me).requires_grad_()
    a = torch.tensor([me + 1.0, 2.0 * me], dtype=torch.float64)
    w = torch.linspace(0.5, 2.0, 3 * m.shape[axis], dtype=torch.float64)
    losses = {
        "copy": (psum(torch.sum(collectives.copy(theta, m, axis) * a), m, axis), theta),
        "all_gather": (torch.sum(collectives.all_gather(x, m, axis) * w), x),
        "ppermute": (psum(torch.sum(collectives.ppermute(x, m, axis) * (me + 1.0)), m, axis), x),
        "broadcast": (torch.sum(collectives.broadcast(x, m, axis, 1) ** 2), x),
    }
    return {f"coll_{k}": torch.autograd.grad(loss, wrt)[0].numpy()
            for k, (loss, wrt) in losses.items()}


HOST_READ_CASES = ("dense_P4", "gpa_P4", "dense_P2", "ambient_hmc_P2", "ess_P4", "ess_P2")


def host_read_case(case, mj, pod):
    """The numbers of one case, every graph region run as the layer calls it."""
    if case.startswith("ess"):
        return ess_run(mesh.make_mesh(device="cpu") if case == "ess_P4" else pod)
    if case == "ambient_hmc_P2":
        logprob, theta0 = hmc_problem(AmbientFullCovariance(pod, B=4))
        h = chains.sharded_hmc(logprob, theta0, HMC_SEED, pod, n_iter=2, n_warmup=1, eps0=0.05,
                               Lmin=2, Lmax=3)
        return [h.samples, h.final_target]
    m_j = mj if case.endswith("P4") else pod
    cs = gp.DistributedFullCovariance(m_j, "j", 4)
    m = dense_model(cs) if case.startswith("dense") else gpa_model(cs)
    return list(m.target_and_dtarget())


def host_read_checks(mj, pod) -> dict:
    """Each case unchecked, then with `graphs.run` replaced by the check:
    {case_plain_k, case_checked_k: arrays, case_refused: the check's
    message, or ''}. Every rank reads the host at the same point, if any,
    so all raise together and no collective is left waiting."""
    out = {}
    for case in HOST_READ_CASES:
        for k, t in enumerate(host_read_case(case, mj, pod)):
            out[f"{case}_plain_{k}"] = t.numpy()
        run, graphs.run = graphs.run, checked_run
        try:
            for k, t in enumerate(host_read_case(case, mj, pod)):
                out[f"{case}_checked_{k}"] = t.numpy()
            out[f"{case}_refused"] = np.asarray("")
        except AssertionError as e:
            out[f"{case}_refused"] = np.asarray(str(e))
        finally:
            graphs.run = run
    return out


def main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)  # the ranks share the machine's cores
    mesh.initialize_distributed(f"file://{init_file}", world, rank)
    out = {}
    try:
        mj = mesh.make_mesh({"j": world}, device="cpu")
        out.update(collective_grads(mj, "j"))
        for B in (4, 8):
            out[f"dense_B{B}_value"], out[f"dense_B{B}_grad"] = gpe_value_grad(
                dense_model(gp.DistributedFullCovariance(mj, B=B)))
        out["hetero_value"], out["hetero_grad"] = hetero_value_grad(
            gp.DistributedFullCovariance(mj, B=4))
        out["nonpd"] = nonpd_target(gp.DistributedFullCovariance(mj, B=4))
        out["gpa_value"], out["gpa_grad"] = gpa_value_grad(
            gpa_model(gp.DistributedFullCovariance(mj, B=4)))
        K = torch.as_tensor(dense_data(1)[0] @ dense_data(1)[0].T) + N_DENSE * torch.eye(N_DENSE)
        L_tiles, logdet = cholesky.distributed_cholesky(cholesky.tile_and_shard(K, 8, mj), mj)
        out["chol_L"] = cholesky.untile(L_tiles, 8, mj).numpy()
        out["chol_logdet"] = logdet.numpy()

        md = mesh.make_mesh({"data": world}, device="cpu")
        kern, X, y = ring_problem()
        (X_loc, y_loc) = fitc.shard_data(X, y, md)
        vec = kern.flat_params().detach().requires_grad_()
        loss, K_loc = ring_loss(kern.with_flat_params(vec), X_loc, y_loc, y, md)
        (g,) = torch.autograd.grad(loss, vec)
        out["ring_K"] = gather_(K_loc.detach(), md, "data").numpy()
        out["ring_loss"], out["ring_grad"] = loss.detach().numpy(), g.numpy()
        m_fitc, Xf, yf, Xu = fitc_problem()
        Xf_loc, yf_loc = fitc.shard_data(Xf, yf, md)
        out["fitc_value"], out["fitc_grad"] = fitc_value_grad(m_fitc, Xf_loc, yf_loc, Xu, md)
        m_vi = vi_model()
        out["elbo_value"], out["elbo_grad_m"], out["elbo_grad_v"] = elbo_value_grad(m_vi, md)
        res = vi.sharded_vi_train(m_vi, md, nits=VI_STEPS, lr=0.05)
        out["vi_train_m"], out["vi_train_v"] = res.approx.m.numpy(), res.approx.v.numpy()
        out["vi_train_trace"] = res.elbo_trace.numpy()

        pod = mesh.make_pod_mesh({"j": 2}, device="cpu")
        logprob, theta0 = hmc_problem(AmbientFullCovariance(pod, B=4))
        h = chains.sharded_hmc(logprob, theta0, HMC_SEED, pod, **HMC_KW)
        out["hmc_samples"], out["hmc_final_target"] = h.samples.numpy(), h.final_target.numpy()
        out["pod"] = np.asarray([pod.shape["chains"], pod.shape["j"], pod.coords["chains"],
                                 pod.coords["j"]])
        for P, m in ((4, mesh.make_mesh(device="cpu")), (2, pod)):
            for k, t in zip(("samples", "final_loglik", "mean_proposals"), ess_run(m)):
                out[f"ess_P{P}_{k}"] = t.numpy()
        out["comm"] = np.asarray(json.dumps(comm_model.measure_paths(world)))
        out.update(host_read_checks(mj, pod))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
