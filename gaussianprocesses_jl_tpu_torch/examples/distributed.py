"""Distributed inference: every `parallel/` entry point on a process mesh
(the JAX repo's `examples/distributed.py`).

    python -m gaussianprocesses_jl_tpu_torch.examples.distributed [--device cpu] [--depth 1.0]
    torchrun --nproc_per_node 4 -m gaussianprocesses_jl_tpu_torch.examples.distributed --device cpu

One process runs every part with axes of size 1, as the JAX bench runs them
on one device; under `torchrun` the processes form the mesh (gloo for CPU
tensors). `--depth` scales every optimizer and sampler count (at least 1
each).

  1. an exact GPE whose gram is tile-column sharded over 'j'
     (`DistributedFullCovariance`): build, factor, optimize, predict;
  2. chain-sharded HMC with collective step-size and mass adaptation
     (`sharded_hmc`), with cross-chain split R-hat and ESS;
  3. the observation-sharded FITC mll and its gradient
     (`fitc_mll_sharded_fn`);
  4. a Bernoulli GPA on the same sharded dense covariance, its gradient
     through the distributed factor, and plain HMC over [v; hypers];
  5. chains x j: `sharded_hmc` over the distributed dense target on a
     ('chains', 'j') pod mesh (needs two processes or more);
  6. the chain-sharded split sampler with per-block adaptation.
"""
import sys

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.examples import generator, parser, say, world
from gaussianprocesses_jl_tpu_torch.inference.diagnostics import (
    effective_sample_size,
    split_rhat,
)
from gaussianprocesses_jl_tpu_torch.inference.hmc import hmc
from gaussianprocesses_jl_tpu_torch.parallel.chains import sharded_hmc, sharded_split_hmc
from gaussianprocesses_jl_tpu_torch.parallel.dense import AmbientFullCovariance
from gaussianprocesses_jl_tpu_torch.parallel.fitc import fitc_mll_sharded_fn, shard_data
from gaussianprocesses_jl_tpu_torch.parallel.mesh import make_mesh, make_pod_mesh

__all__ = ["dense_data", "distributed_dense", "sharded_chains", "fitc_data", "sharded_fitc",
           "distributed_gpa", "chains_x_j", "sharded_split", "main"]


def _it(n: int, depth: float) -> int:
    return max(1, round(n * depth))


def dense_data(P: int):
    rng = np.random.RandomState(0)
    n, d = 64 * P, 3
    X = rng.randn(n, d)
    return X, np.sin(X[:, 0]) + 0.5 * np.cos(X[:, 1]) + 0.1 * rng.randn(n), rng


def distributed_dense(P: int, device, depth: float = 1.0) -> dict:
    """Exact GPE on a gram sharded over the 'j' tile-column axis."""
    X, y, rng = dense_data(P)
    m = gp.GPE(X, y, kernel=gp.SE(0.0, 0.0), lognoise=-1.0, device=device,
               covstrat=gp.DistributedFullCovariance(make_mesh({"j": P}, device=device)))
    mll0 = float(m.mll)
    m.optimize(maxiter=_it(20, depth))
    mu, var = m.predict_f(rng.randn(16, X.shape[1]))
    say(f"[dense/{P}-mesh] n={X.shape[0]}: mll {mll0:.2f} -> {float(m.mll):.2f}, "
          f"pred var range [{float(var.min()):.4f}, {float(var.max()):.4f}]")
    return {"mll0": mll0, "mll": float(m.mll), "var": var.cpu().numpy()}


def sharded_chains(P: int, device, depth: float = 1.0) -> dict:
    """HMC chains over the 'chains' axis with collective step-size and
    mass-matrix warm-up."""
    rng = np.random.RandomState(1)
    x = rng.randn(32, 2)
    y = np.sin(x[:, 0]) + 0.1 * rng.randn(32)
    m = gp.GPE(x, y, kernel=gp.SE(0.0, 0.0), lognoise=-1.0, device=device)
    logprob, x0, _, _ = m.make_logprob()
    C = 2 * P
    theta0 = x0 + 0.1 * torch.randn((C, x0.numel()), generator=generator(device, 2),
                                    dtype=x0.dtype, device=x0.device)
    n_iter, n_warmup = _it(300, depth), _it(100, depth)
    res = sharded_hmc(logprob, theta0, 3, make_mesh({"chains": P}, device=device),
                      n_iter=n_iter, n_warmup=n_warmup, eps0=0.1, Lmin=4, Lmax=8)
    ess = effective_sample_size(res.samples).cpu().numpy()
    rhat = split_rhat(res.samples).cpu().numpy()
    say(f"[chains/{P}-mesh] {C} chains x {n_iter} iters: "
          f"accept={float(res.accept_rate.mean()):.2f}, eps*={float(res.eps_final):.3f}, "
          f"min ESS={ess.min():.0f}, max split-Rhat={rhat.max():.3f}")
    return {"accept": res.accept_rate.cpu().numpy(), "eps": float(res.eps_final),
            "finite": bool(torch.isfinite(res.samples).all())}


def fitc_data(P: int):
    rng = np.random.RandomState(4)
    n = 256 * P
    X = 2 * np.pi * rng.rand(n, 1)
    return X, np.sin(X[:, 0]) + 0.3 * rng.randn(n), np.linspace(0, 2 * np.pi, 16)


def sharded_fitc(P: int, device) -> dict:
    """The FITC mll with the observation axis sharded."""
    X, y, Xu = fitc_data(P)
    fitc = gp.FITC(X, Xu, y, kernel=gp.SE(0.0, 0.0), lognoise=-0.5, device=device)
    mesh = make_mesh({"data": P}, device=device)
    mll_fn = fitc_mll_sharded_fn(fitc.params.kernel, mesh)
    X_loc, y_loc = shard_data(fitc.x, fitc.y, mesh)
    vec = fitc.params.flat_params().detach().requires_grad_()
    val = mll_fn(fitc.params.with_flat_params(vec), X_loc, y_loc, fitc.covstrat.inducing)
    (g,) = torch.autograd.grad(val, vec)
    val = val.detach()
    say(f"[fitc/{P}-mesh] n={X.shape[0]} sharded over {P} devices: mll={float(val):.2f} "
          f"(replicated check: {float(fitc.mll):.2f}), |grad|={float(g.norm()):.2f}")
    return {"mll": float(val), "mll_replicated": float(fitc.mll), "grad": g.cpu().numpy()}


def distributed_gpa(P: int, device, depth: float = 1.0) -> dict:
    """A Bernoulli GPA whose dense covariance is tile-column sharded: the
    target's gradient flows through the distributed factor."""
    rng = np.random.RandomState(5)
    n, d = 16 * P, 2
    X = rng.randn(n, d)
    y = (np.sin(X[:, 0]) + 0.3 * rng.randn(n) > 0).astype(float)
    m = gp.GPA(X, y, gp.MeanZero(), gp.Matern(1.5, 0.0, 0.0), gp.BernLik(), device=device,
               covstrat=gp.DistributedFullCovariance(make_mesh({"j": P}, device=device)))
    t, g = m.target_and_dtarget()
    logprob, x0, _, _ = m.make_logprob()
    res = hmc(logprob, x0, generator(device, 6), n_iter=_it(50, depth), eps=0.02)
    say(f"[gpa/{P}-mesh] n={n}: target={float(t):.2f}, |dtarget|={float(g.norm()):.2f}, "
          f"{_it(50, depth)} HMC iters accept={float(res.accept_rate):.2f}")
    return {"target": float(t), "grad": g.cpu().numpy(), "accept": float(res.accept_rate)}


def chains_x_j(P: int, device, depth: float = 1.0) -> dict | None:
    """`sharded_hmc` over the distributed dense target on a ('chains', 'j')
    pod mesh: chain groups on the outer axis, each factoring its tile
    columns on the inner one."""
    if P < 2:
        say("[chains x j] skipped (needs >= 2 devices)")
        return None
    pj = min(4, P)
    pod = make_pod_mesh({"j": pj}, device=device)
    n = 8 * pj
    rng = np.random.RandomState(7)
    X = rng.randn(n, 2)
    y = np.sin(X[:, 0]) + 0.3 * rng.randn(n)
    m = gp.GPE(X, y, kernel=gp.SE(0.0, 0.0), lognoise=-1.0, device=device,
               covstrat=AmbientFullCovariance(pod, B=4))
    logprob, x0, _, _ = m.make_logprob()
    C = 2 * pod.shape["chains"]
    res = sharded_hmc(logprob, x0.expand(C, -1).clone(), 8, pod, n_iter=_it(30, depth),
                      n_warmup=_it(10, depth), eps0=0.05)
    say(f"[chains x j/{dict(pod.shape)}] {C} chains over a distributed dense GP: "
          f"accept={float(res.accept_rate.mean()):.2f}, eps*={float(res.eps_final):.4f}")
    return {"accept": res.accept_rate.cpu().numpy(), "eps": float(res.eps_final)}


def sharded_split(P: int, device, depth: float = 1.0) -> dict:
    """The chain-sharded factor-cached split sampler with collective
    per-block adaptation."""
    rng = np.random.RandomState(9)
    n, d = 24, 2
    X = rng.randn(n, d)
    y = (np.sin(X[:, 0]) + 0.3 * rng.randn(n) > 0).astype(float)
    m = gp.GPA(X, y, gp.MeanZero(), gp.SE(0.0, 0.0), gp.BernLik(), device=device)
    pc, la, lb, a0, b0 = m.make_split_logprob()
    C = 2 * P
    th = torch.cat([a0, b0]).expand(C, -1).clone()
    res = sharded_split_hmc(pc, la, lb, th, 10, make_mesh({"chains": P}, device=device),
                            a0.shape[0], n_iter=_it(40, depth), a_iters=4,
                            n_warmup=_it(20, depth), eps_a0=0.3, eps_b0=0.1)
    say(f"[split/{P}-mesh] {C} chains: accept_a={float(res.accept_rate_a.mean()):.2f}, "
          f"accept_b={float(res.accept_rate_b.mean()):.2f}, adapted eps=("
          f"{float(res.eps_a_final):.3f}, {float(res.eps_b_final):.3f})")
    return {"eps_a": float(res.eps_a_final), "eps_b": float(res.eps_b_final),
            "finite": bool(torch.isfinite(res.samples).all())}


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--depth", type=float, default=1.0,
                   help="scales every optimizer and sampler count (1.0: the JAX example's)")
    args = p.parse_args(argv)
    P, dev, depth = world(), args.device, args.depth
    if P > 1 and dev == "cuda":
        dev = f"cuda:{torch.distributed.get_rank() % torch.cuda.device_count()}"
    say(f"devices: {P} x {torch.device(dev).type}")
    return {"dense": distributed_dense(P, dev, depth),
            "chains": sharded_chains(P, dev, depth),
            "fitc": sharded_fitc(P, dev),
            "gpa": distributed_gpa(P, dev, depth),
            "chains_x_j": chains_x_j(P, dev, depth),
            "split": sharded_split(P, dev, depth)}


if __name__ == "__main__":
    main(sys.argv[1:])
