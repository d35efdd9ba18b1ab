"""The distributed dense and sparse paths on one card (a mesh axis of size 1,
as the JAX bench runs its sharded paths on a one-device mesh).

    python -m gaussianprocesses_jl_tpu_torch.perf.parallel_study   # on the card

It runs, and prints as one JSON object on its last line:
  * dense: the headline GPE (SE, d = 10, lognoise -1, the data of
    `bench.py:1055-1058`) through `DistributedFullCovariance` on
    make_mesh({'j': 1}) at n = 3000 (B = 500, 6 tiles) and n = 16384
    (B = 512, 32 tiles), f32: target and gradient against the same model on
    `FullCovariance` in f32 and f64 on the card (and at n = 3000 f64 on the
    CPU), the launches of one evaluation by shape, the evaluation's time
    (CUDA events) beside `FullCovariance`'s, the distributed factorization
    alone beside `cholesky_ex`'s, peak memory;
  * a non-PD K (a rank-one Const(20) gram, lognoise -200): -inf in f32 and
    f64; `optimize(maxiter=5)` and `predict_y` at n = 3000;
  * configuration #2's GPA target (`gpa_study`) on
    `DistributedFullCovariance(B=40)` vmapped over 128 chains against the
    vmapped `FullCovariance` target, and 10 `sharded_hmc` iterations on
    make_pod_mesh({'j': 1}) with `AmbientFullCovariance`;
  * configuration #4 as the JAX bench runs it: `fitc_mll_sharded_fn` on
    make_mesh({'data': 1}) under Adam (lr 0.05, the reject-don't-commit
    guard), 2 warm-up and 6 timed steps, the mll and gradient at the start
    against `fitc_study`'s `LowRankPD` path;
  * configuration #3 as its example runs it: `sharded_vi_train` at n = 4096
    on make_mesh({'data': 1}), 150 Adam steps, its ELBO trace against the
    replicated Adam run step by step; `sharded_vi` with 8 restarts (restart
    0 against `vi(method="adam")`); `ring_gram` at n = 3000 against
    `kernel.gram`.
chip_smoke.py phases 27-30 run these functions and hold their numbers to
stated tolerances; `gram_rows` times the gram kernels at the new shapes
for its kernel table.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.inference.hmc import batched_value_and_grad
from gaussianprocesses_jl_tpu_torch.inference.vi import adam, make_neg_elbo
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.ops.linalg import add_diag
from gaussianprocesses_jl_tpu_torch.parallel import chains
from gaussianprocesses_jl_tpu_torch.parallel.cholesky import build_tiles, distributed_cholesky
from gaussianprocesses_jl_tpu_torch.parallel.dense import AmbientFullCovariance
from gaussianprocesses_jl_tpu_torch.parallel.fitc import fitc_mll_sharded_fn, shard_data
from gaussianprocesses_jl_tpu_torch.parallel.mesh import make_pod_mesh
from gaussianprocesses_jl_tpu_torch.parallel.vi import sharded_vi, sharded_vi_train
from gaussianprocesses_jl_tpu_torch.perf import fitc_study, gpa_study, vi_study
from gaussianprocesses_jl_tpu_torch.utils import graphs
from gaussianprocesses_jl_tpu_torch.perf.gram_study import (
    _rows,
    by_shape,
    gram_bound_ms,
    gram_vjp_bound_ms,
    launches,
    time_ms,
)

__all__ = ["DENSE_SIZES", "headline_model", "dense", "nonpd", "dense_fit", "gpa",
           "ShardedFitcAdam", "fitc", "vi", "gram_rows", "gap", "main"]

DENSE_SIZES = ((3000, 500), (16384, 512))  # (n, B): choose_tile_size(3000, 1) = 500
D_HEAD = 10
GPA_B, HMC_ITERS = 40, 10


def headline_model(n, dtype, device, covstrat=None):
    """The headline GPE at n points: SE(0, 0), lognoise -1, X and y standard
    normals from RandomState(42) as `bench.py` draws them."""
    rng = np.random.RandomState(42)
    X, y = rng.randn(n, D_HEAD), rng.randn(n)
    return gp.GPE(X.astype(dtype), y.astype(dtype), gp.MeanZero(), gp.SE(0.0, 0.0),
                  lognoise=-1.0, covstrat=covstrat, device=device)


def _target_grad(m):
    t, g = m.target_and_dtarget()
    return float(t), g.double().cpu().numpy()


def gap(a, b) -> tuple:
    """(|a0 - b0| / |b0|, max|a1 - b1| / max|b1|) of two (value, gradient)
    pairs."""
    return (abs(a[0] - b[0]) / abs(b[0]),
            float(np.abs(a[1] - b[1]).max() / np.abs(b[1]).max()))


def _dist(axis="j", **kw):
    return gp.DistributedFullCovariance(gp.make_mesh({axis: 1}), axis=axis, **kw)


def dense(device, n, B, reps=5) -> dict:
    """The distributed headline at n against FullCovariance: gaps, launches
    of one evaluation (by shape), times and peak memory."""
    md = headline_model(n, np.float32, device, _dist(B=B))
    mf = headline_model(n, np.float32, device)
    torch.cuda.reset_peak_memory_stats(device)
    dist32, n_eval = launches(lambda: _target_grad(md))
    shapes = by_shape()
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    full32 = _target_grad(mf)
    full64 = _target_grad(headline_model(n, np.float64, device))
    out = {"n": n, "B": B, "tiles": n // B, "launches": n_eval, "by_shape": shapes,
           "peak_mib": peak, "target_f32": dist32[0],
           "dist32_vs_full32": gap(dist32, full32), "dist32_vs_full64": gap(dist32, full64),
           "full32_vs_full64": gap(full32, full64), "finite": bool(
               np.isfinite(dist32[0]) and np.isfinite(dist32[1]).all())}
    if n <= 3000:
        cpu64 = _target_grad(headline_model(n, np.float64, "cpu"))
        out["dist32_vs_full64_cpu"] = gap(dist32, cpu64)
        out["full32_vs_full64_cpu"] = gap(full32, cpu64)
    out["dist_ms"] = time_ms(md.target_and_dtarget, reps=reps, warmup=1)
    out["full_ms"] = time_ms(mf.target_and_dtarget, reps=reps, warmup=1)
    # the factorization alone: the distributed one against cholesky_ex of K
    with torch.no_grad():
        nv = torch.exp(2.0 * md.params.lognoise.value)
        tiles = build_tiles(md.params.kernel, nv, md.x, B, md.covstrat.mesh)
        K = add_diag(md.params.kernel.gram(md.x), nv)
        out["factor_ms"] = time_ms(lambda: distributed_cholesky(tiles, md.covstrat.mesh),
                                   reps=reps, warmup=1)
        out["cholesky_ex_ms"] = time_ms(lambda: torch.linalg.cholesky_ex(K), reps=reps,
                                        warmup=1)
        del tiles, K
    print(f"  distributed headline n={n} B={B}: launches {n_eval} by shape {shapes}, "
          f"{out['dist_ms']:.3f} ms an evaluation (FullCovariance {out['full_ms']:.3f}), the "
          f"factor alone {out['factor_ms']:.3f} ms (cholesky_ex {out['cholesky_ex_ms']:.3f}), "
          f"peak {peak:.0f} MiB; gaps (value, gradient of max): dist32 vs full32 "
          f"{out['dist32_vs_full32']}, vs full64 {out['dist32_vs_full64']}, full32 vs full64 "
          f"{out['full32_vs_full64']}", flush=True)
    return out


def nonpd(device) -> dict:
    """The target of a rank-one Const(20) gram with lognoise -200 on the
    distributed strategy (the JAX test's non-PD case), f32 and f64, n = 64."""
    X, y = np.random.RandomState(12).randn(64, 3), np.random.RandomState(13).randn(64)
    out = {}
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        m = gp.GPE(X.astype(dtype), y.astype(dtype), gp.MeanZero(), gp.Const(20.0),
                   lognoise=-200.0, covstrat=_dist(B=8), device=device)
        out[name] = float(m.target)
    print(f"  non-PD K: target {out}", flush=True)
    return out


def dense_fit(device, n=3000, B=500) -> dict:
    """optimize(maxiter=5) and predict_y at 500 points on the distributed
    headline, with their launches."""
    m = headline_model(n, np.float32, device, _dist(B=B))
    t0 = float(m.target)
    res, n_opt = launches(lambda: m.optimize(maxiter=5))
    opt_shapes = by_shape()
    Xs = np.random.RandomState(7).randn(500, D_HEAD).astype(np.float32)
    (mu, var), n_pred = launches(lambda: m.predict_y(Xs))
    pred_shapes = by_shape()
    out = {"target_start": t0, "target_end": float(m.target), "n_iter": res.n_iter,
           "optimize_launches": n_opt, "optimize_by_shape": opt_shapes,
           "predict_launches": n_pred, "predict_by_shape": pred_shapes,
           "predict_finite": bool(torch.isfinite(mu).all() and torch.isfinite(var).all()
                                  and (var >= 0).all())}
    print(f"  distributed headline optimize(maxiter=5): {t0:.4f} -> {out['target_end']:.4f}, "
          f"launches {n_opt}; predict_y at 500 points: launches {n_pred}", flush=True)
    return out


def gpa(device, chains_n=gpa_study.CHAINS, hmc_iters=HMC_ITERS) -> dict:
    """Configuration #2's GPA target vmapped over `chains_n` chains on
    DistributedFullCovariance(B=40) against FullCovariance, f32; then
    `hmc_iters` sharded_hmc iterations over AmbientFullCovariance on a pod
    mesh."""
    rng = np.random.RandomState(13)
    vec = np.concatenate([rng.randn(gpa_study.N), 0.5 * rng.randn(gpa_study.D_FEAT + 1)])
    m_full = gpa_study.config2_model(device).set_params(vec)
    m_dist = gpa_study.config2_model(device).set_params(vec)
    m_dist.covstrat = _dist(B=GPA_B)
    lp_full, x0, _, _ = m_full.make_logprob()
    lp_dist, _, _, _ = m_dist.make_logprob()
    gen = torch.Generator(device=device).manual_seed(13)
    states = x0 + 0.3 * torch.randn((chains_n, x0.numel()), generator=gen, dtype=x0.dtype,
                                    device=device)
    (t_d, g_d), n_batch = launches(lambda: batched_value_and_grad(lp_dist)(states))
    shapes = by_shape()
    t_f, g_f = batched_value_and_grad(lp_full)(states)
    rel_t = float(((t_d - t_f).abs() / t_f.abs()).max())
    rel_g = float(((g_d - g_f).abs().amax(1) / g_f.abs().amax(1)).max())
    out = {"chains": chains_n, "B": GPA_B, "launches": n_batch, "by_shape": shapes,
           "target_rel": rel_t, "gradient_rel": rel_g,
           "vmapped_ms": time_ms(lambda: batched_value_and_grad(lp_dist)(states), reps=5),
           "vmapped_full_ms": time_ms(lambda: batched_value_and_grad(lp_full)(states), reps=5)}
    pod = make_pod_mesh({"j": 1})
    m_amb = gpa_study.config2_model(device).set_params(vec)
    m_amb.covstrat = AmbientFullCovariance(pod, B=GPA_B)
    lp_amb, _, _, _ = m_amb.make_logprob()
    t0 = time.perf_counter()
    res, n_hmc = launches(lambda: chains.sharded_hmc(lp_amb, states, 28, pod, n_iter=hmc_iters,
                                                     eps0=0.02, Lmin=2, Lmax=5))
    out.update(hmc_s=time.perf_counter() - t0, hmc_launches=n_hmc, hmc_by_shape=by_shape(),
               hmc_finite=bool(torch.isfinite(res.samples).all()
                               and torch.isfinite(res.final_target).all()),
               hmc_accept=float(res.accept_rate.mean()))
    print(f"  GPA on DistributedFullCovariance(B={GPA_B}) vmapped over {chains_n} chains: "
          f"launches {n_batch} by shape {shapes}, {out['vmapped_ms']:.3f} ms (FullCovariance "
          f"{out['vmapped_full_ms']:.3f}); against FullCovariance: target {rel_t:.3e}, gradient "
          f"{rel_g:.3e} of max; sharded_hmc {hmc_iters} iterations over AmbientFullCovariance: "
          f"{out['hmc_s']:.2f} s, launches {n_hmc}, accept {out['hmc_accept']:.3f}", flush=True)
    return out


class ShardedFitcAdam(fitc_study.FitcAdam):
    """`fitc_study`'s Adam with the guard, on the observation-sharded mll
    (`fitc_mll_sharded_fn`) over this process's rows of a mesh's 'data'
    axis: configuration #4 as the JAX bench runs it."""

    def __init__(self, model, mesh, lr=fitc_study.LR):
        super().__init__(model, lr)
        self.mesh, self.mll = mesh, fitc_mll_sharded_fn(model.params.kernel, mesh)
        self.X_loc, self.y_loc = shard_data(model.x, model.y, mesh)

    def loss(self, theta):
        return -self.mll(self.model.params.with_flat_params(theta), self.X_loc, self.y_loc,
                         self.model.covstrat.inducing)

    def mll_and_grad(self, theta):
        loss, g = self.loss_and_grad(theta)
        return -loss, -g

    def step(self) -> float:
        """At P = 1 the graphed step; at P > 1 eager (no collective under
        capture)."""
        if self.mesh.shape["data"] == 1:
            return super().step()
        with graphs.eager():
            return super().step()


def fitc(device, warmup=fitc_study.WARMUP, steps=fitc_study.STEPS) -> dict:
    """Configuration #4 through `fitc_mll_sharded_fn`: the start's mll and
    gradient against the LowRankPD path's, then `warmup` + `steps` Adam
    steps (ms each by CUDA events, launches by shape, the loss trace); the
    LowRankPD step's time beside it."""
    t0 = time.perf_counter()
    model = fitc_study.config4_model(device)
    trainer = ShardedFitcAdam(model, gp.make_mesh({"data": 1}))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mll, g = trainer.mll_and_grad(trainer.theta)
    start = (float(mll), g.double().cpu().numpy())
    low = fitc_study.mll_and_grad(model, trainer.theta.detach().cpu().numpy())
    losses = [trainer.step() for _ in range(warmup)]
    step_ms = []

    def timed():
        for _ in range(steps):
            loss, ms = vi_study._events_ms(trainer.step)
            losses.append(loss)
            step_ms.append(ms)

    _, n = launches(timed)
    shapes = by_shape()
    cross = tuple(shapes.get(f"{k} cross {fitc_study.M}x{fitc_study.N}", 0)
                  for k in ("gram", "gram_vjp"))
    low_trainer = fitc_study.FitcAdam(fitc_study.config4_model(device))
    low_trainer.step()
    low_ms = statistics.median(vi_study._events_ms(low_trainer.step)[1] for _ in range(3))
    out = {"N": fitc_study.N, "m": fitc_study.M, "setup_s": setup_s, "start_mll": start[0],
           "lowrank_mll": low[0], "start_vs_lowrank": gap(start, low), "losses": losses,
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
           "lowrank_step_ms": low_ms, "launches": n, "by_shape": shapes,
           "cross_launches": cross,
           "timed_steps": steps}
    print(f"  configuration #4 through fitc_mll_sharded_fn: set-up {setup_s:.2f} s, start mll "
          f"{start[0]:.3f} (LowRankPD {low[0]:.3f}; gap {out['start_vs_lowrank']}), losses "
          f"{losses}, step ms {step_ms} (median {out['step_ms_median']:.3f}; LowRankPD "
          f"{low_ms:.3f}), launches {n} ({cross} at {fitc_study.M} x {fitc_study.N})",
          flush=True)
    return out


def vi(device, restarts=8) -> dict:
    """Configuration #3: sharded_vi_train's ELBO trace against the
    replicated Adam run's (vi's loop, each step's ELBO recorded), both from
    the prior's start; sharded_vi with `restarts` restarts (restart 0
    against vi(method="adam")); ring_gram at n = 3000 against kernel.gram."""
    m = vi_study.config3_model(device)
    mesh = gp.make_mesh({"data": 1})
    (res, ms), n_train = launches(lambda: vi_study._events_ms(
        lambda: sharded_vi_train(m, mesh, nits=vi_study.NITS, lr=vi_study.LR)))
    train_shapes = by_shape()
    neg_elbo, theta0, n = make_neg_elbo(m)
    rep = (-adam(neg_elbo, theta0, vi_study.NITS, vi_study.LR)[1]).double().cpu().numpy()
    tr = res.elbo_trace.double().cpu().numpy()
    q = gp.vi(m, nits=vi_study.NITS, method="adam", lr=vi_study.LR)
    (rv, ms_r), n_restarts = launches(lambda: vi_study._events_ms(lambda: sharded_vi(
        m, gp.make_mesh({"chains": 1}), restarts=restarts, nits=vi_study.NITS, lr=vi_study.LR,
        seed=30)))
    restarts_shapes = by_shape()
    # restart 0 starts where vi does: its final ELBO against vi(method="adam")'s
    e_vi = float(gp.elbo(m, q.m, q.v))
    hm = headline_model(3000, np.float32, device)
    kern, X = hm.params.kernel, hm.x
    K_ring, n_ring = launches(lambda: gp.ring_gram(kern, X, mesh))
    ring_shapes = by_shape()
    K_ref = kern.gram(X)
    out = {"n": n, "nits": vi_study.NITS, "train_ms": ms, "train_launches": n_train,
           "train_by_shape": train_shapes, "trace_first": float(tr[0]),
           "trace_last": float(tr[-1]), "elbo": res.elbo,
           "trace_vs_replicated": float(np.abs(tr - rep).max() / np.abs(rep).max()),
           "train_vs_vi_m": float((res.approx.m - q.m).abs().max() / q.m.abs().max()),
           "restarts": restarts, "restarts_ms": ms_r, "restarts_launches": n_restarts,
           "restarts_by_shape": restarts_shapes, "elbos": rv.elbos.cpu().tolist(),
           "best": rv.best, "restart0_vs_vi": abs(float(rv.elbos[0]) - e_vi) / abs(e_vi),
           "vi_elbo": e_vi,
           "ring_launches": n_ring, "ring_by_shape": ring_shapes,
           "ring_vs_gram": float((K_ring - K_ref).abs().max())}
    print(f"  configuration #3 through sharded_vi_train, n={n}: {ms:.1f} ms for "
          f"{vi_study.NITS} steps, elbo {tr[0]:.2f} -> {res.elbo:.2f}; trace against the "
          f"replicated Adam run, max gap {out['trace_vs_replicated']:.3e} of max; sharded_vi "
          f"{restarts} restarts in {ms_r:.1f} ms, best {rv.best}, restart 0 vs vi "
          f"{out['restart0_vs_vi']:.3e}; ring_gram n=3000: launches {n_ring}, max|K - gram| "
          f"{out['ring_vs_gram']:.3e}", flush=True)
    return out


def gram_rows(device) -> dict:
    """The gram kernels at the distributed strategy's shapes, f32: the cross
    gram K(X, X) of the headline at n = 3000 and 16384 (SE, d = 10) and its
    dp VJP, and configuration #2's batched cross gram (C = 128 chains, 200
    x 200, Mat32 ARD, d = 5) with its dp + dX VJP: own time, bound, plain
    version (`gram_study._rows`)."""
    f32 = dict(dtype=torch.float32, device=device)
    se, dp = gram_op.SE, (True, False, False)
    p = torch.zeros(3, **f32)
    cases = []
    for n in (3000, 16384):
        rng = np.random.RandomState(42)
        X = torch.as_tensor(rng.randn(n, D_HEAD), **f32)
        G = torch.as_tensor(rng.randn(n, n), **f32)
        cases += [
            (f"cross gram {n}x{n}", lambda X=X: gram_op.launch_gram(se, p, X, X), "gram_kernel",
             lambda X=X: gram_op.gram_plain(se, p, X, X), gram_bound_ms(n, n, D_HEAD, 4, False),
             {"n1": n, "n2": n, "d": D_HEAD}),
            (f"cross gram_vjp dp {n}x{n}",
             lambda X=X, G=G: gram_op.launch_gram_vjp(se, p, X, X, G, dp), "gram_vjp",
             lambda X=X, G=G: gram_op.gram_vjp_plain(se, p, X, X, G, dp),
             gram_vjp_bound_ms(n, n, D_HEAD, 4, False, False), {"n1": n, "n2": n, "d": D_HEAD})]
    C, nb, d = gpa_study.CHAINS, gpa_study.N, gpa_study.D_FEAT
    rng = np.random.RandomState(6)
    A = torch.as_tensor(rng.randn(C, nb, d), **f32)
    P = torch.as_tensor(0.1 * rng.randn(C, 3), **f32)
    P[:, 1] = 0.0
    Gb = torch.as_tensor(rng.randn(C, nb, nb), **f32)
    fam, needs = gram_op.MAT32, (True, True, True)
    cases += [
        (f"batched cross gram C={C} {nb}x{nb}", lambda: gram_op.launch_gram(fam, P, A, A),
         "gram_kernel", lambda: gram_op.gram_plain(fam, P, A, A),
         gram_bound_ms(nb, nb, d, 4, False, C, True), {"chains": C, "n": nb, "d": d}),
        (f"batched cross gram_vjp C={C} {nb}x{nb}",
         lambda: gram_op.launch_gram_vjp(fam, P, A, A, Gb, needs), "gram_vjp",
         lambda: gram_op.gram_vjp_plain(fam, P, A, A, Gb, needs),
         gram_vjp_bound_ms(nb, nb, d, 4, False, True, C, True), {"chains": C, "n": nb, "d": d})]
    return _rows(cases, label="  distributed strategy's ")


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("parallel_study: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"dense": [dense(dev, n, B) for n, B in DENSE_SIZES], "nonpd": nonpd(dev),
           "dense_fit": dense_fit(dev), "gpa": gpa(dev), "fitc": fitc(dev), "vi": vi(dev),
           "device": torch.cuda.get_device_name(0)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
