"""The bytes the port's collectives send on each sharded path, and the
scaling efficiency they predict (the port of the JAX repo's
`perf/comm_model.py`).

    python -m gaussianprocesses_jl_tpu_torch.perf.comm_model [--procs 2 4 8]

The card's machine has one GPU, so nothing here is measured across cards.
For each P of `--procs` the script starts a gloo job of P CPU processes (a
`file://` rendezvous in a temporary directory; the counts do not depend on
the device) and runs, at the JAX model's shapes and data
(`RandomState(0)`, drawn in its order), each path of its `measure_paths`:

* `sharded_hmc`: a Bernoulli GPA (n = 20, d = 2, SE), C = 8 chains, 22
  warm-up iterations with mass adaptation and 2 more (`per_iter` is the
  total over 24);
* `sharded_split_hmc`: the same GPA's split target, 4 warm-up + 4 outer
  iterations of 2 A updates (`per_iter` over 8);
* `distributed_cholesky_vg`: the GPE target and gradient through
  `DistributedFullCovariance(B=32)` at n = 256, f32;
* `sharded_fitc_vg`: the FITC mll and gradient through
  `fitc_mll_sharded_fn`, N = 1024, m = 64, f32;
* `sharded_elbo_vg`: the observation-sharded ELBO and its gradient (a
  Poisson GPA, n = 512, Matern 3/2);
* `ring_gram`: `ring_gram` of 512 points in d = 4, f32.

It reads `parallel/collectives.py`'s `BYTES` and `CALLS` around each path
(the reduced tensor of an all-reduce, the gathered output of an all-gather,
the broadcast tensor, the shifted block) on every rank, checks the ranks
agree, and prints them by op beside `perf/comm_model.json`'s `payloads`
(the JAX package's, read from XLA's optimized HLO on 8 virtual devices).
XLA merges collectives, so calls differ; the port's factor walks live tiles
alone, so bytes may differ too.

The efficiency model then predicts E(P) = t_comp / (t_comp + t_comm) per
iteration for each P of `--procs`, from the traffic counted over P
processes, over NVLink 4 and NDR InfiniBand (nominal
bandwidths and latencies, stated in the output; nothing measured), with
t_comm = calls * latency * log2(P) + bytes / bandwidth at each
configuration's width (the measured bytes scaled as stated per path) and
t_comp the card's measured time per iteration on one H100 (PERF.md section
5). It ignores the serial part of a distributed factorization, so it is an
upper bound there. The result is written to
`gaussianprocesses_jl_tpu_torch/perf/comm_model.json`.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

__all__ = ["PATHS", "measure_paths", "by_op", "efficiency_model", "run_job", "main"]

PATHS = ("sharded_hmc", "sharded_split_hmc", "distributed_cholesky_vg", "sharded_fitc_vg",
         "sharded_elbo_vg", "ring_gram")
JAX_KEYS = {"sharded_hmc": "sharded_hmc_per_iter",
            "sharded_split_hmc": "sharded_split_hmc_per_outer_iter",
            "distributed_cholesky_vg": "distributed_cholesky_vg_total",
            "sharded_fitc_vg": "sharded_fitc_mll_grad_total",
            "sharded_elbo_vg": "sharded_elbo_value_grad_total",
            "ring_gram": "ring_gram_total"}
HERE = Path(__file__).resolve().parent
JAX_JSON = HERE.parents[1] / "perf" / "comm_model.json"
OUT_JSON = HERE / "comm_model.json"

# Interconnect assumptions (nominal, not measured: the card's machine has
# one GPU). NVLink 4 on an H100 SXM: 900 GB/s both ways, 450 GB/s each
# way; NDR InfiniBand: 400 Gb/s = 50 GB/s a port. Latencies are round
# figures for a small collective of one step (NVLink) and across hosts (IB).
LINKS = {"NVLink4": {"bw_B_per_s": 450e9, "latency_s": 5e-6},
         "NDR_IB": {"bw_B_per_s": 50e9, "latency_s": 15e-6}}

# The card's time per iteration at each configuration (one NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md section 5) and how the measured bytes and
# calls are scaled to that configuration's width.
CONFIGS = {
    "sharded_hmc": {"config": "configuration #5, Student-t GPA, 1024 chains, D = 63",
                    "t_comp_ms": 125.89, "source": "student_t_study, PERF.md section 5",
                    "bytes_scale": 1024 / 8, "calls_scale": 1.0,
                    "rule": "per-chain statistics gathered in chain order: bytes grow with C"},
    "sharded_split_hmc": {"config": "configuration #2, GPA classification, 128 chains",
                          "t_comp_ms": 1390.36,
                          "source": "gpa_study, one outer iteration, PERF.md section 5",
                          "bytes_scale": 128 / 8, "calls_scale": 1.0,
                          "rule": "per-chain accept statistics gathered: bytes grow with C"},
    "distributed_cholesky_vg": {
        "config": "headline SE at n = 16384, B = 512 (one evaluation)",
        "t_comp_ms": 218.996, "source": "chip_smoke phase 27, PERF.md section 5",
        "bytes_scale": (16384 / 256) ** 2, "calls_scale": (16384 / 512) / (256 / 32),
        "rule": "panels of B x n: bytes grow with n^2, calls with the n / B tiles"},
    "sharded_fitc_vg": {"config": "configuration #4, N = 100 000, m = 512 (one Adam step)",
                        "t_comp_ms": 46.405, "source": "chip_smoke phase 29, PERF.md section 5",
                        "bytes_scale": (513 / 65) ** 2, "calls_scale": 1.0,
                        "rule": "the all-gather of (m + 1)^2 R factors: bytes grow with m^2"},
    "sharded_elbo_vg": {"config": "configuration #3, n = 4096 (one Adam step)",
                        "t_comp_ms": 2.3718, "source": "vi_study, PERF.md section 5",
                        "bytes_scale": 4096 / 512, "calls_scale": 1.0,
                        "rule": "m and v's gradient shares all-reduced: bytes grow with n"},
}


def by_op(bytes_, calls) -> dict:
    """{op: {"count": calls, "bytes": bytes}} summed over axes and dtypes."""
    out = {}
    for (op, _axis, _dtype), b in bytes_.items():
        rec = out.setdefault(op, {"count": 0, "bytes": 0})
        rec["bytes"] += b
        rec["count"] += calls[(op, _axis, _dtype)]
    return dict(sorted(out.items()))


def measure_paths(world: int) -> dict:
    """Run every path on this process (a job of `world` processes already
    joined) and return {path: {"ops": by_op, "iterations": k}}."""
    import gaussianprocesses_jl_tpu_torch as gp
    from gaussianprocesses_jl_tpu_torch.models.gpe import GPEParams, gpe_target
    from gaussianprocesses_jl_tpu_torch.parallel import chains, collectives, fitc, vi
    from gaussianprocesses_jl_tpu_torch.parallel.mesh import make_mesh
    from gaussianprocesses_jl_tpu_torch.utils.params import Param

    out = {}

    def counted(name, fn, iterations=1):
        collectives.BYTES.clear()
        collectives.CALLS.clear()
        fn()
        out[name] = {"ops": by_op(collectives.BYTES, collectives.CALLS),
                     "iterations": iterations}

    def value_grad(f, *xs):
        xs = [x.detach().clone().requires_grad_() for x in xs]
        val = f(*xs)
        torch.autograd.grad(val, xs)

    rng = np.random.RandomState(0)
    n, d, C = 20, 2, 8
    X = rng.randn(n, d)
    yb = (np.sin(X[:, 0]) > 0).astype(float)
    m = gp.GPA(X.astype(np.float32), yb.astype(np.float32), gp.MeanZero(), gp.SE(0.0, 0.0),
               gp.BernLik(), device="cpu")
    logprob, x0, _, _ = m.make_logprob()
    mesh = make_mesh({"chains": world}, device="cpu")
    counted("sharded_hmc", lambda: chains.sharded_hmc(
        logprob, x0.expand(C, -1).clone(), 0, mesh, n_iter=2, n_warmup=22, eps0=0.1, Lmin=2,
        Lmax=3), iterations=24)
    pc, la, lb, a0, b0 = m.make_split_logprob()
    ths = torch.cat([a0, b0]).expand(C, -1).clone()
    counted("sharded_split_hmc", lambda: chains.sharded_split_hmc(
        pc, la, lb, ths, 1, mesh, a0.shape[0], n_iter=4, a_iters=2, n_warmup=4, Lmin=2,
        Lmax=3), iterations=8)

    nd = 256
    Xd = torch.as_tensor(rng.randn(nd, 2), dtype=torch.float32)
    yd = torch.as_tensor(np.sin(rng.randn(nd)), dtype=torch.float32)
    cs = gp.DistributedFullCovariance(make_mesh({"j": world}, device="cpu"), B=32)
    params = GPEParams(lognoise=Param(value=torch.tensor(-1.0)), mean=gp.MeanZero(),
                       kernel=gp.SE(0.0, 0.0)).to(dtype=torch.float32)
    counted("distributed_cholesky_vg", lambda: value_grad(
        lambda v: gpe_target(params.with_flat_params(v), Xd, yd, cs)[0], params.flat_params()))

    Nf, mf, df = 1024, 64, 2
    Xf = rng.randn(Nf, df).astype(np.float32)
    yf = np.sin(Xf[:, 0]).astype(np.float32)
    Xu = Xf[rng.choice(Nf, mf, replace=False)].copy()
    model = gp.FITC(Xf, Xu, yf, kernel=gp.SE(0.0, 0.0), lognoise=-1.0, device="cpu")
    md = make_mesh({"data": world}, device="cpu")
    mll_fn = fitc.fitc_mll_sharded_fn(model.params.kernel, md)
    X_loc, y_loc = fitc.shard_data(model.x, model.y, md)
    Xu_t = model.covstrat.inducing
    counted("sharded_fitc_vg", lambda: value_grad(
        lambda v: -mll_fn(model.params.with_flat_params(v), X_loc, y_loc, Xu_t),
        model.params.flat_params()))

    nv = 512
    tv = np.sort(rng.rand(nv) * 10)
    yv = rng.poisson(np.exp(1 + 0.5 * np.sin(tv))).astype(float)
    mv = gp.GPA(tv[:, None].astype(np.float32), yv.astype(np.float32), gp.MeanZero(),
                gp.Matern(1.5, 0.0, 0.0), gp.PoisLik(), device="cpu")
    elbo_fn = vi.sharded_elbo_fn(mv, md)
    mu = mv.params.mean.mean(mv.x)
    counted("sharded_elbo_vg", lambda: value_grad(elbo_fn, mu, torch.ones(nv, dtype=mu.dtype)))

    Xr = torch.as_tensor(rng.randn(512, 4), dtype=torch.float32)
    Xr_loc = fitc.shard_data(Xr, Xr[:, 0], md)[0]
    counted("ring_gram", lambda: gp.ring_gram(gp.SE(0.0, 0.0), Xr_loc, md, "data"))
    return out


def _rank_main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from gaussianprocesses_jl_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)  # the ranks share the machine's cores
    initialize_distributed(f"file://{init_file}", world, rank)
    try:
        res = measure_paths(world)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def run_job(world: int, timeout: float = 600.0) -> dict:
    """{path: {"ops", "iterations", "per_iter"}} of a gloo job of `world`
    processes; raises if a rank fails or the ranks disagree."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, "-m", "gaussianprocesses_jl_tpu_torch.perf."
                                   "comm_model", "--rank", str(r), "--world", str(world),
                                   "--init", os.path.join(tmp, "rendezvous"), "--out", tmp],
                                  cwd=HERE.parents[1], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError(f"a rank of the {world}-process job failed:\n" + "\n".join(logs))
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(world)]
    if any(r != ranks[0] for r in ranks[1:]):
        raise RuntimeError(f"the ranks of the {world}-process job counted different traffic")
    out = ranks[0]
    for rec in out.values():
        k = rec["iterations"]
        rec["per_iter"] = {op: {"count": v["count"] / k, "bytes": v["bytes"] / k}
                           for op, v in rec["ops"].items()}
    return out


def _totals(ops: dict) -> tuple:
    return (sum(v["count"] for v in ops.values()), sum(v["bytes"] for v in ops.values()))


def efficiency_model(jobs: dict) -> list:
    """Predicted efficiency rows: {P: that job's measurements} -> a row for
    each path, link and P, from the traffic counted over P processes."""
    rows = []
    for path, cfg in CONFIGS.items():
        t_comp = cfg["t_comp_ms"] * 1e-3
        for link, spec in LINKS.items():
            for P in sorted(jobs):
                calls, nbytes = _totals(jobs[P][path]["per_iter"])
                calls, nbytes = calls * cfg["calls_scale"], nbytes * cfg["bytes_scale"]
                t_comm = calls * spec["latency_s"] * math.log2(P) + nbytes / spec["bw_B_per_s"]
                rows.append({"path": path, "config": cfg["config"], "link": link,
                             "processes": P, "calls_per_iter": calls,
                             "bytes_per_iter": nbytes, "t_comp_per_iter_ms": cfg["t_comp_ms"],
                             "t_comp_source": cfg["source"], "scaling": cfg["rule"],
                             "t_comm_per_iter_ms": 1e3 * t_comm,
                             "efficiency_pct": 100 * t_comp / (t_comp + t_comm)})
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, nargs="+", default=[2, 4, 8])
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--init", help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.init, args.out)
        return 0
    jax_payloads = json.loads(JAX_JSON.read_text())["payloads"]
    jobs = {}
    for P in args.procs:
        jobs[P] = run_job(P)
        for path in PATHS:
            rec = jobs[P][path]
            print(json.dumps({"processes": P, "path": path, "port_total": rec["ops"],
                              "port_per_iter": rec["per_iter"],
                              "jax_8_devices": jax_payloads[JAX_KEYS[path]]}), flush=True)
    rows = efficiency_model(jobs)
    for r in rows:
        print(f"{r['path']:24s} {r['link']:8s} P={r['processes']}: comp "
              f"{r['t_comp_per_iter_ms']:.3f} ms, comm {r['t_comm_per_iter_ms']:.6f} ms -> "
              f"{r['efficiency_pct']:.3f}%")
    out = {"assumptions": {"links": LINKS, "configs": CONFIGS,
                           "method": "bytes and calls counted at parallel/collectives.py in "
                                     "gloo jobs of CPU processes; compute times measured on "
                                     "one NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5); "
                                     "link figures nominal"},
           "payloads": {str(P): job for P, job in jobs.items()},
           "jax_payloads_8_devices": {p: jax_payloads[JAX_KEYS[p]] for p in PATHS},
           "efficiency": rows}
    OUT_JSON.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT_JSON}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
