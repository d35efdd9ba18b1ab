"""BASELINE configuration #4 on the card: FITC at N = 100 000.

The JAX bench's `bench_fitc100k` (`bench.py:741-815`) on one device, without
the mesh: N = 100 000 observations, m = 512 inducing rows, d = 4, f32,
SE(0, 0), lognoise -1, the data, inducing rows and targets drawn from
`RandomState(0)` exactly as the bench draws them. Adam with lr 0.05 on the
flat parameters, with the bench's reject-don't-commit guard (a step whose
loss or gradient is not finite rolls back to the last good parameters and
steps with a zero gradient), the loss read back each step.

    python -m gaussianprocesses_jl_tpu_torch.perf.fitc_study             # on the card
    python -m gaussianprocesses_jl_tpu_torch.perf.fitc_study --f32-gap   # on the CPU

On the card it prints, for 2 warm-up and 6 timed steps: ms per step (CUDA
events), one step's host enqueue and device-busy time and its split by
kernel and by operator (torch.profiler), a whole step through its CUDA
graph and eager (`step_times`), the loss trace (finite, falling),
the gram and VJP launches a step (2 + 2: K(Xu) and K(Xu, X), each shape
counted), and the cross gram K(Xu, X) alone, 512 x 100 000, forward and
VJP: own device time against the byte bound, time per call and the plain
version's. The last
line of its output is the numbers as one JSON object.

`--f32-gap` measures on the CPU how far the f32 model's mll and gradient
stand from f64's at N = 10 000 over four states: the ground of
chip_smoke's tolerance for FITC in f32 on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.inference.vi import _value_and_grad, adam_update
from gaussianprocesses_jl_tpu_torch.models.gpe import gpe_mll
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.utils import graphs

__all__ = ["N", "M", "D_FEAT", "LR", "config4_data", "config4_model", "FitcAdam",
           "gap_states", "f32_gap", "cross_gram", "run", "WARMUP", "STEPS"]

N, M, D_FEAT = 100_000, 512, 4
LR = 0.05
N_GAP = 10_000  # chip_smoke's f32 check and --f32-gap


def config4_data(n=N):
    """(X, y, Xu) as bench.py draws them: f32 numpy arrays."""
    rng = np.random.RandomState(0)
    X = rng.randn(n, D_FEAT).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.5 * np.cos(X[:, 1]) + 0.1 * rng.randn(n)).astype(np.float32)
    Xu = X[rng.choice(n, M, replace=False)].copy()
    return X, y, Xu


def config4_model(device, n=N, dtype=np.float32):
    """FITC(X, Xu, y, SE(0, 0), lognoise -1) on `device` in `dtype`."""
    X, y, Xu = config4_data(n)
    return gp.FITC(X.astype(dtype), Xu.astype(dtype), y.astype(dtype), kernel=gp.SE(0.0, 0.0),
                   lognoise=-1.0, device=device)


class FitcAdam:
    """Adam (lr 0.05, `inference/vi.adam_update`) on the model's flat
    parameters against -mll, with the reject-don't-commit guard. `step()`
    returns the loss at the parameters it evaluated, read back to the host;
    on the card the step (value, gradient, guard and update) is one CUDA
    graph kept for the trainer."""

    def __init__(self, model, lr=LR):
        self.model, self.lr = model, lr
        theta = model.params.flat_params().detach().clone()
        zeros = torch.zeros_like(theta)
        # (theta, the last good theta, Adam's moments and step count)
        self.state = (theta, theta.clone(), zeros, zeros.clone(), theta.new_zeros(()))

    @property
    def theta(self):
        return self.state[0]

    def loss(self, theta):
        m = self.model
        return -gpe_mll(m.params.with_flat_params(theta), m.x, m.y, m.covstrat)[0]

    def loss_and_grad(self, theta=None):
        return _value_and_grad(self.loss, self.theta if theta is None else theta)

    def _step(self, theta, last_good, m, v, t):
        loss, g = self.loss_and_grad(theta)
        ok = torch.isfinite(loss) & torch.isfinite(g).all()
        base = torch.where(ok, theta, last_good)
        g = torch.where(ok, g, torch.zeros_like(g))
        theta, m, v, t = adam_update(base, g, m, v, t, self.lr)
        return theta, base, m, v, t, loss

    def step(self) -> float:
        *self.state, loss = graphs.run(self, self._step, *self.state, static="fitc_adam")
        return float(loss)


def gap_states(model, k=4):
    """The model's flat start and k - 1 states scattered 0.3 around it."""
    x0 = model.params.flat_params().detach().cpu().numpy().astype(np.float64)
    rng = np.random.RandomState(17)
    return [x0] + [x0 + 0.3 * rng.randn(x0.size) for _ in range(k - 1)]


def mll_and_grad(model, vec):
    m = model.set_params(vec)
    theta = m.params.flat_params().detach().requires_grad_()
    mll = gpe_mll(m.params.with_flat_params(theta), m.x, m.y, m.covstrat)[0]
    (g,) = torch.autograd.grad(mll, theta)
    return float(mll.detach()), g.cpu().numpy().astype(np.float64)


def _gap(a, b):
    """(|mll_a - mll_b| / |mll_b|, max|g_a - g_b| / max|g_b|)."""
    return abs(a[0] - b[0]) / abs(b[0]), float(np.abs(a[1] - b[1]).max() / np.abs(b[1]).max())


def f32_gap() -> list:
    """For each of `gap_states` at N = N_GAP, on the CPU, as (relative mll, gradient over
    max|g|): the f32 model against f64 ("f32_vs_f64"; the f32 model's
    relative jitter on Kuu, 1e-4 against 1e-10, is most of it), and the f32
    model against itself on the rows permuted ("f32_reordered": f32 rounding
    alone, the mll being invariant under a permutation)."""
    X, y, Xu = config4_data(N_GAP)
    perm = np.random.RandomState(5).permutation(N_GAP)
    m32 = config4_model("cpu", N_GAP, np.float32)
    m64 = config4_model("cpu", N_GAP, np.float64)
    p32 = gp.FITC(X[perm], Xu, y[perm], kernel=gp.SE(0.0, 0.0), lognoise=-1.0, device="cpu")
    out = []
    for vec in gap_states(m64):
        r32, r64, rp = (mll_and_grad(m, vec) for m in (m32, m64, p32))
        out.append({"state": vec.tolist(), "mll_f64": r64[0], "mll_f32": r32[0],
                    "f32_vs_f64": _gap(r32, r64), "f32_reordered": _gap(rp, r32)})
        print(f"  state {np.round(vec, 3).tolist()}: mll f64 {r64[0]:.6f}, f32 {r32[0]:.6f}; "
              f"f32 vs f64 {out[-1]['f32_vs_f64'][0]:.3e} (gradient "
              f"{out[-1]['f32_vs_f64'][1]:.3e} of max|g|); f32 reordered "
              f"{out[-1]['f32_reordered'][0]:.3e} ({out[-1]['f32_reordered'][1]:.3e})",
              flush=True)
    return out


def cross_gram(device) -> dict:
    """K(Xu, X) alone, SE, 512 x 100 000, d = 4, f32: forward (`launch_gram`) and
    VJP with dp only (`launch_gram_vjp`, as the FITC step runs it) on a
    random cotangent: own device time, kernels a call, time per call, host
    enqueue, bound and plain version."""
    from gaussianprocesses_jl_tpu_torch.perf.gram_study import (
        enqueue_ms, gram_bound_ms, gram_vjp_bound_ms, profile_ms, time_ms)

    X, _, Xu = config4_data()
    f32 = dict(dtype=torch.float32, device=device)
    X, Xu = torch.as_tensor(X, **f32), torch.as_tensor(Xu, **f32)
    p = torch.zeros(3, **f32)
    G = torch.randn((M, N), generator=torch.Generator(device=device).manual_seed(4), **f32)
    needs = (True, False, False)
    fam = gram_op.SE
    out = {}
    for name, call, match, plain, (bound, by) in (
            ("gram", lambda: gram_op.launch_gram(fam, p, Xu, X), "gram_kernel",
             lambda: gram_op.gram_plain(fam, p, Xu, X), gram_bound_ms(M, N, D_FEAT, 4, False)),
            ("gram_vjp", lambda: gram_op.launch_gram_vjp(fam, p, Xu, X, G, needs), "gram_vjp",
             lambda: gram_op.gram_vjp_plain(fam, p, Xu, X, G, needs),
             gram_vjp_bound_ms(M, N, D_FEAT, 4, False, False))):
        own, launches, _ = profile_ms(call, match=match)
        row = {"n1": M, "n2": N, "d": D_FEAT, "own_ms": own, "kernels_per_call": launches,
               "call_ms": time_ms(call), "enqueue_ms": enqueue_ms(call), "bound_ms": bound,
               "bound_by": by, "plain_ms": time_ms(plain, reps=5)}
        out[name] = row
        print(f"  cross {name} SE f32 {M} x {N}: own {own:.4f} ms ({100 * bound / own:.1f}% "
              f"of the {by} bound {bound:.4f} ms), call {row['call_ms']:.4f} ms, enqueue "
              f"{row['enqueue_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms", flush=True)
    return out


WARMUP, STEPS = 2, 6


def run(device) -> dict:
    """The bench's loop: WARMUP steps, then STEPS timed ones, each reading
    its loss back; one step's launches, enqueue and device profile. Raises
    if a loss is not finite, the last is not below the first, or a step
    launches other than 2 + 2 kernels."""
    from gaussianprocesses_jl_tpu_torch.perf.gram_study import enqueue_ms, launches
    from gaussianprocesses_jl_tpu_torch.utils.profiling import device_profile

    t0 = time.perf_counter()
    model = config4_model(device)
    trainer = FitcAdam(model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = [trainer.step() for _ in range(WARMUP)]
    step_ms = []
    for _ in range(STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.step())
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    _, n_launch = launches(trainer.loss_and_grad)
    cross = (gram_op.LAUNCH_SHAPES["gram", M, N, True],
             gram_op.LAUNCH_SHAPES["gram_vjp", M, N, True])
    out = {"N": N, "m": M, "d": D_FEAT, "setup_s": setup_s, "losses": losses,
           "step_ms": step_ms, "step_ms_median": float(np.median(step_ms)),
           "gram_launches_per_step": n_launch[0], "gram_vjp_launches_per_step": n_launch[1],
           "cross_launches_per_step": cross,
           "enqueue_ms": enqueue_ms(trainer.loss_and_grad, reps=5),
           "peak_mib": torch.cuda.max_memory_allocated(device) / 2**20}
    print(f"FITC N={N} m={M}: losses {[round(v, 2) for v in losses]}; step "
          f"{out['step_ms_median']:.3f} ms (median of {STEPS}: "
          f"{[round(v, 3) for v in step_ms]}); {n_launch[0]} gram + {n_launch[1]} gram_vjp "
          f"launches a step, {cross[0]} + {cross[1]} of them K(Xu, X); enqueue "
          f"{out['enqueue_ms']:.3f} ms; peak {out['peak_mib']:.0f} MiB", flush=True)
    busy, kernels, ops = device_profile(trainer.loss_and_grad, reps=3, top=12)
    out.update(busy_ms=busy, kernels=kernels, operators=ops)
    print(f"  one step's value and gradient: device busy {busy:.3f} ms", flush=True)
    for title, rows in (("kernels", kernels), ("operators", ops)):
        print(f"  {title} by self device time per step:")
        for key, ms, calls in rows:
            print(f"    {ms:9.4f} ms  {calls:3d} x {key[:90]}")
    out["step"] = step_times(model)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"FITC: loss not finite or not falling: {losses}")
    if n_launch != (2, 2) or cross != (1, 1):
        raise RuntimeError(f"FITC: {n_launch} gram and gram_vjp launches a step ({cross} at "
                           f"{M} x {N}), expected (2, 2) and (1, 1)")
    return out


def step_times(model) -> dict:
    """A whole step (value, gradient, guard, Adam update and the loss read
    back) through its CUDA graph and eager, each on a trainer of its own:
    CUDA-event ms (median of STEPS after WARMUP), host ms until the step
    returns, device-busy ms (torch.profiler; None where it saw no kernel)."""
    from gaussianprocesses_jl_tpu_torch.perf.gram_study import eagerly, enqueue_ms, time_ms
    from gaussianprocesses_jl_tpu_torch.utils.profiling import device_profile

    out = {}
    for label, way in (("graph", lambda f: f), ("eager", eagerly)):
        step = way(FitcAdam(model).step)
        busy, kernels, _ = device_profile(step, reps=3)
        out[label] = {"event_ms": time_ms(step, reps=STEPS, warmup=WARMUP),
                      "host_ms": enqueue_ms(step, reps=STEPS),
                      "busy_ms": busy if kernels else None}
    print("  a step: " + ", ".join(
        f"{k} {v['event_ms']:.3f} ms events, {v['host_ms']:.3f} ms host, {v['busy_ms']} ms busy"
        for k, v in out.items()), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32-gap", action="store_true",
                    help="measure the f32 model's distance from f64 on the CPU")
    args = ap.parse_args(argv)
    if args.f32_gap:
        print(json.dumps({"f32_gap": f32_gap()}))
        return 0
    if not torch.cuda.is_available():
        print("fitc_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    result = {"run": run(dev), "cross_gram": cross_gram(dev)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
