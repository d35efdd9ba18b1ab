"""BASELINE configuration #3 on the card: Poisson regression by mean-field VI.

The model and data of `examples/poisson_regression.py`'s VI training demo:
n = 4096 counts at t = sort(12 U) from `RandomState(7)`, rate exp(1 +
0.6 sin t + 0.3 cos 2.3 t), `Matern(1.5, log 0.5, 0)` with `PoisLik`, f32, on
one card (the JAX demo shards the observations over a mesh; this is the
single-device path). `vi(method="adam", lr=0.05, nits=150)`.

    python -m gaussianprocesses_jl_tpu_torch.perf.vi_study             # on the card
    python -m gaussianprocesses_jl_tpu_torch.perf.vi_study --f32-gap   # on the CPU

On the card it prints:
- the set-up (`make_neg_elbo`: the prior's factor and diag(K^-1)), timed
  alone by CUDA events, cold and warm, and whether the f32 factor held,
  on the card and on the CPU (with the plain gram's expansion of r2, and
  by direct differences);
- the fit through `vi`, its whole time (the process's first fit, then the
  same fit again) and its launches (1 gram, no VJP);
- an Adam step (`inference/vi.adam_step`) from the fit's end, through its
  CUDA graph and eager (`graphs.eager()`): the median of STEPS steps timed
  one by one by CUDA events after WARMUP steps, one step's host enqueue
  and its device-busy time (torch.profiler);
- the ELBO before and after, the rate exp(m + v / 2)'s correlation with
  the counts;
- the negative ELBO's value and gradient at theta0 and at the fit, f32 on
  the card against f64 at the same nugget (1e-4) on the card and against
  f32 on the CPU, and f64 on the card against f64 on the CPU at both
  nuggets (1e-4, and f64's own 1e-6), the CPU's gram by direct
  differences as the kernel's;
- the latent predictive at the training points from the fit's Q, on the
  card and on the CPU: f32 against f64 at f32's nugget (f32 rounding
  alone), f64 at 1e-4 against f64 at 1e-6 (the nugget alone), and the card
  against the CPU.

`--f32-gap` measures on the CPU what grounds chip_smoke's tolerances:
whether the f32 factor holds there, and how far the f64 objective and
predictive move on the observations permuted (the factorization's
rounding) and with the gram by direct differences (the gram's rounding),
with the nugget's effect on the predictive.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.inference import vi as vi_mod
from gaussianprocesses_jl_tpu_torch.models.gpa import gpa_nugget
from gaussianprocesses_jl_tpu_torch.ops import distance
from gaussianprocesses_jl_tpu_torch.utils import graphs

__all__ = ["N", "NITS", "LR", "WARMUP", "STEPS", "F32_NUGGET", "config3_data", "config3_model",
           "value_and_grad", "predictives", "factor_ok", "gap", "run", "f32_gap"]

N, NITS, LR = 4096, 150, 0.05
WARMUP, STEPS = 5, 30
F32_NUGGET = gpa_nugget(torch.float32)  # 1e-4; f64's own is 1e-6


def config3_data():
    rng = np.random.RandomState(7)
    t = np.sort(rng.rand(N) * 12.0)
    f = 1.0 + 0.6 * np.sin(t) + 0.3 * np.cos(2.3 * t)
    return t, rng.poisson(np.exp(f)).astype(float)


def config3_model(device, dtype=np.float32, perm=None):
    """The model on `device` in `dtype`, its observations in `perm`'s order
    where one is given."""
    t, y = config3_data()
    if perm is not None:
        t, y = t[perm], y[perm]
    return gp.GPA(t[:, None].astype(dtype), y.astype(dtype), gp.MeanZero(),
                  gp.Matern(1.5, np.log(0.5), 0.0), gp.PoisLik(), device=device)


def value_and_grad(neg_elbo, theta, like):
    """neg_elbo's value and gradient at theta (cast to `like`'s dtype and
    device), both in f64 on the host."""
    th = theta.detach().to(like).requires_grad_()
    val = neg_elbo(th)
    (g,) = torch.autograd.grad(val, th)
    return float(val.detach()), g.double().cpu().numpy()


def gap(a, b) -> tuple:
    """(|a0 - b0| / |b0|, max|a1 - b1| / max|b1|) of two (value, vector)
    pairs, or of two (mean, variance) pairs as fractions of their max."""
    def rel(x, y):
        x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
        return float(np.abs(x - y).max() / np.abs(y).max())

    return rel(a[0], b[0]), rel(a[1], b[1])


def predictives(Q, device, perm=None) -> dict:
    """vi_predict_f at the training points from one Q on `device` (its
    observations in `perm`'s order where given): "f32" (nugget 1e-4),
    "f64_1e-4" and "f64" (its own 1e-6), each (mean, var) as f64 numpy."""
    out = {}
    for name, dtype, nugget in (("f32", np.float32, None), ("f64_1e-4", np.float64, F32_NUGGET),
                                ("f64", np.float64, None)):
        m = config3_model(device, dtype, perm)
        Qd = vi_mod.Approx(m=Q.m.to(m.x), v=Q.v.to(m.x))
        if perm is not None:
            idx = torch.as_tensor(perm, device=m.x.device)
            Qd = vi_mod.Approx(m=Qd.m[idx], v=Qd.v[idx])
        mu, var = gp.vi_predict_f(m, Qd, m.x, nugget=nugget)
        out[name] = (mu.double().cpu().numpy(), var.double().cpu().numpy())
    return out


def factor_ok(device) -> bool:
    """Whether the f32 model's prior factor of K + 1e-4 I holds on `device`."""
    m = config3_model(device)
    return bool(m.covstrat.build(m.params.kernel, gpa_nugget(m.dtype), m.x).ok)


def _objectives(device):
    """(neg_elbo, the model's inputs) of the f32 model and of the f64 model
    at both nuggets."""
    m32, m64 = config3_model(device), config3_model(device, np.float64)
    return {"f32": (vi_mod.make_neg_elbo(m32)[0], m32.x),
            "f64_1e-4": (vi_mod.make_neg_elbo(m64, F32_NUGGET)[0], m64.x),
            "f64": (vi_mod.make_neg_elbo(m64)[0], m64.x)}


def _events_ms(fn):
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def run(device) -> dict:
    """The fit and its checks' numbers (no thresholds here: chip_smoke holds
    them)."""
    from gaussianprocesses_jl_tpu_torch.perf.gram_study import enqueue_ms, launches
    from gaussianprocesses_jl_tpu_torch.utils.profiling import device_profile

    m = config3_model(device)
    setup_ms = []
    for _ in range(2):  # cold, then warm
        (neg_elbo, theta0, _), ms = _events_ms(lambda: vi_mod.make_neg_elbo(m))
        setup_ms.append(ms)
    ok_card, ok_cpu = factor_ok(device), factor_ok("cpu")
    with _direct_differences():
        ok_cpu_direct = factor_ok("cpu")
    elbo0 = -float(neg_elbo(theta0))
    fit_ms = []
    for _ in range(2):  # the first fit of the process, then the same fit again
        (Q, fit_launches), ms = _events_ms(
            lambda: launches(lambda: gp.vi(m, nits=NITS, method="adam", lr=LR)))
        fit_ms.append(ms)
    theta_fit = torch.cat([Q.m, 0.5 * torch.log(Q.v)])

    # the fit's step alone, from the fit's end: its CUDA graph, and eager
    step = {}
    for label, way in (("graph", contextlib.nullcontext), ("eager", graphs.eager)):
        state = [vi_mod.adam_init(theta_fit)]

        def one_step():
            with way():
                state[0] = vi_mod.adam_step(neg_elbo, state[0], LR)[0]

        for _ in range(WARMUP):
            one_step()
        times = [_events_ms(one_step)[1] for _ in range(STEPS)]
        busy, kernels, _ = device_profile(one_step, reps=3)
        step[label] = {"event_ms": statistics.median(times), "event_ms_all": times,
                       "enqueue_ms": enqueue_ms(one_step, reps=10),
                       "busy_ms": busy if kernels else None}

    elbo1 = float(gp.elbo(m, Q.m, Q.v))
    rate = torch.exp(Q.m + 0.5 * Q.v).cpu().numpy()
    corr = float(np.corrcoef(rate, m.y.cpu().numpy())[0, 1])

    # the objective at theta0 and at the fit, on the card and on the CPU
    # (its gram by direct differences, as the kernel takes them)
    card, obj_launches = launches(lambda: _objectives(device))
    with _direct_differences():
        cpu = _objectives("cpu")
    objective = {}
    for at, th in (("theta0", theta0), ("fit", theta_fit)):
        c = {k: value_and_grad(f, th, like) for k, (f, like) in card.items()}
        h = {k: value_and_grad(f, th, like) for k, (f, like) in cpu.items()}
        objective[at] = {
            "f32_card_vs_f64_card_1e-4": gap(c["f32"], c["f64_1e-4"]),
            "f64_card_vs_cpu_1e-4": gap(c["f64_1e-4"], h["f64_1e-4"]),
            "f64_card_vs_cpu": gap(c["f64"], h["f64"]),
            "f32_card_vs_f32_cpu": gap(c["f32"], h["f32"]),
            "finite": bool(all(np.isfinite(v[0]) and np.isfinite(v[1]).all()
                               for v in c.values()))}
    del card, cpu

    # the predictive from the fit's Q, on the card and on the CPU
    (pc, n_pred) = launches(lambda: predictives(Q, device))
    with _direct_differences():
        ph = predictives(Q, "cpu")
    predictive = {
        "card_f32_vs_f64_1e-4": gap(pc["f32"], pc["f64_1e-4"]),
        "card_f64_1e-4_vs_f64_1e-6": gap(pc["f64_1e-4"], pc["f64"]),
        "cpu_f32_vs_f64_1e-4": gap(ph["f32"], ph["f64_1e-4"]),
        "f64_1e-4_card_vs_cpu": gap(pc["f64_1e-4"], ph["f64_1e-4"]),
        "f64_card_vs_cpu": gap(pc["f64"], ph["f64"]),
        "finite": bool(all(np.isfinite(a).all() for v in pc.values() for a in v))}
    out = {"n": N, "nits": NITS, "elbo0": elbo0, "elbo": elbo1, "factor_ok": ok_card,
           "cpu_f32_factor_ok": ok_cpu, "cpu_f32_factor_ok_direct": ok_cpu_direct,
           "setup_ms": setup_ms, "fit_ms": fit_ms,
           "step_ms": step["graph"]["event_ms"], "step": step,
           "fit_launches": fit_launches, "objective_launches": obj_launches,
           "predict_launches": n_pred, "rate_corr": corr, "objective": objective,
           "predictive": predictive}
    print(f"VI Poisson n={N}: set-up {setup_ms[0]:.1f} ms cold, {setup_ms[1]:.1f} ms warm "
          f"(f32 factor held: {ok_card}, on the CPU {ok_cpu}, {ok_cpu_direct} by direct "
          f"differences); elbo {elbo0:.2f} -> "
          f"{elbo1:.2f} in {NITS} Adam steps, fit {fit_ms[0]:.1f} ms (again {fit_ms[1]:.1f} "
          f"ms); an Adam step (median of {STEPS} after {WARMUP}): " + ", ".join(
              f"{k} {v['event_ms']:.4f} ms events, {v['enqueue_ms']:.4f} ms enqueue, "
              f"{v['busy_ms']} ms busy" for k, v in step.items())
          + f"; launches: fit {fit_launches}, objectives {obj_launches}, "
          f"predictives {n_pred}; rate corr {corr:.3f}", flush=True)
    for at, row in objective.items():
        print(f"  neg_elbo at {at}: " + ", ".join(
            f"{k} {v[0]:.3e} (gradient {v[1]:.3e} of max)" for k, v in row.items()
            if k != "finite"), flush=True)
    print("  predictive (mean, var) as fractions of max: " + ", ".join(
        f"{k} {v}" for k, v in predictive.items()), flush=True)
    return out


def f32_gap() -> dict:
    """On the CPU: whether the f32 prior's factor holds, with the plain
    gram's expansion of r2 above its size budget and with direct
    differences as the kernel takes them; a fit in f64 at the f32 nugget;
    then, at theta0 and at that fit, the f64 objective (both nuggets) and
    the predictive against themselves on the observations permuted (the
    factorization's rounding) and with the gram by direct differences (the
    gram's rounding: what sets f64 on the card apart from f64 on the CPU
    otherwise); the f32 objective, by direct differences, against itself
    permuted (f32 rounding) and against f64 at its nugget; the f32
    predictive against f64 at its nugget, and the nugget's effect on the
    predictive."""
    t0 = time.perf_counter()
    perm = np.random.RandomState(5).permutation(N)
    m64, p64 = config3_model("cpu", np.float64), config3_model("cpu", np.float64, perm)
    neg_elbo, theta0, _ = vi_mod.make_neg_elbo(m64, F32_NUGGET)
    theta = vi_mod.adam(neg_elbo, theta0, NITS, LR)[0]
    Q = vi_mod.Approx(m=theta[:N], v=torch.exp(2.0 * theta[N:]))
    pp = torch.as_tensor(np.concatenate([perm, N + perm]))
    inv = np.argsort(perm)
    out = {"cpu_f32_factor_ok": factor_ok("cpu")}
    with _direct_differences():
        out["cpu_f32_factor_ok_direct"] = factor_ok("cpu")
        direct = {nugget: vi_mod.make_neg_elbo(m64, nugget)[0] for nugget in (F32_NUGGET, None)}
        m32, p32 = config3_model("cpu"), config3_model("cpu", np.float32, perm)
        f32, f32p = vi_mod.make_neg_elbo(m32)[0], vi_mod.make_neg_elbo(p32)[0]
        pr_direct = predictives(Q, "cpu")
    for at, th in (("theta0", theta0), ("fit", theta)):
        a, b = value_and_grad(f32, th, m32.x), value_and_grad(f32p, th[pp], m32.x)
        back = np.empty_like(b[1])
        back[pp.numpy()] = b[1]
        out[f"objective_f32_{at}_permuted_direct"] = gap(a, (b[0], back))
        out[f"objective_f32_vs_f64_1e-4_{at}_direct"] = gap(
            a, value_and_grad(direct[F32_NUGGET], th, m64.x))
    out["predictive_f32_vs_f64_1e-4_direct"] = gap(pr_direct["f32"], pr_direct["f64_1e-4"])
    for nugget, name in ((F32_NUGGET, "f64_1e-4"), (None, "f64")):
        f, fp = vi_mod.make_neg_elbo(m64, nugget)[0], vi_mod.make_neg_elbo(p64, nugget)[0]
        for at, th in (("theta0", theta0), ("fit", theta)):
            a, b = value_and_grad(f, th, m64.x), value_and_grad(fp, th[pp], m64.x)
            back = np.empty_like(b[1])
            back[pp.numpy()] = b[1]
            out[f"objective_{name}_{at}_permuted"] = gap(a, (b[0], back))
            out[f"objective_{name}_{at}_direct"] = gap(
                value_and_grad(direct[nugget], th, m64.x), a)
    pr, pp_ = predictives(Q, "cpu"), predictives(Q, "cpu", perm)
    for name in ("f64_1e-4", "f64"):
        out[f"predictive_{name}_permuted"] = gap(pr[name], tuple(v[inv] for v in pp_[name]))
        out[f"predictive_{name}_direct"] = gap(pr_direct[name], pr[name])
    out["predictive_f64_1e-4_vs_f64_1e-6"] = gap(pr["f64_1e-4"], pr["f64"])
    print(f"VI Poisson n={N} on the CPU ({time.perf_counter() - t0:.1f} s): "
          + ", ".join(f"{k} {v}" for k, v in out.items()), flush=True)
    return out


@contextlib.contextmanager
def _direct_differences():
    """The plain gram by direct differences at every size while open."""
    budget = distance._EXACT_BROADCAST_BUDGET
    distance._EXACT_BROADCAST_BUDGET = N * N
    try:
        yield
    finally:
        distance._EXACT_BROADCAST_BUDGET = budget


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32-gap", action="store_true",
                    help="measure on the CPU what grounds chip_smoke's tolerances")
    args = ap.parse_args(argv)
    if args.f32_gap:
        print(json.dumps({"f32_gap": f32_gap()}))
        return 0
    if not torch.cuda.is_available():
        print("vi_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(json.dumps(run(torch.device("cuda"))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
