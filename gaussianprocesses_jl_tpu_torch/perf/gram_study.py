"""The stationary gram op on the card, forward and backward.

Run on a machine with one NVIDIA GPU:

    python -m gaussianprocesses_jl_tpu_torch.perf.gram_study

It reaches the op only through entry points that every version of the
package has (`launch_gram`, `gram` under autograd, `gram_plain`), so it
also measures another checkout's package when that checkout comes first on
the path: `PYTHONPATH=<checkout> python3 <this file>`.

1. forward: one symmetric SE gram, f32, d = 10, at n = 3000 and 16384: the
   kernel's own device time (torch.profiler), the time per call (CUDA
   events around back-to-back calls), the host's enqueue of one call, the
   bound, the plain version and `torch.cdist` (distance only) as yardsticks;
2. backward: the VJP of one gram as `_Gram.backward` runs it, on a random
   n x n cotangent at n = 3000: its device time, kernel launches and host
   enqueue per call, for the headline's SE (hyperparameters only), the
   flagship's SE, RQ and Matern 3/2, and an ARD SE (with the inputs'
   gradient);
3. batched: the GPA sampler's grams, 128 chains of Matern 3/2 ARD at
   n = 200, d = 5, f32, in one launch, forward and VJP (dp and dX), with the
   same numbers as 1 and the vmapped plain versions;
4. new shapes (`new_shapes`): configuration #5's grams, 1024 chains of SE
   at n = 60, d = 1, the inputs shared and p per chain, forward and VJP
   (dp); the elastic append's grams at d = 10, K(X, x_new) at 4096 x 64
   (over the capacity) and K(x_new) at 64 x 64, forward.
The last line of its output is the numbers as one JSON object.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.utils import graphs
from gaussianprocesses_jl_tpu_torch.utils.profiling import device_ms_by_name

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS", "F64_FLOPS", "gram_bound_ms", "gram_vjp_bound_ms",
           "time_ms", "enqueue_ms", "profile_ms", "forward", "backward_cases", "backward",
           "batched", "new_shapes", "launches"]

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores
F64_FLOPS = 34e12
D = 10


def launches(fn):
    """(fn(), (gram launches, gram_vjp launches)) of one call, the counts
    (and `gram_op.LAUNCH_SHAPES`) set to 0 before it and read after it."""
    for name in gram_op.LAUNCHES:
        gram_op.LAUNCHES[name] = 0
    gram_op.LAUNCH_SHAPES.clear()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, (gram_op.LAUNCHES["gram"], gram_op.LAUNCHES["gram_vjp"])


def by_shape() -> dict:
    """`gram_op.LAUNCH_SHAPES` by name: {"gram 60x60": launches, "gram cross
    512x100000": launches, ...}, "cross" where the launch walked K(X1, X2)."""
    return {f"{k}{' cross' if cross else ''} {n1}x{n2}": v
            for (k, n1, n2, cross), v in sorted(gram_op.LAUNCH_SHAPES.items())}


def gram_bound_ms(n1, n2, d, itemsize, sym, chains=1, x_per_chain=False):
    """Least time for one gram (or `chains` grams in one launch, their
    inputs per chain or shared): inputs read once and the output written
    once at the memory rate, or ~3d + 4 operations per output at the
    non-tensor rate, whichever is larger."""
    xc = chains if x_per_chain else 1
    nbytes = itemsize * (xc * (n1 * d + (0 if sym else n2 * d)) + chains * (3 + n1 * n2))
    ops = chains * n1 * n2 * (3 * d + 4)
    peak = F32_FLOPS if itemsize == 4 else F64_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gram_vjp_bound_ms(n1, n2, d, itemsize, sym, need_dx, chains=1, x_per_chain=False):
    """Least time for one VJP (or `chains` of them in one launch): the
    cotangent, the inputs and p read once and dp (and the inputs' gradients,
    one a chain) written once at the memory rate, or the kernel's own
    operations at the non-tensor rate, whichever is larger. Operations per
    pair (the n (n + 1) / 2 pairs i >= j of a symmetric gram): 3d for the
    distance, 16 for the profile, its derivatives and the three sums, and
    with the inputs' gradient 4d + 4 for W and the row and column
    products."""
    xsize = n1 * d + (0 if sym else n2 * d)
    xc = chains if x_per_chain else 1
    nbytes = itemsize * (chains * (n1 * n2 + 6 + (xsize if need_dx else 0)) + xc * xsize)
    pairs = n1 * (n1 + 1) // 2 if sym else n1 * n2
    ops = chains * pairs * (3 * d + 16 + (4 * d + 4 if need_dx else 0))
    peak = F32_FLOPS if itemsize == 4 else F64_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def eagerly(fn):
    """fn with its CUDA graphs' work run eagerly (`utils/graphs.eager()`):
    the other half of a graph-against-eager comparison."""
    def call(*args, **kwargs):
        with graphs.eager():
            return fn(*args, **kwargs)

    return call


def time_ms(fn, reps=20, warmup=3) -> float:
    """Median milliseconds of fn() over `reps` runs, each between two CUDA
    events, after `warmup` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def enqueue_ms(fn, reps=20) -> float:
    """Median host milliseconds for fn() to return, without waiting for the
    card: near the CUDA-event time, the call is bound by the host."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def profile_ms(fn, reps=10, match=None) -> tuple:
    """(device ms, kernel launches, {kernel: device ms}) per call of fn under
    torch.profiler, over the kernels whose name holds `match` (all kernels
    if None)."""
    kernels, _ = device_ms_by_name(fn, reps=reps, warmup=2)
    mine = {key: (ms, calls) for key, (ms, calls) in kernels.items()
            if match is None or match in key}
    if not mine:
        raise RuntimeError(f"torch.profiler saw no kernel named like {match!r}")
    return (sum(ms for ms, _ in mine.values()), sum(calls for _, calls in mine.values()),
            {key: ms for key, (ms, _) in mine.items()})


def forward(device, ns=(3000, 16384)) -> dict:
    """{n: {...}} for one symmetric SE gram, f32, d = 10."""
    out = {}
    for n in ns:
        X = torch.as_tensor(np.random.RandomState(3).randn(n, D), dtype=torch.float32,
                            device=device)
        p = torch.zeros(3, dtype=torch.float32, device=device)
        call = lambda: gram_op.launch_gram(gram_op.SE, p, X)  # noqa: E731
        own, launches, _ = profile_ms(call, match="gram_kernel")
        bound, by = gram_bound_ms(n, n, D, 4, True)
        row = {"own_ms": own, "launches_per_call": launches, "call_ms": time_ms(call),
               "enqueue_ms": enqueue_ms(call), "bound_ms": bound, "bound_by": by,
               "plain_ms": time_ms(lambda: gram_op.gram_plain(gram_op.SE, p, X)),
               "cdist_ms": time_ms(lambda: torch.cdist(X, X))}
        out[n] = row
        print(f"forward SE f32 n={n}: own {own:.4f} ms ({100 * bound / own:.1f}% of the "
              f"{by} bound {bound:.4f} ms), call {row['call_ms']:.4f} ms, enqueue "
              f"{row['enqueue_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, torch.cdist "
              f"{row['cdist_ms']:.4f} ms", flush=True)
    return out


def backward_cases():
    """(name, kernel module): the main path's grams, and one ARD gram."""
    return [("headline SE", gp.SE(0.0, 0.0)),
            ("flagship SE", gp.SE(0.2, 0.1)),
            ("flagship RQ", gp.RQ(0.1, 0.0, -0.2)),
            ("flagship Mat32", gp.Matern(1.5, 0.3, 0.0)),
            ("ARD SE (with dX)", gp.SE(np.linspace(-0.2, 0.3, D), 0.1))]


def backward(device, n=3000) -> dict:
    """{case: {"device_ms", "launches", "enqueue_ms"}} per backward call of
    one gram, f32, on a random cotangent, with the hyperparameters (and, for
    ARD, the inputs through their scaling) needing gradients."""
    X = torch.as_tensor(np.random.RandomState(4).randn(n, D), dtype=torch.float32,
                        device=device)
    G = torch.as_tensor(np.random.RandomState(5).randn(n, n), dtype=torch.float32,
                        device=device)
    out = {}
    for name, kern in backward_cases():
        k = kern.to(dtype=torch.float32, device=device)
        vec = k.flat_params().detach().requires_grad_()
        K = k.with_flat_params(vec).gram(X)
        call = lambda: torch.autograd.grad(K, vec, G, retain_graph=True)  # noqa: E731
        dev_ms, launches, _ = profile_ms(call)
        row = {"device_ms": dev_ms, "launches": launches, "enqueue_ms": enqueue_ms(call),
               "call_ms": time_ms(call)}
        out[name] = row
        print(f"backward {name} f32 n={n}: device {dev_ms:.4f} ms in {launches:.0f} "
              f"launches, enqueue {row['enqueue_ms']:.4f} ms, call {row['call_ms']:.4f} ms",
              flush=True)
    return out


def _rows(cases, label="") -> dict:
    """{name: row} of (name, call, kernel name to match, plain version,
    (bound ms, bound by), extra keys, a callable one measured): own device
    time, launches a call, time a call, host enqueue, bound and the plain
    version's time, each printed after `label`."""
    out = {}
    for name, call, match, plain, (bound, by), extra in cases:
        own, launches, _ = profile_ms(call, match=match)
        extra = {k: (v() if callable(v) else v) for k, v in extra.items()}
        out[name] = row = {**extra, "own_ms": own, "launches_per_call": launches,
                           "call_ms": time_ms(call), "enqueue_ms": enqueue_ms(call),
                           "bound_ms": bound, "bound_by": by, "plain_ms": time_ms(plain)}
        print(f"{label}{name} f32: own {own:.4f} ms ({100 * bound / own:.1f}% of the {by} bound "
              f"{bound:.4f} ms), call {row['call_ms']:.4f} ms, enqueue "
              f"{row['enqueue_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
              + (f", torch.cdist {row['cdist_ms']:.4f} ms" if "cdist_ms" in row else ""),
              flush=True)
    return out


def new_shapes(device, chains=1024, n=60, n_el=4096, k=64, d_el=10) -> dict:
    """The grams of configuration #5 (`chains` SE grams at n points in d = 1,
    the inputs shared, p per chain, in one launch; the VJP for dp alone, as
    the sampler's target asks) and of the elastic append (K(X, x_new) over
    the capacity, n_el x k, and K(x_new) at k x k, d = 10), f32. Batched `torch.cdist`
    beside configuration #5's forward."""
    rng = np.random.RandomState(24)
    f32 = dict(dtype=torch.float32, device=device)
    X = torch.as_tensor(np.sort(2 * np.pi * rng.rand(n))[:, None], **f32)
    P = torch.as_tensor(np.stack([0.3 * rng.randn(chains), 0.3 * rng.randn(chains),
                                  np.zeros(chains)], axis=1), **f32)
    G = torch.as_tensor(rng.randn(chains, n, n), **f32)
    Xc = X.expand(chains, n, 1).contiguous()
    Xe = torch.as_tensor(rng.randn(n_el, d_el), **f32)
    Xk = torch.as_tensor(rng.randn(k, d_el), **f32)
    p = torch.zeros(3, **f32)
    se, dp = gram_op.SE, (True, False, False)
    return _rows([
        (f"config5 gram C={chains} n={n}", lambda: gram_op.launch_gram(se, P, X), "gram_kernel",
         lambda: gram_op.gram_plain(se, P, X), gram_bound_ms(n, n, 1, 4, True, chains),
         {"chains": chains, "n": n, "d": 1, "cdist_ms": lambda: time_ms(
             lambda: torch.cdist(Xc, Xc))}),
        (f"config5 gram_vjp dp C={chains} n={n}",
         lambda: gram_op.launch_gram_vjp(se, P, X, None, G, dp), "gram_vjp",
         lambda: gram_op.gram_vjp_plain(se, P, X, None, G, dp),
         gram_vjp_bound_ms(n, n, 1, 4, True, False, chains), {"chains": chains, "n": n, "d": 1}),
        (f"elastic cross gram {n_el}x{k}", lambda: gram_op.launch_gram(se, p, Xe, Xk),
         "gram_kernel", lambda: gram_op.gram_plain(se, p, Xe, Xk),
         gram_bound_ms(n_el, k, d_el, 4, False), {"n1": n_el, "n2": k, "d": d_el}),
        (f"elastic block gram {k}x{k}", lambda: gram_op.launch_gram(se, p, Xk), "gram_kernel",
         lambda: gram_op.gram_plain(se, p, Xk), gram_bound_ms(k, k, d_el, 4, True),
         {"n1": k, "n2": k, "d": d_el}),
    ])


def batched(device) -> dict:
    """{"forward": {...}, "gram_vjp": {...}} for the GPA sampler's grams: C
    Matern 3/2 ARD grams in one launch, each chain's inputs scaled by its
    own length scales (X (C, n, d)), f32, and their VJP with dp and dX on a
    random cotangent. The plain versions are the vmapped `gram_plain` and
    `gram_vjp_plain`; `torch.cdist` (distance only) batched beside the
    forward."""
    chains, n, d = 128, 200, 5
    rng = np.random.RandomState(6)
    f32 = dict(dtype=torch.float32, device=device)
    A = torch.as_tensor(rng.randn(chains, n, d), **f32)
    P = torch.as_tensor(0.1 * rng.randn(chains, 3), **f32)
    P[:, 1] = 0.0  # ARD: the length scales are in the inputs
    G = torch.as_tensor(rng.randn(chains, n, n), **f32)
    fam, needs = gram_op.MAT32, (True, True, False)
    shape = {"chains": chains, "n": n, "d": d}
    return _rows([
        ("forward", lambda: gram_op.launch_gram(fam, P, A), "gram_kernel",
         lambda: gram_op.gram_plain(fam, P, A), gram_bound_ms(n, n, d, 4, True, chains, True),
         {**shape, "cdist_ms": lambda: time_ms(lambda: torch.cdist(A, A))}),
        ("gram_vjp", lambda: gram_op.launch_gram_vjp(fam, P, A, None, G, needs), "gram_vjp",
         lambda: gram_op.gram_vjp_plain(fam, P, A, None, G, needs),
         gram_vjp_bound_ms(n, n, d, 4, True, True, chains, True), shape),
    ], label=f"batched Mat32 ARD C={chains} n={n} d={d} ")


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("gram_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"package: {gp.__file__}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    result = {"forward": forward(dev), "backward": backward(dev), "batched": batched(dev),
              "new_shapes": new_shapes(dev)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
