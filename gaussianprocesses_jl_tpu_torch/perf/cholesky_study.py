"""The Cholesky kernel study on the card (counterpart of
`perf/pallas_cholesky_study.py`).

Run on a machine with one NVIDIA GPU:

    python -m gaussianprocesses_jl_tpu_torch.perf.cholesky_study [launch|gram|panel|single|full|all]

Five experiments, at the study's own sizes:

1. `launch` - the launch probe: one launch whose only work is a chain of
   n_iter dependent adds, so its time is one launch plus that chain; at
   n_iter = 0, one launch alone.
2. `gram`   - the study's SE gram, through the port's `csrc/gram.cu`,
   beside its plain version, at n in {1024, 3072, 8192, 16384}.
3. `panel`  - (L, L^-1) of one panel in one cooperative launch of
   `csrc/cholesky.cu` over the card, beside `torch.linalg.cholesky_ex` and
   cholesky_ex + `solve_triangular`, at B in {512, 1024}, and at B = 3072
   on the headline's SE gram + e^-2 I, with its grid and the grid syncs the
   kernel counted, and a fit of its times to a per-step cost and a product
   rate.
4. `single` - the whole factorization in one cooperative launch: checked
   at n = 2048, timed at n = 10240 beside `ops/linalg.py blocked_cholesky`,
   then one launch at n = 10240 with the grid syncs the kernel counted and
   its block-0 time stamps, split into correction, diagonal block and
   apply.
5. `full`   - the n = 10240 factorization four ways: cholesky_ex,
   `blocked_cholesky(block=1024)`, the same left-looking blocked loop with the
   panel kernel (`cholesky_blocked_panels`), and the single launch.

Times are `utils/profiling.device_time`: CUDA events around `reps` calls,
best of `trials`; a kernel's own time on the card comes from
`utils/profiling.device_ms_by_name`. Rates are TFLOP/s at n^3/3, as the
study reports them. Each experiment raises when its kernel leaves the
tolerance stated where it is checked.
Cross-panel products are `torch.matmul` in full f32 (TF32 stays off), where
the study used `Precision.HIGH`. The library calls are yardsticks only: the
port's own path never calls them here.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import NamedTuple

import torch

from ..ops import gram as gram_op
from ..ops.cholesky_kernels import (
    chol_inv_panel,
    chol_inv_panel_on_grid,
    chol_inv_panel_plain,
    launch_probe,
    max_grid_blocks,
    panel_grid_blocks,
    panel_grid_syncs,
    single_launch_cholesky,
    single_launch_cholesky_on_grid,
    single_launch_grid_syncs,
    single_launch_split,
)
from ..ops.linalg import blocked_cholesky
from ..utils.profiling import device_ms_by_name, device_time

__all__ = ["study_params", "se_gram_study", "cholesky_blocked_panels", "spd_test_matrix",
           "headline_panel_matrix", "PanelCase", "panel_fit",
           "study_launch_overhead", "study_gram", "study_panel",
           "correction_flops", "single_launch_stamped", "study_single_launch", "study_full"]

_F32 = torch.float32
# the study's SE hyperparameters: ll = 0.3, lsigma = 0.2
STUDY_LL, STUDY_LSIG = 0.3, 0.2
# the checks' tolerances: the panel's factors within 1e-5 of max|ref| (two
# f32 summation orders of a factorization each within ~1e-6 of f64); the
# study gram within 1e-5 e^p0 of its plain version (the plain version
# rounds r2 to a few ulp of |x|^2)
PANEL_RTOL = 1e-5
GRAM_ATOL = 1e-5


def study_params(device, ll: float = STUDY_LL, lsig: float = STUDY_LSIG) -> torch.Tensor:
    """The study's SE parameter vector [2 lsigma, exp(-2 ll)], f32 on
    `device`."""
    return torch.tensor([2.0 * lsig, math.exp(-2.0 * ll)], dtype=_F32, device=device)


def se_gram_study(X: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The study's `pallas_se_gram`: K[i, j] = exp(p0 - r2_ij p1 / 2) with
    params = [p0, p1] a tensor on X's device, f32, symmetric.

    It goes through the port's stationary gram kernel (`csrc/gram.cu`, SE
    branch, symmetric) with gram.cu's hyperparameters [lsigma, ll, extra] =
    [p0 / 2, -log(p1) / 2, 0], mapped on the device: no host copy, no wait
    for the card. That kernel pins the diagonal to exactly e^p0, where the
    TPU kernel's clamped expansion gave it to rounding."""
    X = X.to(_F32).contiguous()
    params = params.to(_F32)
    if params.shape != (2,) or params.device != X.device:
        raise ValueError(f"se_gram_study: need params of shape (2,) on {X.device}, "
                         f"got {tuple(params.shape)} on {params.device}")
    p = torch.cat([params[:1] / 2, params[1:].log() / -2, params.new_zeros(1)])
    return gram_op.gram(gram_op.SE, p, X)


def cholesky_blocked_panels(K: torch.Tensor, block: int = 1024, T: int = 128) -> torch.Tensor:
    """The study's `cholesky_blocked_pallas`: the left-looking blocked
    loop with each diagonal panel's (L, L^-1) from `chol_inv_panel`.
    Returns L. Cross-panel products are full-f32 `torch.matmul`."""
    n = K.shape[-1]
    B = block
    if K.ndim != 2 or K.shape[0] != n or n % B:
        raise ValueError(f"cholesky_blocked_panels: need a square matrix with n % block == 0, "
                         f"got shape {tuple(K.shape)}, block {B}")
    K = K.to(_F32)
    nb = n // B
    cols = []
    for k in range(nb):
        Acol = K[k * B:, k * B:(k + 1) * B]
        if k > 0:
            P = torch.cat([cols[j][(k - j) * B:, :] for j in range(k)], dim=1)
            Acol = Acol - P @ P[:B, :].T
        lkk, linv = chol_inv_panel(Acol[:B, :B], T=T)
        cols.append(torch.cat([lkk, Acol[B:, :] @ linv.T]) if k + 1 < nb else lkk)
    rows = []
    for i in range(nb):
        parts = [cols[j][(i - j) * B:(i - j + 1) * B, :] for j in range(i + 1)]
        if i + 1 < nb:
            parts.append(K.new_zeros((B, (nb - 1 - i) * B)))
        rows.append(torch.cat(parts, dim=1))
    return torch.cat(rows, dim=0)


def spd_test_matrix(n: int, rank: int, device, seed: int = 0) -> torch.Tensor:
    """W W^T + n I with W (n, rank) standard normal from `seed`: the study's
    test matrices, well conditioned at every n."""
    g = torch.Generator(device=device).manual_seed(seed)
    W = torch.randn((n, rank), generator=g, dtype=_F32, device=device)
    return W @ W.T + n * torch.eye(n, dtype=_F32, device=device)


def headline_panel_matrix(n: int, device, seed: int = 42) -> torch.Tensor:
    """The headline's SE(0, 0) gram at n points in d = 10 plus e^-2 I."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n, 10), generator=g, dtype=_F32, device=device)
    K = se_gram_study(X, torch.tensor([0.0, 1.0], dtype=_F32, device=device))
    return K + math.exp(-2.0) * torch.eye(n, dtype=_F32, device=device)


def _ms(fn, args, reps, trials=2) -> float:
    return 1e3 * device_time(fn, args, reps=reps, trials=trials)


def _report(label: str, ms: float, flops: float | None = None) -> None:
    rate = f"   {flops / ms / 1e9:.2f} TFLOP/s" if flops else ""
    print(f"{label:44s} {ms:10.4f} ms{rate}", flush=True)


def _rel_err(L: torch.Tensor, L0: torch.Tensor) -> float:
    L0 = L0.double()
    return float((L.double() - L0).abs().max() / L0.abs().max())


def _check(what: str, err: float, tol: float) -> None:
    if not err <= tol:  # also on NaN
        raise RuntimeError(f"{what}: error {err:.3e} above its tolerance {tol:g}")


def _kernel_ms(fn, args, name: str, reps: int) -> float:
    """Device milliseconds per call of the CUDA kernels whose name holds
    `name`: the card's own time, without the host's gaps between launches."""
    kernels, _ = device_ms_by_name(fn, args, reps=reps, warmup=1)
    mine = [ms for key, (ms, _) in kernels.items() if name in key]
    if not mine:
        raise RuntimeError(f"torch.profiler saw no kernel named like {name!r}")
    return sum(mine)


def study_launch_overhead(device="cuda", n_iters=(0, 512, 4096), reps=50) -> dict:
    """{n_iter: (ms per call, device ms per launch)} of the launch probe on
    a (512, 512) input of ones. The first is CUDA events around `reps`
    back-to-back calls, host wrapper included: what one launch costs its
    caller. The second is the kernel's own time on the card from
    torch.profiler (None on the CPU): one launch's device cost plus the
    chain of n_iter dependent adds; at n_iter = 0, the card's floor for one
    launch."""
    A = torch.ones((512, 512), dtype=_F32, device=device)
    out = {}
    for n_iter in n_iters:
        call = _ms(launch_probe, (A, n_iter), reps)
        dev = (_kernel_ms(launch_probe, (A, n_iter), "probe_kernel", reps)
               if A.device.type == "cuda" else None)
        out[n_iter] = (call, dev)
        _report(f"launch probe ({n_iter} dependent adds), per call", call)
        if dev is not None:
            _report(f"launch probe ({n_iter} dependent adds), on the card", dev)
    return out


def study_gram(device="cuda", ns=(1024, 3072, 8192, 16384), reps=20) -> dict:
    """{n: (ms per call, device ms per launch, plain ms, max|kernel -
    plain|)} of the study's SE gram at d = 10, each n checked against the
    plain version (atol GRAM_ATOL e^p0). A call also maps the
    hyperparameters on the card (five elementwise kernels); the device time
    is the gram kernel's alone, from torch.profiler (None on the CPU)."""
    params = study_params(device)
    p = torch.tensor([STUDY_LSIG, STUDY_LL, 0.0], dtype=_F32, device=device)
    out = {}
    for n in ns:
        g = torch.Generator(device=device).manual_seed(0)
        X = torch.randn((n, 10), generator=g, dtype=_F32, device=device)
        err = float((se_gram_study(X, params) - gram_op.gram_plain(gram_op.SE, p, X)).abs().max())
        _check(f"study gram n={n} vs plain", err, GRAM_ATOL * math.exp(2 * STUDY_LSIG))
        kern = _ms(se_gram_study, (X, params), reps)
        dev = (_kernel_ms(se_gram_study, (X, params), "gram_kernel", reps)
               if X.device.type == "cuda" else None)
        plain = _ms(lambda X: gram_op.gram_plain(gram_op.SE, p, X), (X,), reps)
        out[n] = (kern, dev, plain, err)
        _report(f"gram  kernel n={n} (maxerr {err:.1e}), per call", kern)
        if dev is not None:
            _report(f"gram  kernel n={n}, on the card", dev)
        _report(f"gram  plain  n={n}", plain)
    return out


def _chol_and_inverse(A: torch.Tensor) -> tuple:
    L = torch.linalg.cholesky_ex(A)[0]
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


class PanelCase(NamedTuple):
    """One size of `study_panel`. Times in ms; the kernel's grid and the
    grid syncs it counted in its checked launch (None on the CPU)."""
    ms: float
    cholesky_ex_ms: float
    library_ms: float  # cholesky_ex + solve_triangular
    l_err: float  # max|L - L0| / max|L0|, L0 from f64
    residual: float  # max|L^-1 L0 - I|
    grid_blocks: int | None
    grid_syncs: int | None
    B: int


def panel_fit(cases) -> tuple:
    """Least-squares fit of t(B) = 2 nt c_step + (2 B^3 / 3) / rate to the
    kernel times of PanelCases (nt = B / 64): (c_step in ms, rate in
    TFLOP/s). c_step is the fixed cost of half a step (its diagonal tile
    and one grid sync); rate is the products' rate over the card."""
    X = torch.tensor([[2.0 * (c.B // 64), 2.0 * c.B**3 / 3.0] for c in cases],
                     dtype=torch.float64)
    t = torch.tensor([[c.ms] for c in cases], dtype=torch.float64)
    c_step, inv_rate = torch.linalg.lstsq(X, t).solution.flatten().tolist()
    return c_step, 1e-9 / inv_rate


def study_panel(device="cuda", Bs=(512, 1024), gram_B=3072, reps=10) -> dict:
    """{label: PanelCase} of the panel kernel, on W W^T + B I for each B in
    Bs and on the headline gram + e^-2 I at B = gram_B. Each case is checked
    first: L within PANEL_RTOL of max|L0| of an f64 factorization, and L,
    L^-1 within PANEL_RTOL of the plain version's; on the card, also the
    grid syncs the kernel counted against the schedule's 2 nt - 1."""
    cases = [(f"B={B}", spd_test_matrix(B, 64, device)) for B in Bs]
    if gram_B:
        cases.append((f"B={gram_B} SE gram + e^-2 I", headline_panel_matrix(gram_B, device)))
    on_card = torch.device(device).type == "cuda"
    out = {}
    for label, A in cases:
        B = A.shape[0]
        grid = syncs = None
        if on_card:
            most = max_grid_blocks("panel")
            grid = panel_grid_blocks(B, most)
            counter = torch.zeros(1, dtype=torch.int32, device=A.device)
            L, Linv = chol_inv_panel_on_grid(A, grid, counter)
            syncs = int(counter.item())
            print(f"panel grid {label}: {grid} blocks of at most {most}, {syncs} grid syncs "
                  f"counted by the kernel", flush=True)
            if syncs != panel_grid_syncs(B):
                raise RuntimeError(f"panel {label}: the kernel passed {syncs} grid syncs, its "
                                   f"schedule has {panel_grid_syncs(B)}")
        else:
            L, Linv = chol_inv_panel(A)
        L0 = torch.linalg.cholesky_ex(A.double())[0]
        el = _rel_err(L, L0)
        res = float((Linv.double() @ L0 - torch.eye(B, dtype=torch.float64,
                                                   device=device)).abs().max())
        _check(f"panel {label} L vs f64", el, PANEL_RTOL)
        Lp, Linvp = chol_inv_panel_plain(A)
        ep = max(_rel_err(L, Lp), _rel_err(Linv, Linvp))
        _check(f"panel {label} (L, L^-1) vs plain", ep, PANEL_RTOL)
        flops = 2.0 * B**3 / 3.0
        k = _ms(chol_inv_panel, (A,), reps)
        c = _ms(torch.linalg.cholesky_ex, (A,), reps)
        ci = _ms(_chol_and_inverse, (A,), reps)
        out[label] = PanelCase(k, c, ci, el, res, grid, syncs, B)
        _report(f"panel kernel {label} (Lerr {el:.0e} plain {ep:.0e} res {res:.0e})", k, flops)
        _report(f"panel cholesky_ex {label}", c)
        _report(f"panel cholesky_ex + solve_triangular {label}", ci, flops)
    if len({c.B for c in out.values()}) >= 2:
        c_step, rate = panel_fit(out.values())
        print(f"panel fit t(B) = 2 nt c_step + (2B^3/3)/rate: c_step {1e3 * c_step:.3f} us, "
              f"rate {rate:.3f} TFLOP/s", flush=True)
    return out


def correction_flops(n: int, B: int, c: int) -> float:
    """Flops of the single launch's correction of panel column c:
    2 (n - c) B c."""
    return 2.0 * (n - c) * B * c


def single_launch_stamped(K: torch.Tensor, B: int = 256) -> dict:
    """One single launch of the f32 CUDA matrix K on its largest grid, with
    the grid syncs it counted (checked against `single_launch_grid_syncs`)
    and its block-0 time stamps: {"grid_blocks", "grid_syncs",
    "correction_ms", "diagonal_ms", "apply_ms", "correction_tflops"}, the
    last the correction's flops over the factorization over its time."""
    n = K.shape[0]
    grid = max_grid_blocks("single_launch")
    syncs = torch.zeros(1, dtype=torch.int32, device=K.device)
    stamps = torch.zeros(single_launch_grid_syncs(n, B) + 2, dtype=torch.int64, device=K.device)
    single_launch_cholesky_on_grid(K, grid, syncs, stamps, B=B)
    counted = int(syncs.item())
    if counted != single_launch_grid_syncs(n, B):
        raise RuntimeError(f"single launch n={n}: the kernel passed {counted} grid syncs, its "
                           f"schedule has {single_launch_grid_syncs(n, B)}")
    split = single_launch_split(stamps, n, B)
    flops = sum(correction_flops(n, B, c) for c in range(0, n, B))
    return {"grid_blocks": grid, "grid_syncs": counted, **split,
            "correction_tflops": flops / split["correction_ms"] / 1e9}


def study_single_launch(device="cuda", n=10240, n_check=2048, reps=3) -> dict:
    """Correctness at n_check (relative error against an f64 factorization,
    below 1e-4 as the study asserts), then the single launch and
    `blocked_cholesky(block=1024)` at n; on the card, also one stamped
    launch at n (`single_launch_stamped`: grid, grid syncs, split)."""
    A = spd_test_matrix(n_check, 64, device)
    err = _rel_err(single_launch_cholesky(A, B=256, R=512),
                   torch.linalg.cholesky_ex(A.double())[0])
    print(f"single-launch correctness n={n_check}: rel err {err:.2e}", flush=True)
    if not err < 1e-4:
        raise RuntimeError(f"single_launch_cholesky: rel err {err:.2e} at n = {n_check}")
    K = spd_test_matrix(n, 256, device)
    flops = n**3 / 3.0
    single = _ms(single_launch_cholesky, (K,), reps)
    _report(f"full single-launch kernel n={n}", single, flops)
    blocked = _ms(lambda K: blocked_cholesky(K, block=1024)[0], (K,), reps)
    _report("full blocked_cholesky(block=1024)", blocked, flops)
    out = {"rel_err": err, "single": single, "blocked": blocked}
    if K.device.type == "cuda":
        out["stamped"] = s = single_launch_stamped(K)
        print(f"single launch n={n}: {s['grid_blocks']} blocks, {s['grid_syncs']} grid syncs "
              f"counted by the kernel; split correction {s['correction_ms']:.4f} ms "
              f"({s['correction_tflops']:.2f} TFLOP/s), diagonal {s['diagonal_ms']:.4f} ms, "
              f"apply {s['apply_ms']:.4f} ms", flush=True)
    return out


def study_full(device="cuda", n=10240, reps=3) -> dict:
    """The n-point factorization four ways: {way: ms}."""
    K = spd_test_matrix(n, 256, device)
    flops = n**3 / 3.0
    ways = {
        "cholesky_ex": torch.linalg.cholesky_ex,
        "blocked_cholesky(block=1024)": lambda K: blocked_cholesky(K, block=1024)[0],
        "cholesky_blocked_panels(block=1024)": cholesky_blocked_panels,
        "single_launch_cholesky": single_launch_cholesky,
    }
    out = {}
    for name, fn in ways.items():
        out[name] = _ms(fn, (K,), reps)
        _report(f"full {name} n={n}", out[name], flops)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("which", nargs="?", default="all",
                        choices=("all", "launch", "gram", "panel", "single", "full"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("cholesky_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    studies = {"launch": study_launch_overhead, "gram": study_gram, "panel": study_panel,
               "single": study_single_launch, "full": study_full}
    for name, study in studies.items():
        if args.which in ("all", name):
            study()
    return 0


if __name__ == "__main__":
    sys.exit(main())
