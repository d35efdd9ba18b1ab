"""Where the panel kernel's time goes, on the card.

Run on a machine with one NVIDIA GPU:

    python -m gaussianprocesses_jl_tpu_torch.perf.panel_parts

It builds `csrc/panel_parts.cu` (which includes `csrc/cholesky.cu`) and
prints, with the card's name and power limit:

1. one diagonal tile (`chol_inv_tile`, the link of the panel's chain) in one
   block, per call;
2. one 64 x 64 x 64 tile product (`gemm_tile`) per block, on 1 block, on the
   panel's grid at B = 1024 and on the largest grid, with the rate over the
   card;
3. one grid sync, on each of those grids;
4. the panel at B = 64 (one tile and one grid sync), the kernel's own time
   on the card from torch.profiler;
5. the panel on its own grid (`panel_grid_blocks`) against the largest
   cooperative grid, at B = 512, 1024 and 3072, each checked against the
   plain version on both grids first and timed in turns (own, largest,
   largest, own) within one call: whether sizing the grid to the widest
   phase matters.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from ..ops import cholesky_kernels as ck
from ..ops import cuda
from ..utils.profiling import device_ms_by_name, device_time
from .cholesky_study import PANEL_RTOL, _rel_err, headline_panel_matrix, spd_test_matrix

__all__ = ["main"]


def _us_per_iter(launch, iters: int) -> float:
    """Microseconds per iteration of one launch that loops `iters` times,
    from CUDA events, after one warm-up launch of one iteration."""
    launch(1)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch(iters)
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / iters


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("panel_parts: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    most = ck.max_grid_blocks("panel")
    grids = (1, ck.panel_grid_blocks(1024, most), most)

    A = spd_test_matrix(64, 64, dev)
    L, Li = torch.empty_like(A), torch.empty_like(A)
    us = _us_per_iter(lambda n: cuda.call("panel_parts.cu", "tile_bench_f32", A.data_ptr(),
                                          L.data_ptr(), Li.data_ptr(), n), 200)
    print(f"chol_inv_tile, one 64 x 64 tile in one block: {us:.3f} us")

    X = torch.randn((64, 64), device=dev)
    for grid in grids:
        C = torch.zeros((grid, 64, 64), device=dev)
        us = _us_per_iter(lambda n: cuda.call("panel_parts.cu", "gemm_bench_f32", X.data_ptr(),
                                              X.data_ptr(), C.data_ptr(), 64, n, grid), 50)
        print(f"gemm_tile 64 x 64 x 64 on {grid} blocks: {us:.3f} us a product, "
              f"{2 * 64**3 * grid / us / 1e6:.3f} TFLOP/s over the grid")
    sync_most = cuda.max_blocks("panel_parts.cu", "sync_bench_max_blocks")
    for grid in grids:
        us = _us_per_iter(lambda n: cuda.call("panel_parts.cu", "sync_bench_run", n,
                                              min(grid, sync_most)), 1000)
        print(f"grid.sync on {grid} blocks: {us:.3f} us")

    A = spd_test_matrix(64, 64, dev)
    kernels, _ = device_ms_by_name(lambda A: ck.chol_inv_panel(A, T=64), (A,), reps=20,
                                   warmup=2)
    ms = sum(t for key, (t, _) in kernels.items() if "panel_kernel" in key)
    print(f"panel B=64 (one tile, one grid sync), on the card: {1e3 * ms:.3f} us")

    def on_largest(A):
        return ck.chol_inv_panel_on_grid(A, most)

    cases = [(f"B={B}", spd_test_matrix(B, 64, dev)) for B in (512, 1024)]
    cases.append(("B=3072 SE gram + e^-2 I", headline_panel_matrix(3072, dev)))
    for label, A in cases:
        L0, Li0 = ck.chol_inv_panel_plain(A)
        for fn in (ck.chol_inv_panel, on_largest):
            L, Li = fn(A)
            err = max(_rel_err(L, L0), _rel_err(Li, Li0))
            if not err <= PANEL_RTOL:
                raise RuntimeError(f"panel {label}: {err:.3e} from the plain version")
        t = [1e3 * device_time(fn, (A,), reps=10, trials=2)
             for fn in (ck.chol_inv_panel, on_largest, on_largest, ck.chol_inv_panel)]
        print(f"panel {label}: own grid ({ck.panel_grid_blocks(A.shape[0], most)} blocks) "
              f"{t[0]:.4f} / {t[3]:.4f} ms, largest grid ({most} blocks) "
              f"{t[1]:.4f} / {t[2]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
