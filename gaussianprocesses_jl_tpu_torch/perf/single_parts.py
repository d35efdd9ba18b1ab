"""Where the single launch's time goes, on the card.

Run on a machine with one NVIDIA GPU:

    python -m gaussianprocesses_jl_tpu_torch.perf.single_parts

It builds `csrc/single_parts.cu` (which includes `csrc/cholesky.cu`) and
prints, with the card's name and power limit:

1. the correction of one panel column c of the study's n = 10240 matrix,
   B = 256, at depths c from 256 to 9984 (156 down to 4 product tiles of
   128 x 128, 624 down to 16 of 64 x 64), timed in one launch of 5 rounds
   each way: as the single launch runs it (`deep_tile` spread over the
   card stream-K style, pieces summed after a grid sync) and as it ran
   before (one 64 x 64 `gemm_tile` of full depth a block at a time, on the
   old kernel's grid of two blocks an SM), with each one's TFLOP/s over
   the card at 2 (n - c) B c flops;
2. the single launch at n = 10240 on its grid, split by its block-0 time
   stamps into correction, diagonal block and apply, and the correction's
   rate over the whole factorization.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from ..ops import cuda
from .cholesky_study import correction_flops, single_launch_stamped, spd_test_matrix

__all__ = ["product_rates", "main"]

DEPTHS = (256, 2560, 5120, 7680, 9984)


def _ms_per_iter(launch, iters: int) -> float:
    """Milliseconds per round of one launch that loops `iters` times, from
    CUDA events, after one warm-up launch of one round."""
    launch(1)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch(iters)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def product_rates(device="cuda", n: int = 10240, B: int = 256, depths=DEPTHS,
                  iters: int = 5) -> dict:
    """{c: (deep ms, deep TFLOP/s, gemm_tile ms, gemm_tile TFLOP/s)} of one
    panel column's correction at each depth c, both ways, on the study's
    matrix. Each way is first checked against torch.matmul in f64 (1e-5 of
    max|.|)."""
    X = spd_test_matrix(n, 256, device)
    deep_grid = cuda.max_blocks("single_parts.cu", "deep_bench_max_blocks")
    # the old single launch's grid: two blocks an SM
    gemm_grid = min(cuda.max_blocks("single_parts.cu", "gemm_bench_max_blocks"),
                    2 * torch.cuda.get_device_properties(device).multi_processor_count)
    part = torch.empty((2 * deep_grid, 128, 128), device=device)
    Xd = X.double()
    out = {}
    for c in depths:
        ref = Xd[c:, c:c + B] - Xd[c:, :c] @ Xd[c:c + B, :c].T
        runs = {
            "deep": lambda acc, it: cuda.call("single_parts.cu", "deep_bench_run", X.data_ptr(),
                                              acc.data_ptr(), part.data_ptr(), n, B, c, it,
                                              deep_grid),
            "gemm_tile": lambda acc, it: cuda.call("single_parts.cu", "gemm_bench_run",
                                                   X.data_ptr(), acc.data_ptr(), n, B, c, it,
                                                   gemm_grid),
        }
        row = []
        for name, run in runs.items():
            acc = torch.zeros((n, B), device=device)
            run(acc, 1)
            err = float((acc[c:].double() - ref).abs().max() / ref.abs().max())
            if not err <= 1e-5:
                raise RuntimeError(f"{name} correction c={c}: {err:.3e} from f64")
            ms = _ms_per_iter(lambda it: run(acc, it), iters)
            row += [ms, correction_flops(n, B, c) / ms / 1e9]
        out[c] = tuple(row)
        print(f"correction c={c} ({(n - c) // 128 * (B // 128)} tiles of 128, "
              f"{(n - c) // 64 * (B // 64)} of 64): deep {row[0]:.4f} ms {row[1]:.2f} TFLOP/s "
              f"on {deep_grid} blocks; gemm_tile {row[2]:.4f} ms {row[3]:.2f} TFLOP/s on "
              f"{gemm_grid} blocks", flush=True)
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("single_parts: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    product_rates(dev)
    K = spd_test_matrix(10240, 256, dev)
    for _ in range(2):
        s = single_launch_stamped(K)
        print(f"single launch n=10240 on {s['grid_blocks']} blocks, {s['grid_syncs']} grid "
              f"syncs: correction {s['correction_ms']:.4f} ms ({s['correction_tflops']:.2f} "
              f"TFLOP/s), diagonal {s['diagonal_ms']:.4f} ms, apply {s['apply_ms']:.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
