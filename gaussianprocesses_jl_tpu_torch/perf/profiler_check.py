"""How often does a torch.profiler session lose every kernel it ran?

    python -m gaussianprocesses_jl_tpu_torch.perf.profiler_check [--sessions N] [--keep-cupti]

The port's profiles (`utils/profiling.device_ms_by_name`) open one
torch.profiler session a measurement; now and then a session on the card
holds no kernel record at all, and a measurement built on it would fail.
This script captures the headline's CUDA graphs (SE, n = 3000, f32:
`target_and_dtarget` and five L-BFGS iterations), then, `--sessions`
rounds in turn, each after a graph replay:
  * profiles configuration #4's cross gram (512 x 100 000, d = 4) and the
    headline's graph replay in one plain session each (10 calls) and
    counts the sessions that saw no `gram_kernel` (the cross gram) or no
    kernel at all (the replay);
  * measures the cross gram through `device_ms_by_name`, which runs an
    empty session again (3 in all), and counts the measurements that
    still saw no `gram_kernel`.
`--keep-cupti` sets `TEARDOWN_CUPTI=0` first (CUPTI stays set up between
sessions, as PyTorch sets it for its own graphs); the variable stays set
for the process, so run each way in a process of its own. It prints the
card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.utils import profiling

REPS = 10


def _saw(kernels, match: str) -> bool:
    return any(match in key for key in kernels)


def count_empty(cases, sessions: int, between=None) -> list:
    """For each (call, match) of `cases`: the number of its `sessions`
    plain profiler sessions (REPS calls of `call`) that saw no device time
    in a kernel whose name holds `match`, and the number of its
    `device_ms_by_name` measurements (with their reruns) that saw none.
    The cases take turns; `between()` runs before each round."""
    from torch.autograd import DeviceType

    empty = [[0, 0] for _ in cases]
    for _ in range(sessions):
        if between is not None:
            between()
        for i, (call, match) in enumerate(cases):
            with profiling._profiler() as prof:
                for _ in range(REPS):
                    call()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            seen = {e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
            empty[i][0] += not _saw(seen, match)
            empty[i][1] += not _saw(profiling.device_ms_by_name(call, reps=REPS)[0], match)
    return empty


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=150)
    ap.add_argument("--keep-cupti", action="store_true",
                    help="TEARDOWN_CUPTI=0: keep CUPTI set up between sessions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_check: no CUDA device", file=sys.stderr)
        return 1
    if args.keep_cupti:
        os.environ["TEARDOWN_CUPTI"] = "0"
    print(profiling.card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.RandomState(42)
    X, y = rng.randn(3000, 10), rng.randn(3000)
    m = gp.GPE(X.astype(np.float32), y.astype(np.float32), gp.MeanZero(), gp.SE(0.0, 0.0),
               lognoise=-1.0, device=dev)
    m.target_and_dtarget()
    m.optimize(maxiter=5)
    gen = torch.Generator(device=dev).manual_seed(0)
    Xc = torch.randn((100000, 4), generator=gen, device=dev)
    Xu = torch.randn((512, 4), generator=gen, device=dev)
    p = torch.zeros(3, device=dev)
    t0 = time.perf_counter()
    (cross, cross_kept), (replay, replay_kept) = count_empty(
        [(lambda: gram_op.launch_gram(gram_op.SE, p, Xu, Xc), "gram_kernel"),
         (m.target_and_dtarget, "")], args.sessions, between=m.target_and_dtarget)
    print(json.dumps({"keep_cupti": args.keep_cupti, "sessions": args.sessions,
                      "empty_cross_gram": cross, "empty_graph_replay": replay,
                      "empty_cross_gram_after_reruns": cross_kept,
                      "empty_graph_replay_after_reruns": replay_kept,
                      "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
