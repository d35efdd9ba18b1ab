"""The readings behind each limit of `correct`: the numbers a cell compares,
for the program and for the control (the plain reference in the
program's place, in TF32), over several seeds in one process.

    python3 -m gpbench.control --workload <cell> --seeds 1 2 3 --seconds 10 [--program]

Each run is a whole run of the cell (set-up, window, comparison) with the
control, or with `--program` the program itself, in the program's place;
one JSON line a seed. The control has to come out as not correct: the
smallest reading it gives over the seeds is the upper reading of each
limit, the largest the program gives the lower one. Beside "checks", what
the check found (`Cell.notes`: for "hmc", the accept band's excused count,
largest band and the reading of the fixed band). The benchmark's own runs
never run it. Needs the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness

__all__ = ["readings", "main"]


def readings(workload: str, seeds, seconds: float, program: bool, device: torch.device,
             overrides: dict | None = None) -> list:
    """[{"seed", "correct", "checks"}] of one run a seed."""
    spec = harness.load_spec()
    out = []
    for seed in seeds:
        probe = harness.resolve(spec, workload, seed, seconds, False, device, overrides)
        make = None if program else probe.reference.Control
        cell = harness.resolve(spec, workload, seed, seconds, False, device, overrides, make)
        t0 = time.perf_counter()
        res = harness.run(cell)
        out.append({"seed": seed, "who": "program" if program else "control",
                    "correct": res["correct"], "checks": res["checks"], **cell.notes,
                    "seconds": time.perf_counter() - t0})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--program", action="store_true", help="the program's readings")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.cache_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    readings(args.workload, args.seeds, args.seconds, args.program, torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
