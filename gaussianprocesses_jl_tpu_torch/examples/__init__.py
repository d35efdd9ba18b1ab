"""The JAX repo's `examples/*.py` as the port's scripts.

    python -m gaussianprocesses_jl_tpu_torch.examples.<name> [--device cpu] [depth]

Each module builds its data and model once (`data`, `model`) and drives
them once (`run(device, dtype, depth, verbose)`, which returns its
numbers; `distributed` has one function a part); `chip_smoke.py` and the
anchors' tests call `run`, and `main(argv)` parses the arguments and
calls it, printing what the JAX example prints. The models run on the
card unless `--device` names another; the data are numpy f64, so they run
in f64 (the JAX package's precision under x64), unless a builder is given
another dtype. A sampler draws from a `torch.Generator` seeded as the JAX
example seeds its key, so its draws are the port's own.
"""
import argparse
import os
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["DATA_DIR", "parser", "generator", "world", "say"]

# where the notebooks' CSVs would stand in this repository (none is
# committed yet; the examples then make their synthetic series)
DATA_DIR = Path(__file__).resolve().parents[2] / "examples" / "data"


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's arguments: `--device` (the card unless given)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def world() -> int:
    """The job's process count: a `torchrun` job (WORLD_SIZE in the
    environment) is joined here; otherwise 1."""
    from gaussianprocesses_jl_tpu_torch.parallel.mesh import initialize_distributed

    if "WORLD_SIZE" in os.environ:
        initialize_distributed()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def say(*args) -> None:
    """print, on the process of rank 0 alone when a job has several."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        print(*args, flush=True)
