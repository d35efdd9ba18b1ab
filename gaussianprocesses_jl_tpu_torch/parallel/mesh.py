"""Process meshes on `torch.distributed` (counterpart of
`gaussianprocesses_jl_tpu/parallel/mesh.py`).

One process drives one card, `cuda:LOCAL_RANK`. A `Mesh` lays the
processes of the job out on named axes, row-major by rank, as the JAX
package lays devices out; the axis names are the same:

  'chains' -- MCMC chains (configuration #5);
  'data'   -- observations, for sharded gram and FITC reductions;
  'j'      -- tile columns of the distributed dense Cholesky.

Each axis of size > 1 has a process group over the ranks that share every
other coordinate, and its collectives go through that group: NCCL for
CUDA tensors and gloo for CPU tensors. An axis of size 1 reduces locally.
With no process group started the job is one process, and `make_mesh()`
is a mesh of size 1: that is the JAX package's `make_mesh` on one device.
`make_pod_mesh` puts the low-traffic axis outermost, as the JAX package
does for its slices.
"""
from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .collectives import all_gather

__all__ = ["Mesh", "make_mesh", "make_pod_mesh", "initialize_distributed"]


@dataclass(frozen=True)
class Mesh:
    """This process's view of a mesh: the axis names and sizes (`shape`,
    name -> size, as a JAX mesh's), its coordinates on them, a process
    group for each axis of size > 1 (None otherwise) and its device."""

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    device: torch.device

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """x from every process along `axis`, concatenated along `dim` in the
        axis's order: (size * c, ...) for x (c, ...). On an axis of size 1, x
        itself. Differentiable (`collectives.all_gather`)."""
        return all_gather(x, self, axis, dim)


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _device(device) -> torch.device:
    """The process's card, cuda:LOCAL_RANK, unless the caller names a device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh runs on the CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _build(names: tuple, sizes: tuple, device) -> Mesh:
    world, rank = _world()
    n = math.prod(sizes)
    if n != world:
        raise ValueError(f"mesh needs {n} processes, the job has {world}")
    coords = {}
    rest = rank
    for name, size in zip(reversed(names), reversed(sizes)):
        coords[name] = rest % size
        rest //= size
    coords = {name: coords[name] for name in names}
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    groups = {}
    for a, name in enumerate(names):
        if sizes[a] == 1:
            groups[name] = None
            continue
        # every line along this axis, created in the same order on every rank
        mine = None
        for base in range(world):
            if (base // strides[a]) % sizes[a]:
                continue
            ranks = [base + i * strides[a] for i in range(sizes[a])]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        groups[name] = mine
    return Mesh(names, dict(zip(names, sizes)), coords, groups, _device(device))


def make_mesh(axis_sizes: dict | None = None, device=None) -> Mesh:
    """A mesh from {axis_name: size} over every process of the job; by
    default one 'chains' axis over all of them. `device`: the process's
    card unless given ("cpu" for gloo processes on the CPU)."""
    world, _ = _world()
    if axis_sizes is None:
        axis_sizes = {"chains": world}
    return _build(tuple(axis_sizes), tuple(int(s) for s in axis_sizes.values()), device)


def make_pod_mesh(inner: dict, outer_axis: str = "chains", device=None) -> Mesh:
    """A mesh whose `outer_axis` spans groups of processes (hosts: keep it
    to low-volume collectives such as the chains' accept statistics) and
    whose `inner` axes subdivide each group. With 8 processes,
    make_pod_mesh({'j': 4}) has axes ('chains', 'j') of sizes (2, 4)."""
    world, _ = _world()
    n_inner = math.prod(inner.values())
    if world % n_inner:
        raise ValueError(f"{world} processes not divisible by inner size {n_inner}")
    names = (outer_axis, *inner)
    return _build(names, (world // n_inner, *inner.values()), device)


def _as_int(value, name):
    try:
        return int(value)
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be an int, got {value!r}") from None


def _distributed_kwargs(address=None, world_size=None, rank=None, env=None) -> dict:
    """The arguments of `torch.distributed.init_process_group` (init_method,
    world_size, rank) from explicit values, or from MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE and RANK. `address` is "host:port" or an init
    URL ("tcp://...", "file://..."). Raises ValueError on a half-specified or
    malformed configuration: a misconfigured job must fail, not run as one
    process. Nothing configured gives {}."""
    env = os.environ if env is None else env
    kwargs = {}
    if address is None:
        host, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if bool(host) != bool(port):
            raise ValueError("MASTER_ADDR and MASTER_PORT must be set together")
        if host:
            address = f"{host}:{_as_int(port, 'MASTER_PORT')}"
    if address:
        kwargs["init_method"] = address if "://" in address else f"tcp://{address}"
    world_size = world_size if world_size is not None else env.get("WORLD_SIZE")
    if world_size is not None:
        kwargs["world_size"] = _as_int(world_size, "WORLD_SIZE")
    rank = rank if rank is not None else env.get("RANK")
    if rank is not None:
        kwargs["rank"] = _as_int(rank, "RANK")
    has_w, has_r = "world_size" in kwargs, "rank" in kwargs
    if "init_method" in kwargs:
        missing = [k for k, h in (("world_size", has_w), ("rank", has_r)) if not h]
        if missing:
            raise ValueError("an explicit address requires " + " and ".join(missing)
                             + " (set WORLD_SIZE / RANK)")
    elif has_w != has_r:
        raise ValueError("world_size and rank must be given together")
    elif has_w:
        raise ValueError("world_size and rank need an address (MASTER_ADDR and MASTER_PORT): "
                         "torch.distributed detects none")
    if has_w and has_r:
        w, r = kwargs["world_size"], kwargs["rank"]
        if w < 1 or not 0 <= r < w:
            raise ValueError(f"rank {r} out of range for world_size {w}")
    return kwargs


def initialize_distributed(address: str | None = None, world_size: int | None = None,
                           rank: int | None = None) -> bool:
    """Join (or start) the job's process group, from the arguments or from
    MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK (as `torchrun` sets them).
    Its backend serves CUDA tensors by NCCL and CPU tensors by gloo (gloo
    alone where there is no CUDA). Safe to call twice.

    Returns True when the job has more than one process. A half-specified or
    malformed configuration raises ValueError; an explicit one whose
    rendezvous fails re-raises torch's error. Only an unconfigured call
    stays single-process, and it warns."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    kwargs = _distributed_kwargs(address, world_size, rank)
    if not kwargs:
        warnings.warn("no multi-process job configured (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, "
                      "RANK); continuing single-process", RuntimeWarning, stacklevel=2)
        return False
    cuda = torch.cuda.is_available() and dist.is_nccl_available()
    dist.init_process_group("cpu:gloo,cuda:nccl" if cuda else "gloo", **kwargs)
    return dist.get_world_size() > 1
