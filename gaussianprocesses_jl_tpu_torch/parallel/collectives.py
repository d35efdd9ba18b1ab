"""Differentiable collectives on a `Mesh` axis (the port's counterpart of
the `lax` primitives the JAX package's `parallel/` modules call: `psum`,
`all_gather`, `ppermute` and an owner's broadcast).

`torch.distributed` collectives carry no autograd, so each op here is an
`autograd.Function` with the gradient of the conjugate pair that
tensor-parallel training uses. A replicated loss is computed the same on
every process of the axis, and a replicated value's gradient is then the
same on every process too:

  copy       identity forward, all-reduce backward. It goes where a
             replicated parameter or input enters shard-local work (a local
             gram, the local terms of an ELBO): each process's backward
             holds only its shard's share of that gradient, and the
             all-reduce sums the shares;
  psum       all-reduce forward, identity backward (the "reduce" of the
             pair): the replicated sum's gradient is already whole;
  all_gather concatenation along `dim` in the axis's order; backward takes
             this process's slice of the (replicated) gradient;
  ppermute   a ring shift by `shift` places; backward shifts back;
  broadcast  the value of the process at axis coordinate `owner`; backward
             keeps the gradient on the owner (zero elsewhere).

With copy at every entry into shard-local work, every process ends with
the whole gradient of the replicated loss: the JAX package's, and that of
the same program on one process. On an axis of size 1 every op is the
identity and returns its input.

Each Function has its own `vmap` rule, which runs the collective once on
the batched tensor (a collective cannot go through `generate_vmap_rule`),
so a batch of chains under `torch.func.vmap` shares one collective call.

The raw forms (`allreduce_`, `gather_`, `broadcast_`, `shift_`, `all_ok`)
carry no gradient; the distributed factorization calls them inside its own
autograd.Functions. Every call that reaches `torch.distributed` counts its
bytes in `BYTES` and itself in `CALLS`, keyed by (op, axis, dtype): the
reduced tensor of an all-reduce ("allreduce", `all_ok`'s too), the
gathered output of an all-gather ("gather"), the broadcast tensor
("broadcast") and the shifted block ("shift"), as the JAX repo's
`perf/comm_model.py` reads them from compiled HLO. A size-1 axis counts
nothing.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from ..utils import graphs

__all__ = ["copy", "psum", "all_gather", "ppermute", "broadcast", "copy_module", "allreduce_",
           "gather_", "broadcast_", "shift_", "all_ok", "BYTES", "CALLS"]

BYTES: collections.Counter = collections.Counter()
CALLS: collections.Counter = collections.Counter()


def _count(op: str, axis: str, t: torch.Tensor) -> None:
    key = (op, axis, str(t.dtype).removeprefix("torch."))
    BYTES[key] += t.numel() * t.element_size()
    CALLS[key] += 1


def _group(mesh, axis: str):
    """The axis's process group (None on an axis of size 1). A collective
    over more than one process is refused while a CUDA graph is captured
    (`utils/graphs.py`): capturing one is untried, so such a call runs
    inside `graphs.eager()`."""
    group = mesh.groups[axis]
    if group is not None and graphs.capturing():
        raise RuntimeError(
            f"a collective over axis {axis!r} of {mesh.shape[axis]} processes cannot be captured "
            "into a CUDA graph yet; run this call inside "
            "`gaussianprocesses_jl_tpu_torch.utils.graphs.eager()`")
    return group


def _global(group, i: int) -> int:
    """The global rank of coordinate i of an axis group (a group's ranks are
    listed in axis order, so its group rank is the coordinate)."""
    return dist.get_global_rank(group, i)


# ---------------------------------------------------------------------------
# Raw collectives (no gradient)
# ---------------------------------------------------------------------------


def allreduce_(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of x over the axis (a new tensor; x itself on a size-1 axis)."""
    group = _group(mesh, axis)
    if group is None:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    _count("allreduce", axis, out)
    return out


def gather_(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """x from every process of the axis, concatenated along `dim` in axis
    order."""
    group = _group(mesh, axis)
    if group is None:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _count("gather", axis, out)
    return out


def broadcast_(x: torch.Tensor, mesh, axis: str, owner: int) -> torch.Tensor:
    """The owner's x on every process of the axis (x: a tensor of the owner's
    shape everywhere; read only on the owner)."""
    group = _group(mesh, axis)
    if group is None:
        return x
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=_global(group, owner), group=group)
    _count("broadcast", axis, out)
    return out


def shift_(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """The ring shift: this process's x goes to coordinate (me + shift) mod
    P, and the result is the x of (me - shift) mod P."""
    group = _group(mesh, axis)
    P = mesh.shape[axis]
    if group is None or shift % P == 0:
        return x
    me = mesh.coords[axis]
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _global(group, (me + shift) % P), group),
           dist.P2POp(dist.irecv, out, _global(group, (me - shift) % P), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count("shift", axis, out)
    return out


def all_ok(ok: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The AND of a bool tensor over the axis."""
    group = _group(mesh, axis)
    if group is None:
        return ok
    bad = (~ok).to(torch.int32).contiguous()
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
    _count("allreduce", axis, bad)
    return bad == 0


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


def _front(x, dim):
    return x if dim is None else x.movedim(dim, 0)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.mesh, ctx.axis), None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis):
        return _Copy.apply(_front(x, in_dims[0]), mesh, axis), 0


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis):
        return allreduce_(x, mesh, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mesh, ctx.axis), None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis):
        return _Psum.apply(_front(x, in_dims[0]), mesh, axis), 0


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis, dim):
        return gather_(x, mesh, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.mesh, ctx.axis, ctx.dim = inputs
        ctx.size = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        me = ctx.mesh.coords[ctx.axis]
        return g.narrow(ctx.dim, me * ctx.size, ctx.size), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis, dim):
        return _AllGather.apply(_front(x, in_dims[0]), mesh, axis, dim + 1), 0


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis, shift):
        return shift_(x, mesh, axis, shift)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.axis, ctx.shift = inputs

    @staticmethod
    def backward(ctx, g):
        return _Shift.apply(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis, shift):
        return _Shift.apply(_front(x, in_dims[0]), mesh, axis, shift), 0


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis, owner):
        return broadcast_(x, mesh, axis, owner)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.axis, ctx.owner = inputs

    @staticmethod
    def backward(ctx, g):
        keep = ctx.mesh.coords[ctx.axis] == ctx.owner
        return (g if keep else torch.zeros_like(g)), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis, owner):
        return _Broadcast.apply(_front(x, in_dims[0]), mesh, axis, owner), 0


def _sized(mesh, axis) -> bool:
    return mesh.groups[axis] is not None


def copy(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Identity forward, all-reduce backward: put it where a replicated
    tensor enters shard-local work."""
    return _Copy.apply(x, mesh, axis) if _sized(mesh, axis) else x


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over the axis (a replicated result); identity backward."""
    return _Psum.apply(x, mesh, axis) if _sized(mesh, axis) else x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """x of every process, concatenated along `dim` in axis order;
    backward keeps this process's slice."""
    return _AllGather.apply(x, mesh, axis, dim % x.ndim) if _sized(mesh, axis) else x


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """The x of coordinate (me - shift) mod P; backward shifts back."""
    return _Shift.apply(x, mesh, axis, shift) if _sized(mesh, axis) else x


def broadcast(x: torch.Tensor, mesh, axis: str, owner: int) -> torch.Tensor:
    """The x of coordinate `owner` on every process; backward keeps the
    gradient on the owner."""
    return _Broadcast.apply(x, mesh, axis, owner) if _sized(mesh, axis) else x


def copy_module(module, mesh, axis: str):
    """`module` with `copy` on each floating tensor leaf: a replicated
    kernel, mean or likelihood as it enters shard-local work."""
    if not _sized(mesh, axis):
        return module
    return module.with_tensors([copy(t, mesh, axis) if t.is_floating_point() else t
                                for t in module.tensors()])
