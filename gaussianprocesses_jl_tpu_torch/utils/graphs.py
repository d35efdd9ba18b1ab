"""CUDA graphs: the port's counterpart of `jax.jit` for a function of fixed
shapes.

The JAX package runs each hot path as one compiled XLA program: the
headline's value and gradient (`models/gpe.py`), the GPA's, and the
samplers' leapfrog scans. Eager PyTorch dispatches the same work operator by
operator from Python, hundreds of operators a leapfrog step. Here such a
function is captured once into a `torch.cuda.CUDAGraph` and replayed: the
same kernels, the port's own among them, with no Python between them.

`run(owner, fn, *args, static=())` returns `fn(*args)`:

  * on CPU tensors it calls `fn` eagerly: that is how the tests run it;
  * inside a `with eager():` block it calls `fn` eagerly on the card too:
    the one switch for the before/after comparisons of the perf scripts
    and `chip_smoke.py`, and the caller's route around a capture that is
    refused;
  * on CUDA tensors it replays the graph kept for (owner, static, the
    arguments' structure): captured at first use, or it raises. There is
    no fallback to eager.

`args` may hold tensors, modules (`utils/modules.Module`: their tensor
leaves are inputs, their types and static fields part of the key), tuples
(named ones too), lists and static Python values (None, bool, int, float,
str: part of the key). Every tensor input is copied into the graph's static buffer before a
replay; every tensor output is copied out after it, so nothing a caller
keeps is overwritten by the next replay.

`Bound(owner, fn, *args)` is x -> run(owner, fn, x, *args) with its
parts readable: a model's objective, whose function a larger graph (the
L-BFGS iteration of `inference/lbfgs.py`) calls inline, its arguments
passed on as that graph's inputs.

`owner` is the object whose lifetime bounds the graph's: the model whose
target the graph computes, or the function whose closure the graph bakes
in (a sampler's log target). The graphs are kept in a weak map keyed by
it, and dropped with it. As `jax.jit` keeps a program for each shape, a
graph is kept for each shape an owner is called at (an elastic GP's
sizes, say), but only the last `PER_OWNER` of them: the least recently
replayed goes first.

A capture first runs `fn` once on a side stream (the warm-up: `ops/cuda.py`
builds the kernels there, cuBLAS and cuSOLVER make their handles and
workspaces, the caching allocator settles), then captures it on the same
stream into a memory pool shared by the device's graphs. Graphs replay one
at a time on the current stream, and each keeps its inputs and outputs
alive, so they can share the pool. When the last graph of a pool goes, the
pool goes with it and its memory returns to the caching allocator; the
next capture starts a pool of its own.

Collectives over an axis of more than one process are refused inside a
warm-up or a capture (`parallel/collectives.py` reads `capturing()`):
NCCL under capture is untried here, so a distributed strategy at P > 1 on
the card runs inside `eager()`.

Launch counts: the kernels' wrappers (`ops/gram.py`,
`ops/cholesky_kernels.py`, `ops/leapfrog.py`) count their launches in
Python, and `models/sparse.py` its QRs; a replay does not pass through that
Python. Each such counter, a dict or `Counter` of counts, is declared
through `counted` in its own module. The counts a capture records are added at every replay,
and the warm-up's and the capture's own are taken back: one call counts
one evaluation's launches, whether eager or replayed.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import weakref
from typing import Callable

import torch

from .modules import Module
from .profiling import span

__all__ = ["run", "Bound", "eager", "capturing", "clear", "counted", "PER_OWNER"]

PER_OWNER = 8  # graphs kept for one owner, the least recently replayed dropped first

# owner -> OrderedDict {key: _Graph}, least recently replayed first
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_STREAMS: dict = {}  # device index -> the side stream of warm-ups and captures
_POOLS: dict = {}  # device index -> the _Pool its next capture goes into
_STATIC = (type(None), bool, int, float, str)
_EAGER = [0]  # depth of the open `eager()` blocks
_REGION = [0]  # > 0 while a warm-up or a capture runs
_COUNTERS: list = []  # the counters `counted` registered


@contextlib.contextmanager
def eager():
    """Inside this block `run` calls its functions eagerly on the card, one
    operator at a time, as on the CPU."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def capturing() -> bool:
    """Whether a capture, or the warm-up before it, is running: code that a
    graph cannot hold raises when it is."""
    return _REGION[0] > 0


def _flatten(x, leaves: list):
    """(key, spec) of x, its tensors appended to `leaves`: the key is
    hashable and names x's structure; the spec rebuilds x from tensors."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return "tensor", None
    if isinstance(x, Module):
        tensors = x.tensors()
        leaves.extend(tensors)
        return ("module", _structure(x)), ("module", x, len(tensors))
    if isinstance(x, (tuple, list)):
        parts = [_flatten(v, leaves) for v in x]
        return ((type(x).__name__, tuple(k for k, _ in parts)),
                (type(x), [s for _, s in parts]))
    if isinstance(x, _STATIC):
        return ("static", x), ("static", x)
    raise TypeError(f"graphs: cannot take a {type(x).__name__} as an argument or result")


class _Same:
    """A static field's value that cannot be hashed (a mesh, say), keyed by
    its identity; the key holds it, so the identity is not reused."""

    def __init__(self, value):
        self.value = value

    def __hash__(self):
        return id(self.value)

    def __eq__(self, other):
        return isinstance(other, _Same) and other.value is self.value


def _static(v):
    try:
        hash(v)
    except TypeError:
        return _Same(v)
    return v


def _structure(m: Module):
    """A module's type and static fields, recursively: what a graph of it
    bakes in beside its tensors."""
    return (type(m), tuple(_static(getattr(m, f)) for f in m._meta_fields),
            tuple(_structure(v) if isinstance(v, Module) else None
                  for v in (getattr(m, f) for f in m._data_fields)))


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    tag = spec[0]
    if tag == "module":
        return spec[1].with_tensors([next(it) for _ in range(spec[2])])
    if tag == "static":
        return spec[1]
    parts = [_unflatten(s, it) for s in spec[1]]
    return tag(*parts) if hasattr(tag, "_fields") else tag(parts)


def counted(c):
    """Register the counter `c` (a dict or `Counter` of counts) and return
    it: a capture records what it adds to `c`, and each replay adds that
    again."""
    _COUNTERS.append(c)
    return c


def _snapshot() -> list:
    """(counter, a copy of its counts) for every registered counter."""
    return [(c, dict(c)) for c in _COUNTERS]


def _restore(snap: list) -> None:
    for c, s in snap:
        c.clear()
        c.update(s)


def _delta(before: list) -> list:
    """(counter, what was added to it since the snapshot `before`)."""
    return [(c, {k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)})
            for c, b in before]


def _add(delta: list) -> None:
    for c, d in delta:
        for k, v in d.items():
            c[k] = c.get(k, 0) + v


class _Pool:
    """A memory pool shared by the graphs captured into it, and how many of
    them live. The allocator frees a pool once no graph holds it, and a
    freed pool cannot take another capture, so the last graph to go takes
    the pool out of `_POOLS` with it."""

    def __init__(self, device: torch.device):
        self.handle = torch.cuda.graph_pool_handle()
        self.device = device.index
        self.live = 0

    def take(self) -> None:
        self.live += 1

    def give(self) -> None:
        self.live -= 1
        if self.live == 0:
            self.retire()

    def retire(self) -> None:
        """Take no more captures (after the last graph, or a failed one)."""
        if _POOLS.get(self.device) is self:
            del _POOLS[self.device]


def _pool(device: torch.device) -> _Pool:
    """The device's current pool, one more graph counted in it."""
    pool = _POOLS.get(device.index)
    if pool is None:
        pool = _POOLS[device.index] = _Pool(device)
    pool.take()
    return pool


def _capture(fn: Callable, args: tuple, device: torch.device, pool: _Pool) -> tuple:
    """(replay, out, launches): fn(*args) run once on the device's side
    stream, then captured there into `pool`; `replay` runs the graph on the
    current stream, `out` holds its outputs, `launches` the kernel launches
    the capture recorded."""
    stream = _STREAMS.get(device.index)
    if stream is None:
        stream = _STREAMS[device.index] = torch.cuda.Stream(device)
    gc.collect()  # no graph of a dead owner is collected during the capture
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn(*args)  # the warm-up
        warm = _snapshot()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool.handle)
        try:
            out = fn(*args)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    return graph.replay, out, _delta(warm)


class _Graph:
    """One captured graph: static input buffers, the graph, its outputs,
    and the launches it makes."""

    def __init__(self, fn: Callable, leaves: list, spec, device: torch.device):
        self.inputs = [t.detach().clone() for t in leaves]
        pool = _pool(device)
        before = _snapshot()
        _REGION[0] += 1
        try:
            self.replay, out, self.launches = _capture(
                fn, _unflatten(spec, iter(self.inputs)), device, pool)
        except BaseException:
            pool.give()
            pool.retire()  # the next capture starts a pool of its own
            raise
        finally:
            _REGION[0] -= 1
            _restore(before)
        weakref.finalize(self, pool.give)
        self.outputs = []
        _, self.out_spec = _flatten(out, self.outputs)

    def __call__(self, leaves: list):
        for buf, t in zip(self.inputs, leaves):
            buf.copy_(t)
        self.replay()
        _add(self.launches)
        return _unflatten(self.out_spec, iter([t.clone() for t in self.outputs]))


def _device(leaves: list):
    """The one CUDA device of the tensors, or None when every one is on the
    CPU; raises on a mix."""
    devices = {t.device for t in leaves}
    cuda = {d for d in devices if d.type == "cuda"}
    if not cuda:
        return None
    if len(devices) > 1:
        raise ValueError(f"graphs: the inputs of one graph lie on {sorted(map(str, devices))}; "
                         "a graph takes tensors of one CUDA device")
    return cuda.pop()


def _span_name(static, fn: Callable) -> str:
    """gp.graph.<the static tag, or its first item; else fn's name>."""
    tag = static[0] if isinstance(static, tuple) and static else static
    return "gp.graph." + (tag if isinstance(tag, str) else fn.__name__)


def run(owner, fn: Callable, *args, static=()):
    """fn(*args): on the card through the CUDA graph kept for (owner,
    static, the arguments' structure and shapes), captured at first use;
    eagerly on CPU tensors or inside `eager()`. While a profiler session
    runs, the call is one `gp.graph.<tag>` span (`utils/profiling.span`);
    otherwise its name is not built."""
    if torch.autograd._profiler_enabled():
        with span(_span_name(static, fn)):
            return _run(owner, fn, args, static)
    return _run(owner, fn, args, static)


def _run(owner, fn: Callable, args: tuple, static):
    leaves: list = []
    key, spec = _flatten(args, leaves)
    device = _device(leaves)
    if _EAGER[0] or device is None:
        return fn(*args)
    key = (static, key, torch.is_grad_enabled(),
           tuple((tuple(t.shape), t.dtype) for t in leaves), device)
    graphs = _GRAPHS.get(owner)
    if graphs is None:
        graphs = _GRAPHS[owner] = collections.OrderedDict()
    graph = graphs.get(key)
    if graph is None:
        while len(graphs) >= PER_OWNER:
            graphs.popitem(last=False)
        graph = graphs[key] = _Graph(fn, leaves, spec, device)
    graphs.move_to_end(key)
    return graph(leaves)


class Bound:
    """x -> fn(x, *args) through the graph kept for `owner`: a model's
    objective (`make_objective`). Its owner, function and arguments stay
    readable, so a caller can hold the evaluation inside a graph of its own
    (the L-BFGS step of `inference/lbfgs.py`) with the arguments as that
    graph's inputs, not as constants baked into it."""

    def __init__(self, owner, fn: Callable, *args):
        self.owner, self.fn, self.args = owner, fn, args

    def __call__(self, x):
        return run(self.owner, self.fn, x, *self.args)


def clear() -> None:
    """Drop every kept graph, and with them their pools, and give the
    pools' memory back to the card (a perf script that swaps a function a
    graph baked in, or sweeps large shapes, calls it)."""
    _GRAPHS.clear()
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
