"""A check that a region the CUDA graph layer (`utils/graphs.py`) captures
reads nothing back to the host, run on the CPU: inside `no_host_reads()`
`Tensor.__bool__`, `__float__`, `__int__`, `item`, `tolist`, `cpu` and
`numpy` raise, and so do `torch.tensor` and `torch.as_tensor` of host data,
indexing by a host list and a host value put at tensor indices (each a
copy to the card there). Shared by tests/test_torch_graphs.py and the gloo
job of tests/torch_parallel_ranks.py."""
import contextlib

import numpy as np
import torch

READS = ("__bool__", "__float__", "__int__", "item", "tolist", "cpu", "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Every read of a tensor back to the host raises AssertionError, and so
    does a tensor made from host data."""
    saved = {name: getattr(torch.Tensor, name)
             for name in (*READS, "__getitem__", "__setitem__")}
    made = {name: getattr(torch, name) for name in ("tensor", "as_tensor")}

    def refuse(name):
        def f(*args, **kwargs):
            raise AssertionError(f"a capture region called Tensor.{name}")
        return f

    def getitem(self, idx):
        items = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(i, (list, np.ndarray)) for i in items):
            raise AssertionError("a capture region indexed by a host list")
        return saved["__getitem__"](self, idx)

    def setitem(self, idx, value):
        items = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(i, torch.Tensor) for i in items) and \
                not isinstance(value, torch.Tensor):
            raise AssertionError("a capture region put a host value at tensor indices")
        return saved["__setitem__"](self, idx, value)

    def from_host(name):
        def f(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"a capture region called torch.{name} on host data")
            return made[name](data, *args, **kwargs)
        return f

    try:
        for name in READS:
            setattr(torch.Tensor, name, refuse(name))
        torch.Tensor.__getitem__ = getitem
        torch.Tensor.__setitem__ = setitem
        for name in made:
            setattr(torch, name, from_host(name))
        yield
    finally:
        for name, f in saved.items():
            setattr(torch.Tensor, name, f)
        for name, f in made.items():
            setattr(torch, name, f)


def checked_run(owner, fn, *args, static=()):
    """A stand-in for `graphs.run` that calls fn on the arguments, as the
    layer's capture does, with host reads refused."""
    with no_host_reads():
        return fn(*args)
