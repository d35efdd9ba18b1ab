"""What the benchmark reads of the program besides its answers: the gram
op's launch counters (a CUDA graph's replay adds the launches its capture
recorded), and the iterates of its L-BFGS loop."""
from __future__ import annotations

import contextlib
import functools

__all__ = ["launch_counters", "lbfgs_iterates"]


def launch_counters() -> dict:
    """{"gram": launches, "gram_vjp": launches, (kernel, n1, n2, cross):
    launches}."""
    from gaussianprocesses_jl_tpu_torch.ops import gram

    return {**gram.LAUNCHES, **gram.LAUNCH_SHAPES}


class _Iterates:
    """The L-BFGS loop's `trace` (it appends each iteration's (x_k, step)):
    keeps x_k alone, in `into`."""

    def __init__(self, into: list):
        self.into = into

    def append(self, item):
        self.into.append(item[0])


@contextlib.contextmanager
def lbfgs_iterates(into: list | None):
    """Within it, the program's L-BFGS loop (`inference/lbfgs.py`'s
    `minimize`, which `optimize(method='optax')` drives) appends each
    iteration's x_k, as the device tensor it holds, to `into` through its
    own `trace` argument. With `into` None, it changes nothing."""
    if into is None:
        yield
        return
    from gaussianprocesses_jl_tpu_torch.inference import lbfgs

    minimize = lbfgs.minimize
    lbfgs.minimize = functools.partial(minimize, trace=_Iterates(into))
    try:
        yield
    finally:
        lbfgs.minimize = minimize
