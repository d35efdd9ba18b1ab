"""Parameter wrapper (counterpart of `gaussianprocesses_jl_tpu/utils/params.py`).

A `Param` wraps a raw scalar or vector hyperparameter (e.g. the GPE's
lognoise, which is a vector for heteroscedastic noise) so it can carry
priors and take part in the flat parameter protocol like any other module."""
from __future__ import annotations

from typing import Any

from .modules import Module, module

__all__ = ["Param", "wrap_param"]


@module(static=("priors",))
class Param(Module):
    value: Any
    priors: tuple = ()

    @property
    def shape(self):
        return tuple(self.value.shape)


def wrap_param(value, priors: tuple = ()) -> Param:
    if isinstance(value, Param):
        return value
    return Param(value=value, priors=priors)
