"""Module system: frozen dataclasses of tensors with a flat-parameter protocol.

Counterpart of `gaussianprocesses_jl_tpu/utils/modules.py`. Every kernel,
mean and model state is a frozen dataclass whose data fields are tensors or
child modules and whose static fields (degrees, active dims, priors) are
plain Python values. `with_flat_params(vec)` returns a new instance whose
tensor leaves are slices of `vec`, so a gradient with respect to the flat
vector comes from autograd on `vec`. The flat order is the field declaration
order, the same as the JAX package's (e.g. SEIso -> [ll, lsigma]).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["module", "replace", "Module", "asarray_fields"]


def module(*, static=()):
    """Make a class a frozen dataclass module.

    Fields named in ``static`` are configuration; all other fields are
    tensors (hyperparameters) or child modules. Python numbers passed for a
    tensor field become float64 tensors; `Module.to` moves them to the
    data's dtype and device.
    """

    def wrap(cls):
        def __post_init__(self):
            for f in self._data_fields:
                v = getattr(self, f)
                if not isinstance(v, Module):
                    object.__setattr__(self, f, _as_tensor(v))

        # set before dataclass() so that its __init__ calls the hook
        cls.__post_init__ = __post_init__
        cls = dataclasses.dataclass(frozen=True, repr=False, eq=False)(cls)
        names = [f.name for f in dataclasses.fields(cls)]
        cls._data_fields = tuple(n for n in names if n not in static)
        cls._meta_fields = tuple(static)
        if "__repr__" not in cls.__dict__:
            cls.__repr__ = _module_repr
        return cls

    return wrap


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=torch.float64)


def _module_repr(self) -> str:
    parts = []
    for f in dataclasses.fields(self):
        v = getattr(self, f.name)
        if isinstance(v, torch.Tensor) and v.ndim == 0:
            parts.append(f"{f.name}={float(v):.4g}")
        else:
            parts.append(f"{f.name}={v!r}")
    return f"{type(self).__name__}({', '.join(parts)})"


replace = dataclasses.replace


def asarray_fields(**kwargs) -> dict:
    """Constructor arguments as float64 tensors (for factory functions)."""
    return {k: torch.as_tensor(v, dtype=torch.float64) for k, v in kwargs.items()}


class Module:
    """Flat parameter protocol (`flat_params`, `with_flat_params`,
    `n_params`, `param_names`) and priors (`priors_flat`, `set_priors`,
    `prior_logpdf`, `sample_priors`), recursive over child modules so that
    wrappers such as FixedKernel can override what they expose at any
    depth of a composite."""

    # -- flat parameter protocol ------------------------------------------
    def flat_params(self) -> torch.Tensor:
        parts = []
        for f in self._data_fields:
            v = getattr(self, f)
            p = v.flat_params() if isinstance(v, Module) else v.reshape(-1)
            if p.numel():
                parts.append(p)
        if not parts:
            return torch.zeros(0, dtype=self.dtype, device=self.device)
        return torch.cat(parts)

    def with_flat_params(self, vec) -> "Module":
        updates, i = {}, 0
        for f in self._data_fields:
            v = getattr(self, f)
            if isinstance(v, Module):
                n = v.n_params
                updates[f] = v.with_flat_params(vec[i : i + n])
            else:
                n = v.numel()
                updates[f] = vec[i : i + n].reshape(v.shape)
            i += n
        if i != vec.shape[0]:
            raise ValueError(
                f"{type(self).__name__} has {i} parameters, got {vec.shape[0]}"
            )
        return dataclasses.replace(self, **updates)

    @property
    def n_params(self) -> int:
        total = 0
        for f in self._data_fields:
            v = getattr(self, f)
            total += v.n_params if isinstance(v, Module) else v.numel()
        return total

    def param_names(self) -> list:
        names = []
        for f in self._data_fields:
            v = getattr(self, f)
            if isinstance(v, Module):
                names.extend(f"{f}.{n}" for n in v.param_names())
            elif v.numel() == 1:
                names.append(f)
            else:
                names.extend(f"{f}_{i+1}" for i in range(v.numel()))
        return names

    # -- dtype and device --------------------------------------------------
    def tensors(self) -> list:
        """Every tensor leaf, in flat order."""
        out = []
        for f in self._data_fields:
            v = getattr(self, f)
            out.extend(v.tensors() if isinstance(v, Module) else [v])
        return out

    def with_tensors(self, leaves) -> "Module":
        """A copy whose tensor leaves are `leaves`, in the order `tensors()`
        gives them: how a batched sampler rebuilds a module (a cached
        factor) from the tensors that `torch.func.vmap` returns."""
        it = iter(leaves)

        def rebuild(m):
            return dataclasses.replace(m, **{
                f: rebuild(v) if isinstance(v, Module) else next(it)
                for f in m._data_fields for v in (getattr(m, f),)})

        return rebuild(self)

    @property
    def dtype(self) -> torch.dtype:
        leaves = self.tensors()
        return leaves[0].dtype if leaves else torch.float64

    @property
    def device(self) -> torch.device:
        leaves = self.tensors()
        return leaves[0].device if leaves else torch.device("cpu")

    def to(self, dtype=None, device=None) -> "Module":
        """A copy with every floating tensor leaf in `dtype`, and every
        leaf on `device`."""
        updates = {}
        for f in self._data_fields:
            v = getattr(self, f)
            cast = isinstance(v, Module) or v.is_floating_point()
            updates[f] = v.to(dtype=dtype if cast else None, device=device)
        return dataclasses.replace(self, **updates)

    # -- priors ------------------------------------------------------------
    # Leaf components that accept priors declare a static field
    # `priors: tuple` with one prior per local flat parameter; composites
    # concatenate their children's priors.
    def priors_flat(self) -> list:
        """One prior (or None) per entry of flat_params(), in order."""
        own = getattr(self, "priors", ())
        if own:
            out = list(own)
            if len(out) != self.n_params:
                raise ValueError(
                    f"{type(self).__name__}: {len(out)} priors for "
                    f"{self.n_params} parameters"
                )
            return out
        out = []
        for f in self._data_fields:
            v = getattr(self, f)
            if isinstance(v, Module):
                out.extend(v.priors_flat())
            else:
                out.extend([None] * v.numel())
        return out

    def set_priors(self, priors) -> "Module":
        priors = tuple(priors)
        if len(priors) != self.n_params:
            raise ValueError(
                f"{type(self).__name__} has {self.n_params} parameters, "
                f"got {len(priors)} priors"
            )
        if hasattr(self, "priors"):
            return dataclasses.replace(self, priors=priors)
        # composite: distribute across Module children in field order
        updates, i = {}, 0
        for f in self._data_fields:
            v = getattr(self, f)
            if isinstance(v, Module):
                updates[f] = v.set_priors(priors[i : i + v.n_params])
                i += v.n_params
            else:
                size = v.numel()
                if any(p is not None for p in priors[i : i + size]):
                    raise ValueError(
                        f"cannot attach priors to raw field {f!r} of composite "
                        f"{type(self).__name__}"
                    )
                i += size
        return dataclasses.replace(self, **updates)

    def prior_logpdf(self) -> torch.Tensor:
        """Sum of log prior densities over this module's flat params. Every
        prior's logpdf is elementwise, so a run of equal priors (an ARD
        kernel's length scales under one Normal, say) takes one call on its
        slice: fewer operators for each evaluation of a sampler's target."""
        priors = self.priors_flat()
        flat = self.flat_params()
        total = flat.new_zeros(())
        i = 0
        while i < len(priors):
            j = i + 1
            while j < len(priors) and priors[j] == priors[i]:
                j += 1
            if priors[i] is not None:
                total = total + torch.sum(priors[i].logpdf(flat[i:j]))
            i = j
        return total

    def sample_priors(self, generator: torch.Generator | None = None):
        """Draw a flat parameter vector from the priors, Uniform(-2, 2) for
        parameters without one (as the JAX package's sample_priors)."""
        priors = self.priors_flat()
        vals = []
        for pr in priors:
            if pr is not None:
                vals.append(float(pr.sample(generator)))
            else:
                u = torch.rand((), generator=generator, dtype=torch.float64)
                vals.append(float(-2.0 + 4.0 * u))
        return torch.tensor(vals, dtype=self.dtype, device=self.device)
