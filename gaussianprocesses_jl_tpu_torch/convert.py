"""Carry parameters across from the JAX package.

`load_flat(obj, vec, names)` takes a flat parameter vector as the JAX
package's `flat_params()` gives it (as a numpy array), and optionally its
`param_names()`, and returns `obj` with those values, on `obj`'s device and
in its dtype. Both packages keep the same flat order and names, so this is
how one model is made to compute the same thing in both.

`load_chains(obj, states, names)` carries a (C, D) array of chain states
(the JAX package's vmapped samplers give one flat vector a row) into a
(C, D) tensor on `obj`'s device and in its dtype, after the same checks: the
starting points or draws of a batch of chains.

`load_sparse(gp, kind, inducing, block_idx, block_mask)` gives a port GPE
the sparse strategy of a JAX model (its class name, its inducing points and,
for FSA, its padded partition, all as numpy or tuples), and
`load_approx(gp, m, v)` carries a JAX `Approx`'s (m, v) into the port's
`Approx`, each on `gp`'s device and in its dtype.

`load_distributed(gp, kind, mesh, axis, B, P_)` gives a port model the
distributed dense strategy of a JAX model (`DistributedFullCovariance` or
`AmbientFullCovariance`, with its axis and tile size) over a port `Mesh`;
`P_`, the JAX axis size, must be the port mesh's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_flat", "load_chains", "load_sparse", "load_approx", "load_distributed"]


def _checked(obj, arr, names, ndim):
    arr = np.asarray(arr)
    if arr.ndim != ndim or arr.shape[-1] != obj.n_params:
        raise ValueError(
            f"{type(obj).__name__} has {obj.n_params} parameters, "
            f"got an array of shape {arr.shape}")
    if names is not None and list(names) != obj.param_names():
        raise ValueError(
            f"parameter names differ: got {list(names)}, "
            f"expected {obj.param_names()}")
    return torch.as_tensor(arr, dtype=obj.dtype).to(obj.device)


def load_flat(obj, vec, names=None):
    """`obj.with_flat_params(vec)` after checking the count and the names."""
    return obj.with_flat_params(_checked(obj, vec, names, 1))


def load_chains(obj, states, names=None):
    """The (C, D) chain states `states` as a tensor on `obj`'s device and in
    its dtype, after checking that D is obj's parameter count and the names;
    row c is chain c's flat vector in obj's order."""
    return _checked(obj, states, names, 2)


_SPARSE = ("SubsetOfRegsStrategy", "DeterminTrainCondStrat", "FullyIndepStrat",
           "FullScaleApproxStrat")


def load_sparse(gp, kind, inducing, block_idx=None, block_mask=None):
    """`gp` with the sparse strategy named `kind` (the JAX model's strategy
    class name, the same in both packages) over `inducing` (m, d);
    FullScaleApproxStrat takes the padded partition (block_idx,
    block_mask), (nb, bmax) each, whose unmasked indices must partition
    range(gp.nobs)."""
    from .models import sparse

    if kind not in _SPARSE:
        raise ValueError(f"unknown sparse strategy {kind!r}")
    Xu = np.array(inducing, dtype=np.float64)
    Xu = Xu[:, None] if Xu.ndim == 1 else Xu
    if Xu.ndim != 2 or Xu.shape[1] != gp.dim:
        raise ValueError(f"inducing points must be (m, {gp.dim}), got {Xu.shape}")
    kw = {"inducing": torch.as_tensor(Xu, dtype=gp.dtype).to(gp.device)}
    if kind == "FullScaleApproxStrat":
        idx, mask = np.array(block_idx), np.array(block_mask, dtype=np.float64)
        if idx.ndim != 2 or idx.shape != mask.shape or not np.isin(mask, (0.0, 1.0)).all():
            raise ValueError("block_idx and block_mask must be (nb, bmax) alike, mask 0/1")
        if sorted(idx[mask > 0].tolist()) != list(range(gp.nobs)):
            raise ValueError("the unmasked block indices must partition the observations")
        kw["block_idx"] = torch.as_tensor(idx, dtype=torch.int64).to(gp.device)
        kw["block_mask"] = torch.as_tensor(mask, dtype=gp.dtype).to(gp.device)
    elif block_idx is not None or block_mask is not None:
        raise ValueError(f"{kind} takes no blocks")
    gp.covstrat = getattr(sparse, kind)(**kw)
    return gp


def load_approx(gp, m, v):
    """The port's Approx(m, v) of a GPA from a JAX Approx's arrays."""
    from .inference.vi import Approx

    m, v = np.array(m), np.array(v)
    if m.shape != (gp.nobs,) or v.shape != (gp.nobs,):
        raise ValueError(f"m and v must be ({gp.nobs},), got {m.shape} and {v.shape}")
    return Approx(m=gp._tensor(m), v=gp._tensor(v))


_DISTRIBUTED = ("DistributedFullCovariance", "AmbientFullCovariance")


def load_distributed(gp, kind, mesh, axis="j", B=None, P_=None):
    """`gp` (a GPE or GPA) with the port's strategy named `kind` over `mesh`
    axis `axis` with tile size B (None: chosen at build time; the ambient
    strategy needs one). P_ is the JAX strategy's axis size (its mesh's, or
    the ambient strategy's P_): it must equal the port mesh's."""
    from .parallel import dense

    if kind not in _DISTRIBUTED:
        raise ValueError(f"unknown distributed strategy {kind!r}")
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.axis_names}")
    if P_ is not None and P_ != mesh.shape[axis]:
        raise ValueError(f"the JAX strategy spans {P_} devices on {axis!r}, the mesh "
                         f"{mesh.shape[axis]} processes")
    if kind == "AmbientFullCovariance" and B is None:
        raise ValueError("AmbientFullCovariance needs a tile size B")
    kw = {} if B is None else {"B": int(B)}
    gp.covstrat = getattr(dense, kind)(mesh, axis=axis, **kw)
    return gp
