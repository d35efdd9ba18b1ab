"""The port's gram op (ops/gram.py) against the JAX package's Pallas gram.

The JAX kernel runs as its own tests run it on the CPU (interpret mode);
the port's CPU path is the kernel's plain version. The CUDA kernel itself
runs only on the card (chip_smoke.py holds it against this plain version
there). Tolerance: f32 atol 1e-5, as in the JAX package's Pallas tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocesses_jl_tpu as gj
import gaussianprocesses_jl_tpu_torch as gt
from gaussianprocesses_jl_tpu.ops.pallas_gram import (
    _pack,
    _xla_reference,
    stationary_gram_pallas,
)
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op


def _X(n, d, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


PALLAS = [
    ("se_iso", lambda g: g.SEIso(ll=np.float32(0.3), lsigma=np.float32(0.2))),
    ("mat32_iso", lambda g: g.Mat32Iso(ll=np.float32(-0.1), lsigma=np.float32(0.1))),
    ("rq_iso", lambda g: g.RQIso(ll=np.float32(0.2), lsigma=np.float32(0.0),
                                 lalpha=np.float32(0.1))),
]


def _port_gram(kern, X, X2=None):
    k = kern.to(dtype=torch.float32)
    return k.gram(torch.as_tensor(X), None if X2 is None else torch.as_tensor(X2))


@pytest.mark.parametrize("name,build", PALLAS, ids=[k[0] for k in PALLAS])
@pytest.mark.parametrize("n", [256, 300])  # 300 is the ragged edge
def test_plain_gram_matches_pallas_interpret(name, build, n):
    X = _X(n, 3)
    kj, kt = build(gj), build(gt)
    K_pl = np.asarray(stationary_gram_pallas(kj, jnp.asarray(X)))
    K = _port_gram(kt, X)
    assert K.shape == (n, n) and K.dtype == torch.float32
    np.testing.assert_allclose(K.numpy(), K_pl, rtol=0, atol=1e-5)
    # symmetric diagonal pinned to profile(0)
    d0 = float(kt._r2profile(torch.zeros((), dtype=torch.float64)))
    np.testing.assert_allclose(K.diagonal().numpy(), d0, rtol=0, atol=1e-6)


XLA_REF = [
    ("se_ard", lambda g: g.SE(np.array([0.1, -0.2, 0.3]), 0.2)),
    ("periodic", lambda g: g.Periodic(ll=np.array(0.1), lsigma=np.array(0.05),
                                      lp=np.array(0.5))),
]


@pytest.mark.parametrize("name,build", XLA_REF, ids=[k[0] for k in XLA_REF])
@pytest.mark.parametrize("sym", [True, False])
def test_plain_gram_matches_xla_reference(name, build, sym):
    """ARD and Periodic through the Pallas module's `_xla_reference` (the
    math its kernel computes), on the inputs the kernel would see."""
    kj, kt = build(gj), build(gt)
    X1, X2 = _X(300, 3, 1), _X(77, 3, 2)
    scale = kj._scale if hasattr(kj, "_scale") else (lambda Z: Z)
    A = scale(jnp.asarray(X1, jnp.float32)).astype(jnp.float32)
    B = scale(jnp.asarray(X2, jnp.float32)).astype(jnp.float32)
    flat, treedef, specs = _pack(kj)
    ref = _xla_reference((treedef, specs, sym), flat, A, A if sym else B)
    K = _port_gram(kt, X1, None if sym else X2)
    np.testing.assert_allclose(K.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


STATIONARY = [
    gt.SE(0.3, 0.1), gt.SE(np.array([0.1, -0.2]), 0.1),
    gt.Matern(0.5, 0.2, -0.1), gt.Matern(0.5, np.array([0.1, -0.2]), -0.1),
    gt.Matern(1.5, 0.3, 0.2), gt.Matern(1.5, np.array([0.1, -0.2]), 0.2),
    gt.Matern(2.5, -0.1, 0.0), gt.Matern(2.5, np.array([0.1, -0.2]), 0.0),
    gt.RQ(0.2, 0.1, -0.3), gt.RQ(np.array([0.1, -0.2]), 0.1, -0.3),
    gt.Periodic(ll=0.1, lsigma=0.05, lp=0.5),
]


@pytest.mark.parametrize("kern", STATIONARY, ids=[type(k).__name__ for k in STATIONARY])
def test_family_and_params_give_back_the_modules_profile(kern):
    """The (family, [lsigma, ll, extra]) extraction that replaces `_pack`
    reproduces the module's own `_r2profile`, and the op's gram equals
    profile(sqdist) of the (ARD-scaled) inputs."""
    r2 = torch.tensor([0.0, 1e-3, 0.3, 1.0, 4.0, 25.0], dtype=torch.float64)
    got = gram_op.profile(kern._family, kern._gram_params(), r2)
    np.testing.assert_allclose(got.numpy(), kern._r2profile(r2).numpy(),
                               rtol=1e-14, atol=0)
    X = torch.as_tensor(np.random.RandomState(4).randn(9, 2))
    K = kern.gram(X)
    from gaussianprocesses_jl_tpu_torch.ops.distance import sqdist

    np.testing.assert_allclose(K.numpy(), kern._r2profile(sqdist(kern._scale(X))).numpy(),
                               rtol=1e-14, atol=0)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("wrt", ["all", "params", "inputs"])
def test_autograd_function_gradient_is_the_plain_gradient(sym, wrt):
    """On CPU tensors the autograd.Function's backward (`gram_vjp_plain`,
    the closed-form VJP) equals autograd straight through the plain version,
    in the hyperparameters and in both inputs, or in only some of them; X1
    holds a duplicate point off the diagonal (r = 0 there)."""
    rng = np.random.RandomState(5)
    X1np = rng.randn(40, 3)
    X1np[17] = X1np[3]
    X1 = torch.tensor(X1np, requires_grad=wrt != "params")
    X2 = torch.tensor(rng.randn(23, 3), requires_grad=wrt != "params")
    W = torch.tensor(rng.randn(40, 40 if sym else 23))
    for fam in range(gram_op.PERIODIC + 1):
        p = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64, requires_grad=wrt != "inputs")
        args = (p, X1) if sym else (p, X1, X2)
        wanted = [t for t in args if t.requires_grad]
        g_fn = torch.autograd.grad((W * gram_op.gram(fam, *args)).sum(), wanted)
        g_plain = torch.autograd.grad((W * gram_op.gram_plain(fam, *args)).sum(), wanted)
        for a, b in zip(g_fn, g_plain):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


def test_gram_op_counts_no_launch_on_cpu_and_launcher_refuses_cpu():
    X = torch.as_tensor(_X(20, 3))
    p = torch.tensor([0.0, 0.0, 0.0])
    before = gram_op.LAUNCHES["gram"]
    gram_op.gram(gram_op.SE, p, X)
    assert gram_op.LAUNCHES["gram"] == before
    with pytest.raises(ValueError, match="CUDA"):
        gram_op.launch_gram(gram_op.SE, p, X)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "ndim", "strided", "features",
                                 "params", "family"])
def test_launcher_validates_its_inputs(bad):
    X = torch.as_tensor(_X(20, 3))
    X2 = torch.as_tensor(_X(5, 3))
    p = torch.zeros(3)
    fam = gram_op.SE
    if bad == "dtype":
        X, X2, p = X.half(), X2.half(), p.half()
    elif bad == "mixed":
        X2 = X2.double()
    elif bad == "ndim":
        X = X[None]
    elif bad == "strided":
        X = torch.as_tensor(_X(20, 6))[:, ::2]
    elif bad == "features":
        X2 = torch.as_tensor(_X(5, 4))
    elif bad == "params":
        p = torch.zeros(2)
    elif bad == "family":
        fam = 6
    with pytest.raises((TypeError, ValueError)):
        gram_op.launch_gram(fam, p, X, X2)
