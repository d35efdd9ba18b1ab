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
                                 "params", "family", "chains"])
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
        X = X[None, None]
    elif bad == "strided":
        X = torch.as_tensor(_X(20, 6))[:, ::2]
    elif bad == "features":
        X2 = torch.as_tensor(_X(5, 4))
    elif bad == "params":
        p = torch.zeros(2)
    elif bad == "family":
        fam = 6
    elif bad == "chains":
        p, X = torch.zeros((3, 3)), X.expand(2, 20, 3).contiguous()
    with pytest.raises((TypeError, ValueError)):
        gram_op.launch_gram(fam, p, X, X2)


def test_launchers_take_a_batch_of_chains_and_refuse_the_cpu():
    """Batched operands pass the launchers' checks (p (C, 3), X1 and X2
    shared or (C, n, d), the cotangent (C, n1, n2)) and are refused only for
    lying on the CPU; a 2-D cotangent with batched operands is not."""
    X, X2 = torch.as_tensor(_X(20, 3)), torch.as_tensor(_X(5, 3))
    P = torch.zeros((4, 3))
    for A, B in ((X, None), (X.expand(4, 20, 3).contiguous(), None), (X, X2),
                 (X.expand(4, 20, 3).contiguous(), X2)):
        assert gram_op.chain_count(P, A, B) == 4
        with pytest.raises(ValueError, match="CUDA"):
            gram_op.launch_gram(gram_op.SE, P, A, B)
        G = torch.zeros((4, 20, 20 if B is None else 5))
        with pytest.raises(ValueError, match="CUDA"):
            gram_op.launch_gram_vjp(gram_op.SE, P, A, B, G)
        with pytest.raises(ValueError, match="cotangent"):
            gram_op.launch_gram_vjp(gram_op.SE, P, A, B, G[0].contiguous())
    assert gram_op.chain_count(torch.zeros(3), X) is None


def _spy(monkeypatch):
    """Record the batched calls (those with a chain dimension) of the plain
    versions that the op's forward and backward run on CPU tensors."""
    calls = []
    for name in ("gram_plain", "gram_vjp_plain"):
        real = getattr(gram_op, name)

        def spy(family, p, X1, X2, *rest, real=real, name=name):
            if gram_op.chain_count(p, X1, X2, rest[0] if rest else None) is not None:
                calls.append((name, tuple(p.shape), tuple(X1.shape)))
            return real(family, p, X1, X2, *rest)

        monkeypatch.setattr(gram_op, name, spy)
    return calls


@pytest.mark.parametrize("ard", [False, True], ids=["iso", "ard"])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "cross"])
def test_vmap_over_chains_is_one_batched_call_equal_to_a_loop(monkeypatch, ard, sym):
    """`torch.func.vmap` of the gram, and of its gradient, over 5 chains'
    flat kernel parameters goes through the op's vmap rules: one batched
    forward and one batched backward (an iso kernel's X shared, an ARD
    kernel's scaled per chain), equal to a loop over the chains."""
    rng = np.random.RandomState(8)
    kern = gt.Matern(1.5, np.array([0.1, -0.2, 0.3]), 0.1) if ard else gt.RQ(0.1, 0.2, -0.3)
    X = torch.as_tensor(rng.randn(40, 3))
    X2 = None if sym else torch.as_tensor(rng.randn(17, 3))
    W = torch.as_tensor(rng.randn(40, 40 if sym else 17))
    thetas = kern.flat_params() + 0.1 * torch.as_tensor(rng.randn(5, kern.n_params))

    def f(t):
        return (W * kern.with_flat_params(t).gram(X, X2)).sum()

    calls = _spy(monkeypatch)
    K = torch.func.vmap(lambda t: kern.with_flat_params(t).gram(X, X2))(thetas)
    assert calls == [("gram_plain", (5, 3), (5, 40, 3) if ard else (40, 3))]
    calls.clear()
    g, v = torch.func.vmap(torch.func.grad_and_value(f))(thetas)
    assert [c[0] for c in calls] == ["gram_plain", "gram_vjp_plain"]
    for c in range(5):
        kc = kern.with_flat_params(thetas[c])
        np.testing.assert_allclose(K[c].numpy(), kc.gram(X, X2).numpy(), rtol=1e-14, atol=0)
        gc, vc = torch.func.grad_and_value(f)(thetas[c])
        np.testing.assert_allclose(g[c].numpy(), gc.numpy(), rtol=1e-12, atol=1e-14)
        assert float(v[c]) == pytest.approx(float(vc), rel=1e-14)
    # and the gradient of a vmapped function (the rules under autograd)
    t = thetas.clone().requires_grad_()
    (gb,) = torch.autograd.grad(torch.func.vmap(f)(t).sum(), t)
    np.testing.assert_allclose(gb.numpy(), g.numpy(), rtol=1e-12, atol=1e-14)
