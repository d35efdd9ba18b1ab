"""The port's sampler diagnostics (inference/diagnostics.py) against the
JAX package's on fixed arrays made from a seed: the multi-chain ESS (plain,
chunked, rank-normalized), the rank-normalized folded split-R-hat and the
rank normal scores, rtol 1e-10, for numpy and tensor input; including a
stuck chain and chains stuck in different modes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocesses_jl_tpu.inference import diagnostics as jd
from gaussianprocesses_jl_tpu_torch.inference import diagnostics as td


def _arrays():
    rng = np.random.RandomState(4)
    ar = np.cumsum(rng.randn(3, 81, 7), axis=1) * 0.1 + rng.randn(3, 81, 7)  # odd n
    stuck = rng.randn(4, 400, 2)
    stuck[0] = 1.234  # one chain constant over the whole window
    modes = np.where(np.arange(8) % 2 == 0, -5.0, 5.0)[:, None, None] + rng.randn(8, 300, 1)
    heavy = rng.standard_t(2, (4, 200, 3))
    single = rng.randn(500, 2)
    return {"ar": ar, "stuck": stuck, "modes": modes, "heavy": heavy, "single": single}


CASES = sorted(_arrays())


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_ess_and_rhat_match_jax(case, as_tensor):
    x = _arrays()[case]
    xin = torch.as_tensor(x) if as_tensor else x
    _close(td.effective_sample_size(xin), jd.effective_sample_size(jnp.asarray(x)))
    _close(td.effective_sample_size(xin, rank_normalized=True),
           jd.effective_sample_size(x, rank_normalized=True))
    _close(td.split_rhat(xin), jd.split_rhat(x))
    # chunked over dimensions, including a chunk that does not divide D
    for elems in (600, 960):
        _close(td.effective_sample_size(xin, max_workspace_elems=elems),
               jd.effective_sample_size(x, max_workspace_elems=elems))


def test_rank_normalize_matches_jax_on_both_paths():
    x = _arrays()["ar"]
    ref = np.asarray(jd.rank_normalize(jnp.asarray(x)))
    _close(td.rank_normalize(x), ref)  # numpy in, numpy out (the host path)
    assert isinstance(td.rank_normalize(x), np.ndarray)
    _close(td.rank_normalize(torch.as_tensor(x)), ref)
    ties = np.round(x, 1)  # ties rank in order, as jax.numpy's stable argsort
    _close(td.rank_normalize(torch.as_tensor(ties)), jd.rank_normalize(jnp.asarray(ties)))


def test_the_estimators_catch_what_they_exist_to_catch():
    """A stuck chain lowers the ESS without a NaN; chains in different
    modes get an ESS of O(chains) and an R-hat far above 1.01; shuffled,
    the same draws mix."""
    a = _arrays()
    good = a["stuck"].copy()
    good[0] = np.random.RandomState(0).randn(400, 2)
    e_stuck = td.effective_sample_size(a["stuck"])
    assert torch.isfinite(e_stuck).all() and (e_stuck < td.effective_sample_size(good)).all()
    assert float(td.effective_sample_size(a["modes"])[0]) < 3 * 8
    assert float(td.split_rhat(a["modes"])[0]) > 1.5
    flat = a["modes"].reshape(-1)
    np.random.RandomState(1).shuffle(flat)
    assert float(td.effective_sample_size(flat.reshape(8, 300, 1))[0]) > 2000
    assert float(td.split_rhat(flat.reshape(8, 300, 1))[0]) < 1.01
