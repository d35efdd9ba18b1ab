"""`Beta.logpdf` of the port against `jax.scipy.stats.beta.logpdf` (the JAX
package's Beta prior), NaN included: JAX lets a NaN through its [0, 1]
mask, and a zero exponent contributes 0 even at NaN, so Beta(1, 1) gives 0
there and other shapes give NaN. f64; rtol 1e-12 with atol 1e-14 (a value
near 0 is a difference of two O(1) logs) on finite values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocesses_jl_tpu.utils import priors as jp
from gaussianprocesses_jl_tpu_torch.utils import priors as tp

SHAPES = [(1.0, 1.0), (2.0, 3.0), (0.5, 0.5), (2.0, 3.5), (1.0, 2.0), (3.0, 1.0)]
EDGES = [np.nan, -0.5, 0.0, 0.3, 1.0, 1.5, np.inf, -np.inf]


@pytest.mark.parametrize("a,b", SHAPES, ids=[f"{a:g},{b:g}" for a, b in SHAPES])
def test_beta_logpdf_matches_jax_with_nan_and_on_a_grid(a, b):
    xs = np.array(EDGES + list(np.linspace(0.0, 1.0, 21)))
    ref = np.asarray(jp.Beta(a, b).logpdf(jnp.asarray(xs)))
    got = tp.Beta(a, b).logpdf(torch.tensor(xs, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14, equal_nan=True)


def test_beta_logpdf_of_nan_as_in_the_table():
    nan = torch.tensor(float("nan"), dtype=torch.float64)
    assert float(tp.Beta(1.0, 1.0).logpdf(nan)) == 0.0
    assert np.isnan(float(tp.Beta(2.0, 3.0).logpdf(nan)))
    assert np.isnan(float(tp.Beta(0.5, 0.5).logpdf(nan)))
    # the gradient inside (0, 1) is unchanged: (a-1)/x - (b-1)/(1-x)
    np.testing.assert_allclose(float(tp.Beta(2.0, 3.0).gradlogpdf(0.3)),
                               1 / 0.3 - 2 / 0.7, rtol=1e-12)
    assert float(tp.Beta(1.0, 1.0).gradlogpdf(0.3)) == 0.0
