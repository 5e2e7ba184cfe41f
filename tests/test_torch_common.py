"""The port's shared building blocks against the reference's, on the
CPU: ``layers.common.activation`` for every name.

``activation("gelu")`` is the tanh form, as ``jax.nn.gelu``'s default
(``approximate=True``) is; the exact erf form is up to 4.7e-4 away on
[-6, 6], which this test tells apart from f32 rounding (2e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.common import activation as ref_activation
from repro_torch.layers.common import activation

NAMES = ("silu", "gelu", "gelu_tanh", "relu")
ATOL = 2e-6


def _grid():
    return np.linspace(-6.0, 6.0, 24001, dtype=np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_activation_matches_the_reference(name):
    x = _grid()
    got = activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(ref_activation(name)(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_gelu_is_not_the_erf_form():
    """The grid tells the two GeLU forms apart by far more than the
    tolerance, so the check above pins the tanh form."""
    x = torch.from_numpy(_grid())
    gap = (torch.nn.functional.gelu(x) - activation("gelu")(x)).abs().max()
    assert float(gap) > 100 * ATOL
