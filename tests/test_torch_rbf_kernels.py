"""The port's RBF kernels and polynomial basis (``ops/rbf_kernels.py``)
against the JAX package's on the same f32 inputs, r = 0 included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.ops import rbf_kernels as jrk
from ptv_interpolation_tpu_torch.ops import rbf_kernels as trk

torch.set_num_threads(2)


def _radii():
    rng = np.random.default_rng(0)
    r = np.concatenate([[0.0, 0.0, 1e-30, 1e-20, 1e-6, 1.0],
                        np.abs(rng.normal(size=500)) * 3.0])
    return r.astype(np.float32)


def test_tables_match_jax():
    assert trk.MIN_DEGREE == jrk.MIN_DEGREE
    assert trk.PD_KERNELS == jrk.PD_KERNELS
    assert trk.SCALE_INVARIANT == jrk.SCALE_INVARIANT
    for d in (-1, 0, 1, 2):
        assert trk.n_poly_terms(d) == jrk.n_poly_terms(d)


@pytest.mark.parametrize("kernel", sorted(jrk.MIN_DEGREE))
def test_kernel_value_matches_jax(kernel):
    """Within 1e-6 relative (exp, sqrt and log differ by an ulp); r = 0
    gives the same value, exactly 0 for thin-plate."""
    r = _radii()
    want = np.asarray(jrk.kernel_value(kernel, jnp.asarray(r)))
    got = trk.kernel_value(kernel, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] == want[0]
    if kernel == "thin_plate_spline":
        assert got[0] == 0.0 and not np.signbit(got[0])


def test_unknown_kernel_raises():
    with pytest.raises(ValueError, match="unknown RBF kernel"):
        trk.kernel_value("wendland", torch.zeros(3))


@pytest.mark.parametrize("degree", [-1, 0, 1, 2])
def test_polynomial_basis_matches_jax(degree):
    """Term order [1, x, y, z, x², xy, xz, y², yz, z²], bit for bit, on
    (…, 3) inputs with two leading axes."""
    x = np.random.default_rng(degree + 5).normal(size=(6, 4, 3)).astype(
        np.float32)
    want = np.asarray(jrk.polynomial_basis(jnp.asarray(x), degree))
    got = trk.polynomial_basis(torch.from_numpy(x), degree).numpy()
    assert got.shape == want.shape == (6, 4, trk.n_poly_terms(degree))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError):
        trk.polynomial_basis(torch.from_numpy(x), 3)
