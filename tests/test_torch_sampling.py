"""The port's ``ops/sampling.py::map_coordinates`` against the JAX
package's on the same volume and coordinates, run on the CPU: order 0 bit
for bit (JAX rounds half away from zero), orders 1 and 3 at rtol 1e-6 /
atol 1e-6 of max|volume|, on coordinates inside the volume, on
half-integers, and up to 3 voxels outside it."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.ops.sampling import map_coordinates as jax_map
from ptv_interpolation_tpu_torch.ops.sampling import map_coordinates

torch.set_num_threads(2)

SHAPE = (24, 27, 31)
RTOL = 1e-6


def _volume(seed=0):
    return np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)


def _coords(kind, q=4000, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "inside":
        c = [rng.uniform(0, n - 1, q) for n in SHAPE]
    elif kind == "half":
        # half-integers, negative ones included: the rounding ties
        c = [np.round(rng.uniform(-3, n + 2, q) * 2) / 2 for n in SHAPE]
        c = [np.where(np.mod(a, 1) == 0, a + 0.5, a) for a in c]
    elif kind == "integer":
        c = [rng.integers(-3, n + 3, q).astype(np.float64) for n in SHAPE]
    else:                               # up to 3 voxels outside
        c = [rng.uniform(-3, n + 2, q) for n in SHAPE]
    return np.stack(c).astype(np.float32)


KINDS = ("inside", "half", "integer", "outside")


@pytest.mark.parametrize("kind", KINDS)
def test_order0_bit_for_bit(kind):
    vol, c = _volume(), _coords(kind)
    want = np.asarray(jax_map(vol, c, order=0))
    got = map_coordinates(torch.from_numpy(vol), torch.from_numpy(c), 0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("order", (1, 3))
@pytest.mark.parametrize("kind", KINDS)
def test_orders_1_and_3_match_jax(order, kind):
    vol, c = _volume(), _coords(kind)
    want = np.asarray(jax_map(vol, c, order=order))
    got = map_coordinates(torch.from_numpy(vol), torch.from_numpy(c),
                          order).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(vol).max())


def test_half_way_ties_round_away_from_zero():
    """Ties on both sides of 0 and at the far edge: torch.round would send
    0.5 to 0 and 2.5 to 2; JAX's index is 1 and 3, −0.5 clamps to 0."""
    vol = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    t = np.asarray([-0.5, 0.5, 1.5, 2.5, SHAPE[2] - 1.5, SHAPE[2] - 0.5],
                   np.float32)
    c = np.stack([np.full_like(t, 2.0), np.full_like(t, 3.0), t])
    got = map_coordinates(torch.from_numpy(vol), torch.from_numpy(c), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_map(vol, c, 0)))
    np.testing.assert_array_equal(got.numpy() - vol[2, 3, 0],
                                  [0, 1, 2, 3, SHAPE[2] - 1, SHAPE[2] - 1])


def test_cubic_reproduces_grid_values_and_numpy_input():
    """Catmull-Rom interpolates: at integer coordinates it returns the
    voxel values exactly; numpy inputs are accepted."""
    vol = _volume(3)
    idx = np.stack([np.full(5, 3), np.arange(5), np.arange(5) + 2])
    got = map_coordinates(vol, idx.astype(np.float32), order=3)
    np.testing.assert_array_equal(got.numpy(), vol[3, np.arange(5),
                                                   np.arange(5) + 2])


def test_unsupported_order_raises():
    with pytest.raises(NotImplementedError):
        map_coordinates(_volume(), _coords("inside", 8), order=2)
