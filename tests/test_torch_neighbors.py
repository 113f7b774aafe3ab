"""The port's cell list and brute-force kNN against the JAX package: the
integer layout bit for bit, distances at f32 tolerance."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.ops import neighbors as jnb
from ptv_interpolation_tpu_torch.ops import neighbors as tnb
from torch_port_fixtures import carry_cells

torch.set_num_threads(2)


def _cloud(n_pts, kind, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, 40, size=(n_pts, 3)).astype(np.float32)
    # gaussian blobs: uneven occupancy, many empty cells
    centers = rng.uniform(5, 35, size=(4, 3))
    pts = centers[rng.integers(0, 4, n_pts)] + rng.normal(
        scale=2.0, size=(n_pts, 3))
    return pts.astype(np.float32)


@pytest.mark.parametrize("n_pts,kind,cell_size", [
    (4000, "uniform", None),        # JAX numpy build path (n < 100k)
    (4000, "clustered", 0.9),
    (120_000, "uniform", None),     # JAX device build path (n ≥ 100k)
])
def test_build_cell_list_bit_equal(n_pts, kind, cell_size):
    pts = _cloud(n_pts, kind)
    want = jnb.build_cell_list(pts, cell_size=cell_size, k_hint=20,
                               build_table=False)
    got = tnb.build_cell_list(pts, cell_size=cell_size, k_hint=20,
                              device="cpu")
    assert got.dims == want.dims
    assert got.cap == want.cap
    assert got.n_points == want.n_points
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(want.starts))
    np.testing.assert_array_equal(got.points_sorted.numpy(),
                                  np.asarray(want.points_sorted))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    np.testing.assert_array_equal(got.inv_cell.numpy(),
                                  np.asarray(want.inv_cell))
    assert tnb.cell_meta_np(got)[1] == jnb.cell_meta_np(want)[1]


def test_cells_from_numpy_carries_the_jax_cell_list():
    pts = _cloud(4000, "uniform")
    jc = jnb.build_cell_list(pts, k_hint=20, build_table=False)
    carried = carry_cells(jc)
    built = tnb.build_cell_list(pts, k_hint=20, device="cpu")
    for field in ("starts", "order", "points_sorted", "origin", "inv_cell"):
        assert torch.equal(getattr(carried, field), getattr(built, field))
    assert (carried.dims, carried.cap, carried.n_points) == (
        built.dims, built.cap, built.n_points)
    assert carried.inv_host == built.inv_host


def test_auto_cell_size_matches_jax():
    lo, hi = np.zeros(3), np.array([10.0, 20.0, 5.0])
    assert tnb.auto_cell_size(5000, lo, hi, 30) == jnb.auto_cell_size(
        5000, lo, hi, 30)


@pytest.mark.parametrize("n_pts,k,point_chunk", [
    (3000, 8, 4096),
    (3000, 16, 512),     # several chunks through the running top-k
    (10, 20, 4096),      # k > n_points: inf-distance slots with index -1
])
def test_knn_bruteforce_matches_jax(n_pts, k, point_chunk):
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 30, size=(n_pts, 3)).astype(np.float32)
    q = rng.uniform(-2, 32, size=(700, 3)).astype(np.float32)
    wd, wi = jnb.knn_bruteforce(pts, q, k, query_tile=256,
                                point_chunk=point_chunk)
    gd, gi = tnb.knn_bruteforce(pts, q, k, query_tile=256,
                                point_chunk=point_chunk, device="cpu")
    wd, wi = np.asarray(wd), np.asarray(wi)
    gd, gi = gd.numpy(), gi.numpy()
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-6, atol=1e-6)
    # the same neighbour sets (order may differ only at exact ties)
    np.testing.assert_array_equal(np.sort(gi, axis=1), np.sort(wi, axis=1))
