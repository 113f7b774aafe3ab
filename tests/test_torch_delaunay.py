"""The port's linear (Delaunay) interpolation (``interpolate/delaunay.py``)
against the JAX package's on the same seeded clouds: the device blend for
scattered queries, both host grid evaluators, the fill outside the hull
and the triangulation cache."""

import pickle

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.grid import create_grid as jax_create_grid
from ptv_interpolation_tpu.interpolate import delaunay as jdl
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import delaunay as tdl
import torch_port_fixtures as fx

torch.set_num_threads(2)

# the blend is f32 on both sides with the products summed in another order
RTOL, ATOL = 1e-5, 1e-6


def _queries(bounds, n=3000, seed=6):
    """Queries inside and up to 2 units outside the cloud's box, so a
    share of them lies outside the hull and gets the fill value."""
    hi = np.asarray([b[1] for b in bounds], np.float32)
    return np.random.default_rng(seed).uniform(-2.0, hi + 2.0,
                                               size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("cloud", ["uniform", "clustered", "ragged"])
@pytest.mark.parametrize("fill", [0.0, -7.5])
def test_linear_interpolate_matches_jax(cloud, fill):
    """The device blend in chunks of 700 queries against JAX's one shot,
    within rtol 1e-5 / atol 1e-6; nodes outside the hull exactly
    ``fill`` on both sides."""
    pts, vals, bounds, n = getattr(fx, cloud)()
    q = _queries(bounds)
    want = np.asarray(jdl.linear_interpolate(pts, vals, q, fill_value=fill))
    got = tdl.linear_interpolate(pts, vals, torch.from_numpy(q),
                                 fill_value=fill, query_chunk=700,
                                 device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    got = got.numpy()
    outside = tdl.get_cached_triangulation(pts).find_simplex(
        q.astype(np.float64)) < 0
    assert 0 < outside.sum() < len(q)
    assert (got[outside] == np.float32(fill)).all()
    assert (want[outside] == np.float32(fill)).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("evaluator", ["walk", "raster", "auto"])
@pytest.mark.parametrize("cloud", ["uniform", "void_region", "ragged"])
def test_linear_grid_interpolate_matches_jax(cloud, evaluator):
    """Both host evaluators (the same numpy and scipy code) give the JAX
    package's grid bit for bit, on the device as f32; the void's nodes,
    outside the hull, hold the fill."""
    pts, vals, bounds, n = getattr(fx, cloud)()
    want = jdl.linear_grid_interpolate(pts, vals, jax_create_grid(bounds, n),
                                       evaluator=evaluator, fill_value=0.0)
    got = tdl.linear_grid_interpolate(pts, vals, create_grid(bounds, n),
                                      evaluator=evaluator, fill_value=0.0,
                                      device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if cloud == "void_region":
        assert (got[-3:] == 0).all()


def test_walk_and_raster_agree():
    """The two evaluators are one interpolant (f64 barycentric weights),
    cast to f32."""
    pts, vals, bounds, n = fx.uniform()
    grid = create_grid(bounds, n)
    walk = tdl.linear_grid_interpolate(pts, vals, grid, evaluator="walk",
                                       device="cpu").numpy()
    raster = tdl.linear_grid_interpolate(pts, vals, grid, evaluator="raster",
                                         pair_chunk=5000,
                                         device="cpu").numpy()
    np.testing.assert_allclose(walk, raster, rtol=RTOL, atol=ATOL)


def test_triangulation_cache(tmp_path, monkeypatch):
    """One memory slot keyed by the points' content, a rebuild for another
    cloud, and pickles under PTV_TRI_CACHE_DIR named as the JAX package
    names them, so either package reads the other's."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 10, size=(200, 3))
    tdl._TRI_CACHE.clear()
    t1 = tdl.get_cached_triangulation(pts)
    assert tdl.get_cached_triangulation(torch.from_numpy(pts.copy())) is t1
    assert tdl.get_cached_triangulation(rng.uniform(0, 10, (180, 3))) \
        is not t1
    assert tdl._points_digest(pts) == jdl._points_digest(pts)

    monkeypatch.setenv("PTV_TRI_CACHE_DIR", str(tmp_path))
    jdl._TRI_CACHE.clear()
    t_jax = jdl.get_cached_triangulation(pts)      # the JAX package writes
    files = list(tmp_path.glob("tri_*.pkl"))
    assert len(files) == 1
    tdl._TRI_CACHE.clear()
    t_port = tdl.get_cached_triangulation(pts)     # the port reads it
    np.testing.assert_array_equal(t_port.simplices, t_jax.simplices)
    with open(files[0], "rb") as f:
        np.testing.assert_array_equal(pickle.load(f).simplices,
                                      t_port.simplices)

    # a corrupt entry is rebuilt; two linear calls share one triangulation
    files[0].write_bytes(b"not a pickle")
    tdl._TRI_CACHE.clear()
    q = rng.uniform(1, 9, size=(50, 3)).astype(np.float32)
    vals = rng.normal(size=(200, 2)).astype(np.float32)
    a = tdl.linear_interpolate(pts, vals, q, device="cpu")
    built = tdl._TRI_CACHE[tdl._points_digest(pts)]
    b = tdl.linear_interpolate(pts, vals, q, device="cpu")
    assert tdl._TRI_CACHE[tdl._points_digest(pts)] is built
    assert torch.equal(a, b)
    np.testing.assert_array_equal(built.simplices, t_jax.simplices)


def test_degenerate_cloud_raises():
    pts = np.zeros((10, 3))
    pts[:, 0] = np.arange(10)                  # collinear
    with pytest.raises(ValueError, match="Delaunay triangulation failed"):
        tdl.get_cached_triangulation(pts)
