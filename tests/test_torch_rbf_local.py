"""The port's local RBF (``interpolate/rbf_local.py``) against the JAX
package's on the same seeded inputs: the batch-minor Gauss–Jordan solve,
the flat two-stage solve, the grid route and the scattered route with and
without the cell list, empty cell-list slots, a degenerate neighbourhood
and the progress callback."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.grid import create_grid as jax_create_grid
from ptv_interpolation_tpu.interpolate import rbf_local as jrl
from ptv_interpolation_tpu.ops.neighbors import (
    build_cell_list as jax_build_cell_list, knn_bruteforce)
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import rbf_local as trl
from ptv_interpolation_tpu_torch.ops import neighbors as tnb
from ptv_interpolation_tpu_torch.ops.neighbors import build_cell_list
import torch_port_fixtures as fx

torch.set_num_threads(2)

# Both sides run the same f32 algorithm, but the kernel values and sums
# round differently by an ulp (XLA also fuses the eliminations' multiply
# and subtract), which the saddle systems amplify by their condition
# number. Thin-plate, the default kernel, reaches rtol 1e-4 / atol 1e-5 at
# every value; every kernel reaches a relative L2 of 1e-4 (multiquadric,
# the worst conditioned here, 5.7e-5).
RTOL, ATOL = 1e-4, 1e-5
REL_L2 = 1e-4


def _assert_close(got, want, kernel="thin_plate_spline"):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= REL_L2 * np.linalg.norm(want)
    if kernel == "thin_plate_spline":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _saddle_systems(n_sys=300, k=20, seed=2):
    """Thin-plate local saddle systems (k = 20, degree 1) of random
    neighbourhoods, batch-minor: A (k+4, k+4, B), rhs (k+4, 3, B)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n_sys, k, 3)).astype(np.float32)
    r = np.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1))
    with np.errstate(divide="ignore", invalid="ignore"):
        K = np.where(r > 0, r * r * np.log(r), 0.0)
    K += 1e-6 * np.abs(K).max(axis=(1, 2), keepdims=True) * np.eye(k)
    P = np.concatenate([np.ones((n_sys, k, 1)), x], axis=2)
    A = np.zeros((n_sys, k + 4, k + 4))
    A[:, :k, :k], A[:, :k, k:], A[:, k:, :k] = K, P, P.transpose(0, 2, 1)
    rhs = np.zeros((n_sys, k + 4, 3))
    rhs[:, :k] = rng.normal(size=(n_sys, k, 3))
    return (A.transpose(1, 2, 0).astype(np.float32),
            rhs.transpose(1, 2, 0).astype(np.float32))


def test_gauss_solve_t_matches_jax():
    """Gauss–Jordan with partial pivoting, step for step: each system's
    solution within a relative L2 of 1e-4 of the JAX package's (2.8e-5
    at worst, condition numbers up to 1.2e4) and solving the system
    (residual < 1e-3 of the right-hand side, in f64); a singular system (a zero row and column)
    turns its own solution non-finite, the others untouched, as in
    JAX."""
    A, rhs = _saddle_systems()
    A[:, :, 7] = 0.0                              # system 7: singular
    A[:, :, 7][np.arange(24), np.arange(24)] = 1.0
    A[-1, :, 7] = A[:, -1, 7] = 0.0
    want = np.asarray(jrl._gauss_solve_t(jnp.asarray(A), jnp.asarray(rhs)))
    got = trl._gauss_solve_t(torch.from_numpy(A),
                             torch.from_numpy(rhs)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert not np.isfinite(got[:, :, 7]).all()
    ok = np.ones(A.shape[2], bool)
    ok[7] = False
    g, w = (a[:, :, ok].reshape(-1, ok.sum()).astype(np.float64)
            for a in (got, want))
    assert (np.linalg.norm(g - w, axis=0)
            <= REL_L2 * np.linalg.norm(w, axis=0)).all()
    res = (np.einsum("ijb,jcb->icb", A.astype(np.float64), got)
           - rhs)[:, :, ok]
    assert np.abs(res).max() < 1e-3 * np.abs(rhs).max()


def _knn_sets(pts, q, k, drop_every=7):
    """The JAX package's brute-force k-sets, a few slots of every
    ``drop_every``-th query marked missing (-1)."""
    d, i = knn_bruteforce(pts, q, k)
    sq = np.asarray(d) ** 2
    idx = np.array(i)
    idx[::drop_every, -3:] = -1
    return sq.astype(np.float32), idx


@pytest.mark.parametrize("kernel,degree", [
    ("thin_plate_spline", 1), ("cubic", 1), ("quintic", 2),
    ("multiquadric", 0), ("inverse_quadratic", -1)])
def test_rbf_solve_flat_matches_jax(kernel, degree):
    """The flat two-stage solve over 1 500 queries in chunks of 512 (a
    ragged last chunk), missing slots included."""
    pts, vals, bounds, n = fx.uniform(3000, 16)
    q = np.random.default_rng(3).uniform(1, 15, (1500, 3)).astype(np.float32)
    sq, idx = _knn_sets(pts, q, 20)
    want = jrl._rbf_solve_flat(jnp.asarray(pts), jnp.asarray(vals),
                               jnp.asarray(q), jnp.asarray(sq),
                               jnp.asarray(idx), 20, kernel, 0.0, 1.0,
                               degree, 3, chunk=512)
    got = trl._rbf_solve_flat(torch.from_numpy(pts), torch.from_numpy(vals),
                              torch.from_numpy(q), torch.from_numpy(sq),
                              torch.from_numpy(idx), 20, kernel, 0.0, 1.0,
                              degree, 3, chunk=512)
    _assert_close(got.numpy(), want, kernel)


def _planar_cloud():
    """200 points on the plane z = 5 and 600 above it; queries on the
    plane far from the others see only coplanar neighbours, for which
    thin-plate's degree-1 system is singular."""
    rng = np.random.default_rng(8)
    flat = np.concatenate([rng.uniform(0, 10, (200, 2)),
                           np.full((200, 1), 5.0)], axis=1)
    above = rng.uniform([0, 0, 8], [10, 10, 12], (600, 3))
    pts = np.concatenate([flat, above]).astype(np.float32)
    vals = np.stack([pts[:, 0] * 0.1, np.sin(pts[:, 1]), np.ones(len(pts))],
                    -1).astype(np.float32)
    q = np.concatenate([rng.uniform(2, 8, (40, 2)), np.full((40, 1), 5.0)],
                       axis=1)
    q = np.concatenate([q, rng.uniform([1, 1, 8.5], [9, 9, 11.5], (60, 3))])
    return pts, vals, q.astype(np.float32)


def test_degenerate_neighbourhood_matches_jax():
    """Coplanar neighbourhoods with thin-plate (degree 1): the flat solve
    and the scattered route give the JAX package's finite / non-finite
    pattern, and the well-posed queries of the same batch their values."""
    pts, vals, q = _planar_cloud()
    sq, idx = _knn_sets(pts, q, 10, drop_every=10 ** 6)
    want = np.asarray(jrl._rbf_solve_flat(
        jnp.asarray(pts), jnp.asarray(vals), jnp.asarray(q),
        jnp.asarray(sq), jnp.asarray(idx), 10, "thin_plate_spline", 0.0,
        1.0, 1, 3))
    got = trl._rbf_solve_flat(torch.from_numpy(pts), torch.from_numpy(vals),
                              torch.from_numpy(q), torch.from_numpy(sq),
                              torch.from_numpy(idx), 10, "thin_plate_spline",
                              0.0, 1.0, 1, 3).numpy()
    fin = np.isfinite(want).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(got).all(axis=1), fin)
    assert 0 < fin.sum() < len(q) and fin[40:].all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)

    want = np.asarray(jrl.rbf_local_interpolate(pts, vals, q, k=10))
    got = trl.rbf_local_interpolate(pts, vals, q, k=10, device="cpu").numpy()
    fin = np.isfinite(want).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(got).all(axis=1), fin)
    assert fin[40:].all()
    np.testing.assert_allclose(got[40:], want[40:], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cloud,kernel,block", [
    ("uniform", "thin_plate_spline", None),
    ("ragged", "thin_plate_spline", (2, 4, 8)),
    ("void_region", "cubic", (2, 4, 8)),
])
def test_rbf_local_grid_interpolate_matches_jax(cloud, kernel, block):
    """The grid route: exact k-sets from the gather path (ids in an f32
    channel) and the flat solve. Nodes with fewer valid neighbours than
    polynomial terms (the void's, whose block regions hold few points)
    are singular and non-finite on both sides; the rest as
    :func:`_assert_close` holds them."""
    pts, vals, bounds, n = getattr(fx, cloud)()
    kw = {} if block is None else dict(block=block)
    want = np.asarray(jrl.rbf_local_grid_interpolate(
        pts, vals, jax_create_grid(bounds, n), k=16, kernel=kernel, **kw))
    got = trl.rbf_local_grid_interpolate(pts, vals, create_grid(bounds, n),
                                         k=16, kernel=kernel, device="cpu",
                                         **kw)
    assert got.shape == want.shape
    got = got.numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.all() == (cloud != "void_region")
    _assert_close(got[fin], want[fin], kernel)


@pytest.mark.parametrize("cells", [False, True])
@pytest.mark.parametrize("kernel", ["thin_plate_spline", "quintic"])
def test_rbf_local_interpolate_matches_jax(cells, kernel):
    """The scattered route, brute force or cell list, at queries inside
    the cloud's box, as :func:`_assert_close` holds them. A query whose
    cell neighbourhood holds fewer than k points (the sparse background)
    is degenerate (see the next test) and left out here."""
    pts, vals, bounds, n = fx.clustered()
    q = np.random.default_rng(9).uniform(0, 24, (700, 3)).astype(np.float32)
    jc = jax_build_cell_list(pts, k_hint=20) if cells else None
    tc = build_cell_list(pts, k_hint=20, device="cpu") if cells else None
    want = np.asarray(jrl.rbf_local_interpolate(pts, vals, q, k=20,
                                                kernel=kernel, cells=jc))
    got = trl.rbf_local_interpolate(pts, vals, q, k=20, kernel=kernel,
                                    cells=tc, device="cpu").numpy()
    full = ~_ghost_rows(tc, q, 20) if cells else np.ones(len(q), bool)
    assert full.mean() > 0.5
    assert np.isfinite(want[full]).all() and np.isfinite(got[full]).all()
    _assert_close(got[full], want[full], kernel)


def _ghost_rows(cells, q, k):
    """The queries whose k-set holds an empty cell-list slot (id n)."""
    _, idx = tnb.celllist_tile_fn(cells, k)(torch.from_numpy(q))
    return (idx == cells.n_points).any(dim=1).numpy()


@pytest.mark.parametrize("kernel", ["thin_plate_spline", "cubic"])
def test_empty_slots_are_valid_neighbours_as_in_jax(kernel):
    """Queries inside the void cloud and at its corners, cells of 1.2: a
    corner's neighbourhood (8 of its 27 cells in the grid), and a few
    sparse ones inside, hold fewer than k points, and their empty slots (id n, d² 3.4e38) count as valid
    neighbours on both sides. The sentinel sets the scale, every offset
    collapses to ~1e-18, and the kernel matrix holds values that XLA
    flushes to 0 as subnormal, as the port does: those systems are
    singular, non-finite on both sides. The full neighbourhoods agree."""
    pts, vals, bounds, n = fx.void_region()
    rng = np.random.default_rng(4)
    corner = rng.uniform(0, 0.8, (200, 3)) + rng.choice([0.0, 15.2], (200, 3))
    q = np.concatenate([rng.uniform([3, 3, 1.5], [13, 13, 3.5], (200, 3)),
                        corner]).astype(np.float32)
    want = np.asarray(jrl.rbf_local_interpolate(
        pts, vals, q, k=20, kernel=kernel,
        cells=jax_build_cell_list(pts, cell_size=1.2)))
    cells = build_cell_list(pts, cell_size=1.2, device="cpu")
    got = trl.rbf_local_interpolate(pts, vals, q, k=20, kernel=kernel,
                                    cells=cells, device="cpu").numpy()
    ghost = _ghost_rows(cells, q, 20)
    assert ghost[200:].all() and 0 < (~ghost).sum() <= 200
    fin = np.isfinite(want).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(got).all(axis=1), fin)
    np.testing.assert_array_equal(fin, ~ghost)
    _assert_close(got[fin], want[fin], kernel)


def test_progress_callback_matches_jax():
    """``progress`` reports as the JAX package's does (after every 64
    tiles of 256, then the tail) and changes no value."""
    pts, vals, bounds, n = fx.uniform(2000, 12)
    q = np.random.default_rng(44).uniform(1, 11, (20_000, 3)).astype(
        np.float32)
    calls = {"jax": [], "port": []}
    want = np.asarray(jrl.rbf_local_interpolate(
        pts, vals, q, k=8, progress=lambda d, t: calls["jax"].append(d)))
    got = trl.rbf_local_interpolate(
        pts, vals, q, k=8, device="cpu",
        progress=lambda d, t: calls["port"].append(d)).numpy()
    assert calls["port"] == calls["jax"] == [16384, 20000]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = trl.rbf_local_interpolate(pts, vals, q, k=8, device="cpu")
    assert torch.equal(plain, torch.from_numpy(got))


def test_point_ids_past_f32_range_raise():
    grid = create_grid(((0, 2),) * 3, 2)
    huge = torch.zeros((1 << 24, 3))
    with pytest.raises(ValueError, match="2\\^24"):
        trl.rbf_local_grid_interpolate(huge, huge, grid, device="cpu")
