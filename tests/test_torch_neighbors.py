"""The port's cell list and brute-force kNN against the JAX package: the
integer layout bit for bit, distances at f32 tolerance."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.ops import neighbors as jnb
from ptv_interpolation_tpu_torch.ops import neighbors as tnb
import torch_port_fixtures as fx
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


# ---------------------------------------------------------------------------
# The generic cell-list search
# ---------------------------------------------------------------------------

def _coincident():
    """A uniform cloud where 400 points have a twin at the same position:
    ties in d² that only the slot order breaks."""
    rng = np.random.default_rng(23)
    pts = rng.uniform(0, 16, size=(1600, 3)).astype(np.float32)
    twins = rng.choice(len(pts), 400, replace=False)
    pts = np.concatenate([pts, pts[twins]])
    vals = rng.normal(size=(len(pts), 3)).astype(np.float32)
    return pts, vals, ((0, 17),) * 3, 16


_SEARCH_CASES = {
    # name: (cloud, k, build kwargs, rings)
    "uniform-k1": (fx.uniform, 1, {}, 1),
    "uniform-k8": (fx.uniform, 8, {}, 1),
    "ragged-k1": (fx.ragged, 1, {}, 1),
    "ragged-k40": (fx.ragged, 40, {}, 1),
    "clustered-k8": (fx.clustered, 8, {}, 1),
    "clustered-k40": (fx.clustered, 40, {}, 1),
    "void_region-k20": (fx.void_region, 20, {}, 1),
    # cells of 0.6: most 27-cell neighbourhoods hold fewer than 20 points,
    # so empty slots (id n) are selected
    "void_region-ghost-k20": (fx.void_region, 20, {"cell_size": 0.6}, 1),
    "coincident-k12": (_coincident, 12, {}, 1),
    "rings2-k20": (fx.uniform, 20, {"cell_size": 0.9}, 2),
    # cells of 0.1: 27·cap slots for k = 80, the rest id -1
    "short_panel-k80": (fx.void_region, 80, {"cell_size": 0.1}, 1),
}


def _search_inputs(case):
    cloud, k, build, rings = _SEARCH_CASES[case]
    pts, vals, bounds, n = cloud()
    rng = np.random.default_rng(31)
    hi = np.asarray([b[1] for b in bounds], np.float32)
    q = np.concatenate([rng.uniform(-1.0, hi + 1.0, size=(600, 3)),
                        pts[:100]]).astype(np.float32)  # self-queries tie at 0
    jc = jnb.build_cell_list(pts, k_hint=k, **build)
    tc = tnb.build_cell_list(pts, k_hint=k, device="cpu", **build)
    return pts, q, k, rings, jc, tc


def _assert_same_up_to_ties(tc, q, rings, got, want):
    """d² bit for bit, and per row the same ids for every d² below the
    (k+1)-th smallest of the row's panel. Among candidates at one d² the
    JAX package's order, and at the k-th place its choice, is that of
    XLA's sort behind ``approx_min_k`` on the CPU, which does not keep
    slot order; the port keeps slot order."""
    (got_sq, got_id), (want_sq, want_id) = got, want
    np.testing.assert_array_equal(got_sq, want_sq)
    k = got_sq.shape[1]
    panel = torch.sort(tnb.csr_candidate_panel(tc, torch.from_numpy(q),
                                               rings)[1], dim=1).values
    nxt = (panel[:, k].numpy() if panel.shape[1] > k
           else np.full(len(q), np.inf, np.float32))
    below = got_sq < nxt[:, None]
    for a, b, m in zip(got_id, want_id, below):
        np.testing.assert_array_equal(np.sort(a[m]), np.sort(b[m]))
    return (got_id != want_id).any(axis=1).sum()


@pytest.mark.parametrize("case", sorted(_SEARCH_CASES))
def test_celllist_tile_fn_matches_jax(case):
    """Ids and d² bit for bit against the JAX package's compiled search
    (its dense table and ``approx_min_k``, an exact sort off the TPU),
    empty slots (id n) and short panels (id -1) included. Where d² ties
    (coincident points) the ids agree up to the order of the tied ones."""
    import jax
    pts, q, k, rings, jc, tc = _search_inputs(case)
    assert (tc.dims, tc.cap) == (jc.dims, jc.cap)
    want = tuple(np.asarray(a) for a in jax.jit(
        jnb.celllist_tile_fn(jc, k, rings))(q))
    got = tuple(a.numpy() for a in tnb.celllist_tile_fn(tc, k, rings)(
        torch.from_numpy(q)))
    if case.startswith("coincident"):
        assert _assert_same_up_to_ties(tc, q, rings, got, want) > 0
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    n = len(pts)
    if "ghost" in case:
        assert (want[1] == n).any()
    if "short_panel" in case:
        assert 27 * tc.cap < k and (want[1] == -1).any()


def test_celllist_csr_tile_fn_matches_jax():
    """The sorted-index form, sentinel row ``n_points`` in the padding."""
    import jax
    pts, q, k, rings, jc, tc = _search_inputs("short_panel-k80")
    want = jax.jit(jnb.celllist_csr_tile_fn(jc, k, rings))(q)
    got = tnb.celllist_csr_tile_fn(tc, k, rings)(torch.from_numpy(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[1]) == len(pts)).any()


def test_knn_celllist_and_dispatch_match_jax():
    """``knn_celllist`` and ``knn(method=...)``: the same ids; distances
    within one ulp (XLA's CPU square root is not always the correctly
    rounded one that torch takes) or at f32 tolerance (brute force)."""
    pts, q, k, rings, jc, tc = _search_inputs("clustered-k8")
    for want, got in ((jnb.knn_celllist(jc, q, k),
                       tnb.knn_celllist(tc, q, k)),
                      (jnb.knn(pts, q, k, method="celllist"),
                       tnb.knn(pts, q, k, method="celllist", device="cpu"))):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1.2e-7, atol=0)
    wd, wi = jnb.knn(pts, q, k)                 # auto: Q·N ≤ 2³¹
    gd, gi = tnb.knn(pts, q, k, device="cpu")
    np.testing.assert_array_equal(np.sort(gi.numpy(), axis=1),
                                  np.sort(np.asarray(wi), axis=1))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown knn method"):
        tnb.knn(pts, q, k, method="kdtree", device="cpu")


@pytest.mark.parametrize("case", ["uniform-k8", "coincident-k12",
                                  "short_panel-k80"])
def test_approximate_selection_matches_jax(case):
    """``exact_topk=False`` and ``recall_target`` on both searches, served
    by exact selection: against the JAX package's ``approx_min_k`` at the
    same arguments, d² bit for bit and the ids equal up to the order of
    tied distances (the sorted-index form through ``cells.order``)."""
    import jax
    pts, q, k, rings, jc, tc = _search_inputs(case)
    tq = torch.from_numpy(q)
    order = np.concatenate([np.asarray(jc.order), [len(pts)]])
    for kw in (dict(exact_topk=False), dict(exact_topk=False,
                                            recall_target=0.5),
               dict(recall_target=0.95)):
        want = tuple(np.asarray(a) for a in jax.jit(
            jnb.celllist_tile_fn(jc, k, rings, **kw))(q))
        got = tuple(a.numpy() for a in
                    tnb.celllist_tile_fn(tc, k, rings, **kw)(tq))
        _assert_same_up_to_ties(tc, q, rings, got, want)
        want_sq, want_sorted = (np.asarray(a) for a in jax.jit(
            jnb.celllist_csr_tile_fn(jc, k, rings, **kw))(q))
        got_sq, got_sorted = tnb.celllist_csr_tile_fn(tc, k, rings,
                                                      **kw)(tq)
        _assert_same_up_to_ties(tc, q, rings,
                                (got_sq.numpy(), order[got_sorted.numpy()]),
                                (want_sq, order[want_sorted]))


def test_map_query_tiles_progress_matches_jax():
    """The progress callback is called as the JAX package calls it: after
    every 64 tiles, then once for the ragged tail; not at all when the
    queries fit in one batch. The results are the tiles' results."""
    q = np.random.default_rng(2).uniform(0, 1, size=(1000, 3)).astype(
        np.float32)
    calls = {"jax": [], "port": []}
    want = jnb.map_query_tiles(lambda t: t * 2.0, q, 7,
                               progress=lambda d, n: calls["jax"].append(
                                   (d, n)))
    got = tnb.map_query_tiles(lambda t: t * 2.0, torch.from_numpy(q), 7,
                              progress=lambda d, n: calls["port"].append(
                                  (d, n)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls["port"] == calls["jax"] == [(448, 1000), (896, 1000),
                                             (1000, 1000)]
    tnb.map_query_tiles(lambda t: t, torch.from_numpy(q), 1000,
                        progress=lambda d, n: calls["port"].append(d))
    assert len(calls["port"]) == 3
