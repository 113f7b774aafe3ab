"""The port's outlier filters (``filtering.py``, ``ops/grid_knn.py``'s
scatter-block path) against the JAX package's and the f64 KDTree
reference, on the clouds of ``tests/test_filtering.py``."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu import filtering as jf
from ptv_interpolation_tpu.io.csvio import PointCloud as JaxCloud
from ptv_interpolation_tpu.ops.grid_knn import (
    scatter_knn_apply as jax_scatter_knn_apply)
from ptv_interpolation_tpu_torch import filtering as tf
from ptv_interpolation_tpu_torch.io.csvio import PointCloud
from ptv_interpolation_tpu_torch.ops.grid_knn import scatter_knn_apply
from ptv_interpolation_tpu_torch.ops.neighbors import build_cell_list
from ptv_interpolation_tpu_torch.utils import capture
import torch_port_fixtures as fx

torch.set_num_threads(2)


def _make_cloud(n=2000, n_outliers=25, seed=5):
    """``tests/test_filtering.py::_make_cloud``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, size=(n, 3))
    vals = np.stack([
        0.1 * np.sin(pts[:, 0]), 0.1 * np.cos(pts[:, 1]),
        np.ones(n)], axis=-1)
    out_idx = rng.choice(n, n_outliers, replace=False)
    vals[out_idx] *= 8.0
    return PointCloud(pts, vals), out_idx


def _reference_knn_mask(points, values, k, threshold):
    """``tests/test_filtering.py::_reference_knn_mask``: f64 KDTree."""
    from scipy.spatial import KDTree
    u, v, w = values.T
    speed = np.sqrt(u ** 2 + v ** 2 + w ** 2)
    _, idx = KDTree(points).query(points, k=k + 1)
    neighbor_speeds = speed[idx[:, 1:]]
    med = np.median(neighbor_speeds, axis=1)
    mad = np.median(np.abs(neighbor_speeds - med[:, None]), axis=1)
    return np.abs(speed - med) / (mad + 1e-6) <= threshold


def _branch(rec):
    """``(branch, n_uncovered)`` of the one filter call in a capture."""
    counts = rec.counters()
    branches = [name.rsplit(".", 1)[1] for name in counts
                if name.startswith("filter.branch.")]
    assert len(branches) == 1, counts
    return branches[0], counts["filter.uncovered"]


def _extreme_cloud():
    """``tests/test_filtering.py:109-135``: a mild speed gradient that puts
    many z-scores near the cut, plus one outlier at 1e6× typical speed."""
    cloud, _ = _make_cloud(n=5000, n_outliers=0, seed=13)
    vals = cloud.values.copy()
    rng = np.random.default_rng(13)
    vals[:, 2] += 0.02 * rng.standard_normal(len(vals))
    extreme = int(rng.integers(len(vals)))
    vals[extreme] *= 1e6
    return cloud.points, vals, extreme


@pytest.mark.parametrize("k", [25, 30])
def test_scatter_mad_full_parity_with_reference_on_extreme_outlier(k):
    """The fused route plus its exact re-decides reaches 100% decision
    parity with the f64 reference at odd and even k, and removes the
    extreme outlier."""
    pts, vals, extreme = _extreme_cloud()
    with capture() as rec:
        keep, radius = tf.knn_mad_mask_scatter(pts, vals, k=k,
                                               threshold=3.0, device="cpu")
    ref = _reference_knn_mask(pts.astype(np.float64),
                              vals.astype(np.float64), k, 3.0)
    assert not keep[extreme]
    assert (keep == ref).mean() == 1.0
    branch, n_unc = _branch(rec)
    assert branch in ("fused", "host_f64", "exact_scatter") and n_unc > 0
    assert np.isfinite(radius) and radius > 0


@pytest.mark.parametrize("k", [20, 25, 30])
def test_knn_mad_mask_bruteforce_matches_jax(k):
    cloud, out_idx = _make_cloud()
    jk, jr = jf.knn_mad_mask(cloud.points, cloud.values, k=k, threshold=3.0)
    tk, tr = tf.knn_mad_mask(cloud.points, cloud.values, k=k, threshold=3.0,
                             device="cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert float(tr) == pytest.approx(float(jr), rel=1e-6)
    assert not tk.numpy()[out_idx].any()


@pytest.mark.parametrize("k", [25, 30])
def test_remove_outliers_knn_matches_jax(k):
    cloud, _ = _make_cloud(n=3000, seed=2)
    jout = jf.remove_outliers_knn(JaxCloud(cloud.points, cloud.values), k=k,
                                  threshold=3.0, verbose=False)
    tout = tf.remove_outliers_knn(cloud, k=k, threshold=3.0, verbose=False,
                                  device="cpu")
    np.testing.assert_array_equal(tout.points, jout.points)
    np.testing.assert_array_equal(tout.values, jout.values)


@pytest.mark.parametrize("k", [25, 30])
def test_scatter_route_decides_as_the_bruteforce_route(k, monkeypatch):
    """With the size switch lowered, ``remove_outliers_knn`` takes the
    fused route; it keeps the same points as the JAX package's exact
    brute-force route."""
    cloud, out_idx = _make_cloud(n=3000, seed=2)
    monkeypatch.setattr(tf, "_SCATTER_MIN_POINTS", 1000)
    with capture() as rec:
        tout = tf.remove_outliers_knn(cloud, k=k, threshold=3.0,
                                      verbose=False, device="cpu")
    assert _branch(rec)[0] != "selection"
    jout = jf.remove_outliers_knn(JaxCloud(cloud.points, cloud.values), k=k,
                                  threshold=3.0, use_celllist=False,
                                  verbose=False)
    np.testing.assert_array_equal(tout.points, jout.points)


def test_speed_threshold_and_threshold_filter_match_jax():
    cloud, out_idx = _make_cloud()
    want = np.asarray(jf.speed_threshold_mask(cloud.values, 4.0))
    got = tf.speed_threshold_mask(cloud.values, 4.0, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[out_idx].any()
    a = tf.remove_outliers_threshold(cloud, 4.0, verbose=False)
    b = jf.remove_outliers_threshold(JaxCloud(cloud.points, cloud.values),
                                     4.0, verbose=False)
    np.testing.assert_array_equal(a.points, b.points)


@pytest.mark.parametrize("cfg", [
    dict(filter_outliers=True, filter_neighbors=25, filter_threshold=3.0,
         filter_max_speed=10.0),
    dict(filter_outliers=True, filter_neighbors=30, filter_threshold=4.0,
         filter_max_speed=5.0),
    dict(filter_outliers=False),
])
def test_apply_filters_matches_jax(cfg):
    cloud, _ = _make_cloud()
    vals = cloud.values.copy()
    vals[:7] *= 12.0                   # above both speed thresholds
    cloud = PointCloud(cloud.points, vals)
    got = tf.apply_filters(cloud, tf.FilterConfig(**cfg), verbose=False,
                           device="cpu")
    want = jf.apply_filters(JaxCloud(cloud.points, cloud.values),
                            jf.FilterConfig(**cfg), verbose=False)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.values, want.values)
    if cfg["filter_outliers"]:
        assert len(got) < len(cloud)


@pytest.mark.parametrize("n", [4, 5, 30, 31])
def test_nanmedian_is_numpys_median(n):
    """torch's own median returns the lower middle value; the port's
    averages the two, as np.median and np.nanmedian do, and skips NaN."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((64, n)).astype(np.float32)
    x[3, :] = 2.0                                      # ties
    got = tf.nanmedian(torch.from_numpy(x), dim=1).numpy()
    np.testing.assert_array_equal(got, np.median(x, axis=1))
    x[::3, ::2] = np.nan
    x[5] = np.nan                                      # an all-NaN row
    with np.errstate(invalid="ignore"), pytest.warns(RuntimeWarning):
        want = np.nanmedian(x, axis=1)
    got = tf.nanmedian(torch.from_numpy(x), dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    assert tf.nanmedian(torch.tensor([1.0, 2.0, 3.0, 4.0])) == 2.5


@pytest.mark.parametrize("k", [25, 30])
def test_scatter_knn_apply_exact_matches_jax(k):
    """The exact scatter-block kNN with the MAD consumer: identical keep
    flags, k-th distances within 1e-6 relative."""
    cloud, _ = _make_cloud(n=3000, seed=4)
    pts = cloud.points
    speed = np.sqrt((cloud.values ** 2).sum(axis=-1, keepdims=True))
    queries = pts[::7]
    want = jax_scatter_knn_apply(pts, speed, queries, k + 1,
                                 jf._mad_consume(k, 3.0), out_dim=2,
                                 exact_topk=True)
    got = scatter_knn_apply(pts, speed, queries, k + 1,
                            tf._mad_consume(k, 3.0), out_dim=2,
                            exact_topk=True, device="cpu")
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)


@pytest.mark.parametrize("recall_target", [0.95, 0.5])
def test_recall_target_matches_jax(recall_target):
    """``recall_target`` (the JAX package's ``approx_min_k``, an exact sort
    on the CPU) served by exact selection: the scatter-block kNN's keep
    flags identical to JAX's and its k-th distances within 1e-6, bit for
    bit its own ``exact_topk=True``; ``knn_mad_mask_scatter`` takes the
    selection path with the same decisions and radius as JAX's."""
    cloud, _ = _make_cloud(n=1500)
    pts = cloud.points
    speed = np.sqrt((cloud.values ** 2).sum(axis=-1, keepdims=True))
    queries = pts[::5]
    want = jax_scatter_knn_apply(pts, speed, queries, 9,
                                 jf._mad_consume(8, 3.0), out_dim=2,
                                 recall_target=recall_target)
    got = scatter_knn_apply(pts, speed, queries, 9, tf._mad_consume(8, 3.0),
                            out_dim=2, recall_target=recall_target,
                            device="cpu")
    exact = scatter_knn_apply(pts, speed, queries, 9,
                              tf._mad_consume(8, 3.0), out_dim=2,
                              exact_topk=True, device="cpu")
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
    jk, jr = jf.knn_mad_mask_scatter(pts, cloud.values, k=8,
                                     recall_target=recall_target)
    with capture() as rec:
        tk, tr = tf.knn_mad_mask_scatter(pts, cloud.values, k=8,
                                         recall_target=recall_target,
                                         device="cpu")
    assert _branch(rec) == ("selection", len(pts))
    np.testing.assert_array_equal(tk, jk)
    assert abs(tr - jr) <= 1e-6 * abs(jr)


def _clustered_cloud():
    """``torch_port_fixtures.clustered`` with 30 outliers planted ×8."""
    pts, vals, _, _ = fx.clustered()
    vals = vals.copy()
    vals[np.random.default_rng(4).choice(len(vals), 30, replace=False)] *= 8.0
    return pts, vals


@pytest.mark.parametrize("k", [10, 25])
def test_knn_mad_mask_cells_matches_jax(k):
    """``knn_mad_mask(cells=...)`` over the cell-list search: the same
    keep flags as the JAX package's on the clustered cloud (empty slots
    read the last point's speed on both sides), radius within 1e-6."""
    from ptv_interpolation_tpu.ops.neighbors import build_cell_list as jbcl
    pts, vals = _clustered_cloud()
    jk, jr = jf.knn_mad_mask(pts, vals, k=k, threshold=3.0,
                             cells=jbcl(pts, k_hint=k + 1))
    tk, tr = tf.knn_mad_mask(pts, vals, k=k, threshold=3.0,
                             cells=build_cell_list(pts, k_hint=k + 1,
                                                   device="cpu"),
                             device="cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert not tk.numpy().all()
    assert float(tr) == pytest.approx(float(jr), rel=1e-6)


@pytest.mark.parametrize("k,uses_cells", [(10, True), (25, False)])
def test_row_capacity_fallback_uses_the_cell_list(monkeypatch, k,
                                                  uses_cells):
    """When the scatter kernel refuses a clustered cloud
    (``RowCapacityError``), ``remove_outliers_knn`` falls back to the
    cell-list search, or to brute force where 27·cap > 16384 (k = 25
    here), as the JAX package does, and keeps the same points."""
    import ptv_interpolation_tpu.filtering as jax_filtering
    from ptv_interpolation_tpu.ops.grid_knn import (
        RowCapacityError as JaxRowCapacityError)
    from ptv_interpolation_tpu_torch.ops.grid_knn import RowCapacityError

    def refuse(error):
        def scatter(*a, **kw):
            raise error("cloud too clustered")
        return scatter

    monkeypatch.setattr(jax_filtering, "knn_mad_mask_scatter",
                        refuse(JaxRowCapacityError))
    monkeypatch.setattr(tf, "knn_mad_mask_scatter", refuse(RowCapacityError))
    seen = []
    mask = tf.knn_mad_mask
    monkeypatch.setattr(tf, "knn_mad_mask", lambda *a, **kw: (
        seen.append(kw["cells"]), mask(*a, **kw))[1])
    pts, vals = _clustered_cloud()
    jout = jf.remove_outliers_knn(JaxCloud(pts, vals), k=k, threshold=3.0,
                                  use_celllist=True, verbose=False)
    tout = tf.remove_outliers_knn(PointCloud(pts, vals), k=k, threshold=3.0,
                                  use_celllist=True, verbose=False,
                                  device="cpu")
    assert (seen[0] is not None) == uses_cells
    assert len(tout) < len(pts)
    np.testing.assert_array_equal(tout.points, jout.points)


def test_small_cloud_skips():
    cloud, _ = _make_cloud(n=10, n_outliers=0)
    assert len(tf.remove_outliers_knn(cloud, k=25, verbose=False,
                                      device="cpu")) == 10
