"""The port's IDW/sibson weights, scattered interpolators and the whole
grid slice against the JAX package on the same inputs."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.grid import create_grid as jax_create_grid
from ptv_interpolation_tpu.interpolate import knn_weights as jkw
from ptv_interpolation_tpu.ops.fused_grid_knn import (
    fused_grid_weighted_interpolate as jax_fused_grid_weighted_interpolate)
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import knn_weights as tkw
from ptv_interpolation_tpu_torch.ops import fused_grid_knn as tfg
from ptv_interpolation_tpu_torch.ops import grid_knn as tgk
from ptv_interpolation_tpu_torch.utils import capture
import torch_port_fixtures as fx

torch.set_num_threads(2)


def _dist_and_mask(seed=4):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.05, 6.0, size=(64, 12)).astype(np.float32)
    ok = rng.uniform(size=d.shape) > 0.2
    ok[0] = False                      # a row with no valid neighbour
    return d, ok


@pytest.mark.parametrize("power", [2.0, 3.0])
def test_idw_weights_match_jax(power):
    d, ok = _dist_and_mask()
    for mask in (None, ok):
        want = np.asarray(jkw._idw_weights(d, power, mask))
        got = tkw._idw_weights(torch.from_numpy(d), power,
                               None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_sibson_weights_match_jax():
    d, ok = _dist_and_mask()
    for mask in (None, ok):
        want = np.asarray(jkw._sibson_weights(d, mask))
        got = tkw._sibson_weights(torch.from_numpy(d),
                                  None if mask is None
                                  else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("topk", [False, True])
def test_panel_weights_match_jax(topk):
    d, ok = _dist_and_mask()
    sq = np.sort(d, axis=1) ** 2 if topk else None
    for jfn, tfn in ((jkw._sibson_panel_weights(), tkw._sibson_panel_weights()),
                     (jkw._idw_panel_weights(2.0), tkw._idw_panel_weights(2.0))):
        assert tfn.canned_mode == jfn.canned_mode
        want = np.asarray(jfn(d, ok, sq))
        got = tfn(torch.from_numpy(d), torch.from_numpy(ok),
                  None if sq is None else torch.from_numpy(sq))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,k,n_pts", [
    ("sibson", 10, 2000), ("idw", 10, 2000), ("sibson", 20, 12),
])
def test_scattered_interpolate_matches_jax(mode, k, n_pts):
    rng = np.random.default_rng(8)
    pts = rng.uniform(0, 20, size=(n_pts, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0]), np.cos(pts[:, 1]), pts[:, 2]],
                    axis=-1).astype(np.float32)
    q = rng.uniform(-1, 21, size=(500, 3)).astype(np.float32)
    if mode == "sibson":
        want = jkw.sibson_interpolate(pts, vals, q, k=k, query_tile=128)
        got = tkw.sibson_interpolate(pts, vals, q, k=k, query_tile=128,
                                     device="cpu")
    else:
        want = jkw.idw_interpolate(pts, vals, q, k=k, query_tile=128)
        got = tkw.idw_interpolate(pts, vals, q, k=k, query_tile=128,
                                  device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


_SLICE_CASES = [
    ("uniform", "sibson", 12, (2, 4, 8)),
    ("uniform", "idw", 12, (2, 4, 8)),
    ("uniform", "sibson", 12, (4, 4, 8)),
    ("void_region", "sibson", 8, (2, 4, 8)),
    ("void_region", "idw", 8, (2, 4, 8)),
    ("skip_mask_cloud", "idw", 8, (2, 4, 8)),
    ("skip_mask_cloud", "sibson", 8, (2, 4, 8)),
    ("clustered", "sibson", 10, (2, 4, 8)),
    ("clustered", "idw", 10, (2, 4, 8)),
    ("ragged", "sibson", 10, (2, 4, 8)),
    ("ragged", "idw", 10, (4, 4, 8)),
]


@pytest.mark.parametrize("cloud,mode,k,block", _SLICE_CASES)
def test_grid_slice_matches_jax(cloud, mode, k, block):
    """The port's entry points on the CPU against the JAX fused path in
    interpret mode, at every node. Tolerance rtol 1e-4 / atol 1e-5: the
    JAX package repairs on the CPU through its streaming ladder, which
    differs from the fused repair by up to 1e-5."""
    pts, vals, bounds, n = getattr(fx, cloud)()
    skip = fx.skip_mask() if cloud == "skip_mask_cloud" else None
    want = np.asarray(jax_fused_grid_weighted_interpolate(
        pts, vals, jax_create_grid(bounds, n), k=k, mode=mode, block=block,
        skip_mask=skip, interpret=True))
    entry = (tkw.sibson_grid_interpolate if mode == "sibson"
             else tkw.idw_grid_interpolate)
    with capture() as rec:
        got = entry(pts, vals, create_grid(bounds, n), k=k, block=block,
                    skip_mask=skip, device="cpu")
    assert "kernel1.launches" not in rec.counters()  # CPU: no kernel launch
    assert got.device.type == "cpu" and got.shape == want.shape
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_grid_slice_after_refinement_matches_bruteforce(mode):
    """A cloud whose setup refines the cell list (the JAX package's CPU
    route there takes minutes): every node against exact brute-force kNN,
    which the τ-bisection selection matches bar f32 ties."""
    pts, vals, bounds, n = fx.dense_knot()
    grid = create_grid(bounds, n)
    entry, exact = ((tkw.sibson_grid_interpolate, tkw.sibson_interpolate)
                    if mode == "sibson" else
                    (tkw.idw_grid_interpolate, tkw.idw_interpolate))
    got = entry(pts, vals, grid, k=10, block=(2, 4, 8), device="cpu")
    Z, Y, X = np.meshgrid(grid.z, grid.y, grid.x, indexing="ij")
    q = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    want = exact(pts, vals, q, k=10, device="cpu").reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_grid_entry_points_refuse_unported_routes():
    """What stays refused: approximate selection on the fused kernel, a
    custom weight_fn there and the fused panel guard. The exact top-k
    gather route and the 'xla' and 'pallas' backends run."""
    pts, vals, bounds, n = fx.uniform(n_pts=1000, n=12)
    grid = create_grid(bounds, n)
    for entry in (tkw.sibson_grid_interpolate, tkw.idw_grid_interpolate):
        for kw in (dict(exact_topk=True), dict(backend="xla"),
                   dict(backend="pallas")):
            out = entry(pts, vals, grid, k=8, device="cpu", **kw)
            assert out.shape == (n, n, n, 3), kw
            assert bool(torch.isfinite(out).all()), kw
    with pytest.raises(ValueError, match="tau_mode='bisect' only"):
        tkw.sibson_grid_interpolate(pts, vals, grid, k=8, tau_mode="approx",
                                    backend="fused", device="cpu")
    with pytest.raises(ValueError, match="custom weight_fn"):
        tgk.grid_weighted_interpolate(pts, vals, grid, 8,
                                      lambda d, m, s: 1.0 / (d + 1e-6),
                                      backend="fused", device="cpu")
    with pytest.raises(tfg.FusedCapacityError):
        tfg.fused_grid_weighted_interpolate(pts, vals, grid, 8, max_panel=1,
                                            device="cpu")


@pytest.mark.parametrize("mode,backend", [("sibson", "auto"),
                                          ("idw", "xla")])
def test_approx_tau_mode_matches_jax(mode, backend):
    """``tau_mode='approx'`` (with ``recall_target``) against the JAX
    package's ``approx_min_k`` selection on the CPU, an exact sort there:
    the port serves it by exact selection, bit for bit its own
    ``tau_mode='exact'``, and within the slice tolerance of JAX's."""
    pts, vals, bounds, n = fx.void_region()
    entry = (tkw.sibson_grid_interpolate, tkw.idw_grid_interpolate)[
        mode == "idw"]
    jentry = (jkw.sibson_grid_interpolate, jkw.idw_grid_interpolate)[
        mode == "idw"]
    kw = dict(k=8, block=(2, 4, 8), backend=backend)
    want = np.asarray(jentry(pts, vals, jax_create_grid(bounds, n),
                             tau_mode="approx", recall_target=0.9, **kw))
    grid = create_grid(bounds, n)
    got = entry(pts, vals, grid, tau_mode="approx", recall_target=0.9,
                device="cpu", **kw)
    exact = entry(pts, vals, grid, tau_mode="exact", device="cpu", **kw)
    assert torch.equal(got, exact)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_cuda_device_raises_without_a_gpu():
    pts, vals, bounds, n = fx.uniform(n_pts=500, n=8)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        tkw.sibson_grid_interpolate(pts, vals, create_grid(bounds, n), k=8,
                                    device="cuda")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        tkw.idw_interpolate(pts, vals, pts[:4], k=8, device="cuda")


# ---------------------------------------------------------------------------
# The generic paths over the cell-list search, and nearest
# ---------------------------------------------------------------------------

def _cells_pair(pts, k):
    from ptv_interpolation_tpu.ops.neighbors import build_cell_list as jbcl
    from ptv_interpolation_tpu_torch.ops.neighbors import build_cell_list
    return jbcl(pts, k_hint=k), build_cell_list(pts, k_hint=k, device="cpu")


def _queries(bounds, n=800, seed=12):
    hi = np.asarray([b[1] for b in bounds], np.float32)
    return np.random.default_rng(seed).uniform(-1.0, hi + 1.0,
                                               size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("cloud", ["uniform", "clustered", "void_region",
                                   "ragged"])
@pytest.mark.parametrize("mode", ["idw", "sibson", "nearest"])
def test_celllist_interpolate_matches_jax(cloud, mode):
    """``cells=`` on the scattered entry points: nearest bit for bit (the
    search's ids are), idw and sibson within rtol 1e-5 / atol 1e-6 (sums
    in another order). Empty slots read the last point, as in JAX."""
    pts, vals, bounds, n = getattr(fx, cloud)()
    q = _queries(bounds)
    k = {"idw": 12, "sibson": 10, "nearest": 1}[mode]
    jc, tc = _cells_pair(pts, k)
    if mode == "nearest":
        want = jkw.nearest_interpolate(pts, vals, q, cells=jc)
        got = tkw.nearest_interpolate(pts, vals, q, cells=tc, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    jfn, tfn = ((jkw.idw_interpolate, tkw.idw_interpolate) if mode == "idw"
                else (jkw.sibson_interpolate, tkw.sibson_interpolate))
    want = jfn(pts, vals, q, k=k, cells=jc)
    got = tfn(pts, vals, q, k=k, cells=tc, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_empty_slots_read_the_last_point():
    """A neighbourhood of fewer than k points (cells of 0.6 on the void
    cloud): the empty slots (id n, d² 3.4e38) are weighted as the JAX
    package weights them and read the last point's values."""
    from ptv_interpolation_tpu.ops.neighbors import build_cell_list as jbcl
    from ptv_interpolation_tpu_torch.ops.neighbors import build_cell_list
    pts, vals, bounds, n = fx.void_region()
    q = _queries(bounds, 400)
    jc = jbcl(pts, cell_size=0.6)
    tc = build_cell_list(pts, cell_size=0.6, device="cpu")
    for jfn, tfn, kw in ((jkw.idw_interpolate, tkw.idw_interpolate,
                          dict(k=20)),
                         (jkw.sibson_interpolate, tkw.sibson_interpolate,
                          dict(k=20))):
        want = np.asarray(jfn(pts, vals, q, cells=jc, **kw))
        got = tfn(pts, vals, q, cells=tc, device="cpu", **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want = jkw.nearest_interpolate(pts, vals, q, cells=jc)
    got = tkw.nearest_interpolate(pts, vals, q, cells=tc, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a query whose neighbourhood is empty reads the last point
    far = np.asarray([[8.0, 8.0, 16.5]], np.float32)
    tc_far = build_cell_list(pts, cell_size=0.6, device="cpu")
    assert bool((tkw.nearest_interpolate(pts, vals, far, cells=tc_far,
                                         device="cpu")[0]
                 == torch.from_numpy(vals[-1])).all())


def test_nearest_bruteforce_matches_jax():
    pts, vals, bounds, n = fx.uniform()
    q = _queries(bounds)
    want = jkw.nearest_interpolate(pts, vals, q, query_tile=256)
    got = tkw.nearest_interpolate(pts, vals, q, query_tile=256, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nearest_celllist_differs_from_exact_as_jax_does():
    """The cell-list search is exact only within the ring radius: at
    k_hint = 1 on 40 000 uniform points a few queries' nearest point lies
    beyond it. The port picks the JAX package's point on every query, so
    it differs from an f64 cKDTree on the same queries as JAX does."""
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(40)
    pts = rng.uniform(0, 40, size=(40_000, 3)).astype(np.float32)
    vals = np.arange(len(pts), dtype=np.float32)[:, None]
    q = rng.uniform(0, 40, size=(50_000, 3)).astype(np.float32)
    jc, tc = _cells_pair(pts, 1)
    want = np.asarray(jkw.nearest_interpolate(pts, vals, q, cells=jc))
    got = tkw.nearest_interpolate(pts, vals, q, cells=tc,
                                  device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    exact = cKDTree(pts.astype(np.float64)).query(q.astype(np.float64))[1]
    off = got[:, 0] != exact
    assert 0 < off.sum() < 0.002 * len(q)
