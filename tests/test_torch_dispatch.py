"""The port's dispatcher (``interpolate/dispatch.py``) against the JAX
package's: every method of ``interpolate_values`` and ``interpolate_field``
on the same seeded cloud, the grid routes, the cell-list route, the cubic
refusal and fallback, and the verbose lines."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.grid import create_grid as jax_create_grid
from ptv_interpolation_tpu.interpolate import dispatch as jd
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import dispatch as td
from ptv_interpolation_tpu_torch.ops.neighbors import build_cell_list
import torch_port_fixtures as fx

torch.set_num_threads(2)


def _scattered():
    """The cloud of ``tests/test_interpolate.py``: 2 000 points of a
    smooth field in [0, 10]³, and 400 queries inside it."""
    rng = np.random.default_rng(42)
    pts = rng.uniform(0, 10, size=(2000, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.5) * np.cos(pts[:, 1] * 0.3),
                     pts[:, 2] * 0.1,
                     np.cos(pts[:, 0] * 0.2 + pts[:, 1] * 0.1)],
                    axis=-1).astype(np.float32)
    q = np.random.default_rng(43).uniform(1, 9, (400, 3)).astype(np.float32)
    return pts, vals, q


# method, keywords, (rtol, atol): nearest and the host-found simplices give
# the JAX package's values bit for bit; the weighted sums and RBF solves
# round in another order (tolerances as in test_torch_knn_weights.py,
# test_torch_rbf_local.py and test_torch_rbf_global.py). Brute force picks
# its k-sets by the matmul expansion of d², whose noise (~1e-5 of d² here)
# can swap two candidates at the k-th place that lie closer than that: at
# k = 16 one query of these 400 has points at 1.1235843 and 1.1235873, and
# the JAX package keeps the farther. The k used here have no such tie.
_METHODS = {
    "linear": ({}, (1e-5, 1e-6)),
    "nearest": ({}, (0, 0)),
    "idw": (dict(idw_neighbors=12, idw_power=3.0), (1e-5, 1e-6)),
    "sibson": (dict(sibson_neighbors=10), (1e-5, 1e-6)),
    # the grid route's edge nodes, worse conditioned, reach 3.4e-5
    "rbf": (dict(rbf_neighbors=20), (1e-4, 5e-5)),
    "rbf-global": (dict(rbf_neighbors=None, rbf_kernel="gaussian",
                        epsilon=3.0, smoothing=1e-3), (1e-4, 1e-4)),
    "cubic-fallback": (dict(cubic_fallback=True), (1e-4, 1e-5)),
}


def _method(name):
    return name.split("-")[0]


@pytest.mark.parametrize("name", sorted(_METHODS))
def test_interpolate_values_matches_jax(name):
    kw, (rtol, atol) = _METHODS[name]
    pts, vals, q = _scattered()
    if name == "rbf-global":
        pts, vals = pts[:600], vals[:600]
    want = np.asarray(jd.interpolate_values(pts, vals, q,
                                            method=_method(name), **kw))
    got = td.interpolate_values(pts, vals, q, method=_method(name),
                                device="cpu", **kw)
    assert got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["nearest", "idw", "sibson", "rbf"])
def test_celllist_route_matches_jax(name):
    """``neighbor_method='celllist'`` builds the cell list where the JAX
    package does (and ``cells=`` passes one in): the same values."""
    kw, (rtol, atol) = _METHODS[name]
    pts, vals, q = _scattered()
    want = np.asarray(jd.interpolate_values(
        pts, vals, q, method=name, neighbor_method="celllist", **kw))
    got = td.interpolate_values(pts, vals, q, method=name,
                                neighbor_method="celllist", device="cpu",
                                **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    k = {"nearest": 1, "idw": 12, "sibson": 10, "rbf": 20}[name]
    again = td.interpolate_values(
        pts, vals, q, method=name, neighbor_method="celllist",
        cells=build_cell_list(pts, k_hint=k, device="cpu"), device="cpu",
        **kw)
    assert torch.equal(again, got)


def test_clustered_cells_fall_back_to_bruteforce(monkeypatch):
    """On a cloud whose 27·cap exceeds 16 384 candidates the dispatcher
    drops the cell list for brute force, as the JAX package does."""
    from ptv_interpolation_tpu_torch.interpolate import knn_weights as tkw
    seen = []
    idw = tkw.idw_interpolate
    monkeypatch.setattr(td, "idw_interpolate", lambda *a, **kw: (
        seen.append(kw["cells"]), idw(*a, **kw))[1])
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.uniform(0, 10, (300, 3)),
                          5.0 + rng.uniform(0, 1e-3, (1000, 3))])
    pts = pts.astype(np.float32)
    vals = rng.normal(size=(len(pts), 3)).astype(np.float32)
    q = rng.uniform(0, 10, (50, 3)).astype(np.float32)
    got = td.interpolate_values(pts, vals, q, method="idw", idw_neighbors=8,
                                neighbor_method="celllist", device="cpu")
    want = jd.interpolate_values(pts, vals, q, method="idw", idw_neighbors=8,
                                 neighbor_method="celllist")
    assert seen == [None]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name,use_grid_kernel", [
    ("linear", "auto"), ("nearest", "auto"), ("idw", "never"),
    ("sibson", "never"), ("rbf", "never"), ("rbf", "always"),
    ("rbf-global", "always"), ("cubic-fallback", "auto")])
def test_interpolate_field_matches_jax(name, use_grid_kernel):
    """``interpolate_field`` on the ragged grid: the grid routes (linear's
    host walk, local RBF's gather path under 'always') and the generic
    one. Tensors on the device, each of shape ``grid.shape``."""
    kw, (rtol, atol) = _METHODS[name]
    pts, vals, bounds, n = fx.ragged()
    if name == "rbf-global":
        pts, vals = pts[:600], vals[:600]
    want = jd.interpolate_field(pts, vals, jax_create_grid(bounds, n),
                                method=_method(name),
                                use_grid_kernel=use_grid_kernel, **kw)
    got = td.interpolate_field(pts, vals, create_grid(bounds, n),
                               method=_method(name),
                               use_grid_kernel=use_grid_kernel, device="cpu",
                               **kw)
    for g, w in zip(got, want):
        assert torch.is_tensor(g) and g.shape == (13, 18, 21)
        w = np.asarray(w)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g.numpy()), fin)
        np.testing.assert_allclose(g.numpy()[fin], w[fin], rtol=rtol,
                                   atol=atol)


def test_cubic_raises_as_jax():
    pts, vals, q = _scattered()
    with pytest.raises(ValueError, match="2D-only") as got:
        td.interpolate_values(pts, vals, q, method="cubic", device="cpu")
    with pytest.raises(ValueError, match="2D-only") as want:
        jd.interpolate_values(pts, vals, q, method="cubic")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown interpolation method"):
        td.interpolate_values(pts, vals, q, method="kriging", device="cpu")


@pytest.mark.parametrize("method,kw", [
    ("sibson", {}), ("idw", {}), ("rbf", {}), ("rbf", dict(rbf_neighbors=None)),
    ("cubic", dict(cubic_fallback=True)), ("linear", {}), ("nearest", {})])
def test_verbose_lines_match_jax(method, kw):
    """The verbose prints, word for word."""
    pts, vals, q = _scattered()
    pts, vals = pts[:300], vals[:300]
    want = fx.printed_lines(jd.interpolate_values, pts, vals, q,
                            method=method, verbose=True, **kw)
    got = fx.printed_lines(td.interpolate_values, pts, vals, q,
                           method=method, verbose=True, device="cpu", **kw)
    assert got == want
    assert bool(got) == (method not in ("linear", "nearest"))
