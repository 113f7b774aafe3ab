"""The port's ``surface.py`` against the JAX package's, run on the CPU.

The host part is a copy and equals the JAX package's host functions
exactly. The device extractor gives JAX's ``marching_tetrahedra_device``
triangle count, its triangles in the same emission order (tet, triangle
slot, cube) within 1e-5 — so the same triangle set at 1e-5 — and its
total area at rtol 1e-5; ``mesh_geometry_device`` gives JAX's areas at
rtol 1e-5 and, at anisotropic spacing, its normals' orientation wherever
the orientation probe is decisive, and its area-weighted normal moments.
"""

import functools

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu import surface as js
from ptv_interpolation_tpu_torch import surface as ts
from ptv_interpolation_tpu_torch.ops.sampling import map_coordinates

torch.set_num_threads(2)

VERT_ATOL = 1e-5
AREA_RTOL = 1e-5


def _sphere(shape=(24, 24, 24), c=(12.0, 11.0, 13.0), r=8.0):
    zz, yy, xx = np.mgrid[tuple(slice(0, n) for n in shape)]
    return (((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
            < r * r).astype(np.float64)


def _corner_blob():
    """``tests/test_drag.py``'s corner-cube fixture: cube (0, 0, 0) is
    active, the JAX padding's aliasing case."""
    zz, yy, xx = np.mgrid[0:8, 0:8, 0:8]
    return ((zz + yy + xx) < 6.5).astype(np.float64)


def _smooth_field():
    """A non-binary volume: no presmooth, crossings anywhere in (0, 1).
    No node sits on the level 0.3 (f32 and f64 would split such ties
    differently between the device and host extractors)."""
    zz, yy, xx = np.mgrid[0:20, 0:22, 0:18].astype(np.float64)
    return np.sin(zz * 0.3) * np.cos(yy * 0.25) + 0.05 * xx + 0.0123


def _porous():
    """Two labels' worth of interface: a gyroid-like solid that touches
    every face of a (30, 28, 26) box."""
    zz, yy, xx = np.mgrid[0:30, 0:28, 0:26].astype(np.float64)
    return ((np.sin(xx * 0.35) * np.sin(yy * 0.3) * np.sin(zz * 0.25))
            > 0.3).astype(np.float64)


VOLUMES = {"sphere": _sphere, "corner": _corner_blob,
           "smooth": _smooth_field, "porous": _porous}


@functools.lru_cache(maxsize=None)
def _volume(name):
    return VOLUMES[name]()


def _area(tris):
    return js.triangle_geometry(tris)[1].sum()


@pytest.mark.parametrize("step", (1, 2))
@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_host_functions_equal_jax(name, step):
    vol = _volume(name)
    level = 0.3 if name == "smooth" else 0.5
    want = js.marching_tetrahedra(vol, level, step_size=step, slab=8)
    got = ts.marching_tetrahedra(vol, level, step_size=step, slab=8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts._box_smooth(vol, 2),
                                  js._box_smooth(vol, 2))
    if len(want):
        for g, w in zip(ts.triangle_geometry(got, (1.5, 1.0, 0.5)),
                        js.triangle_geometry(want, (1.5, 1.0, 0.5))):
            np.testing.assert_array_equal(g, w)
        c, _, n = js.triangle_geometry(want, (1.5, 1.0, 0.5))
        np.testing.assert_array_equal(
            ts.orient_normals(n, c, vol, (1.5, 1.0, 0.5)),
            js.orient_normals(n, c, vol, (1.5, 1.0, 0.5)))


def test_host_tables_equal_jax():
    for name in ("_TETS", "_EDGES", "_TRI_TABLE", "_CORNER_OFFSETS"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


@pytest.mark.parametrize("step", (1, 2))
@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_marching_tetrahedra_device_matches_jax(name, step):
    vol = _volume(name)
    level = 0.3 if name == "smooth" else 0.5
    want = js.marching_tetrahedra_device(vol, level, step_size=step)
    got = ts.marching_tetrahedra_device(vol, level, step_size=step,
                                        device="cpu")
    assert got.shape == want.shape and got.dtype == np.float64
    assert len(got) > 0
    # the same emission order, so row for row; hence the same set
    np.testing.assert_allclose(got, want, rtol=0, atol=VERT_ATOL)
    np.testing.assert_allclose(_area(got), _area(want), rtol=AREA_RTOL)
    # and the same triangles as the host sweep, in another order
    host = ts.marching_tetrahedra(vol, level, step_size=step)
    assert len(host) == len(got)
    np.testing.assert_allclose(_area(got), _area(host), rtol=1e-4)


def test_corner_cube_not_duplicated():
    """Cube (0, 0, 0) is active; each of its triangles appears once, as
    in the host sweep (``tests/test_drag.py``'s regression)."""
    vol = _corner_blob()
    host = ts.marching_tetrahedra(vol, 0.5)
    dev = ts.marching_tetrahedra_device(vol, 0.5, device="cpu")
    assert dev.shape == host.shape
    np.testing.assert_allclose(_area(dev), _area(host), rtol=1e-4)
    geo, n_tri = ts.mesh_geometry_device(vol, 0.5, device="cpu")
    assert n_tri == len(host) == geo["areas"].numel()
    np.testing.assert_allclose(float(geo["areas"].sum()), _area(host),
                               rtol=1e-4)


def test_empty_and_degenerate_volumes():
    assert ts.marching_tetrahedra_device(np.zeros((6, 6, 6)),
                                         device="cpu").shape == (0, 3, 3)
    assert ts.marching_tetrahedra_device(np.ones((1, 6, 6)),
                                         device="cpu").shape == (0, 3, 3)
    assert ts.mesh_geometry_device(np.ones((6, 6, 6)), device="cpu") == (
        None, 0)


SPACING = (1.5, 1.0, 0.5)


def _probe_ties(geo, vol, step):
    """Triangles whose orientation probe is a tie: the raw label volume
    sampled ±0.5 voxel along the normal gives values within 1e-6, so the
    sign is rounding noise in either package (both probes inside one
    phase of a coarsened binary volume)."""
    raw = torch.as_tensor(vol[::step, ::step, ::step], dtype=torch.float32)
    c = torch.stack([geo[k] / step for k in ("cz", "cy", "cx")])
    nv = torch.stack([geo[k] / s for k, s in zip(("nzp", "nyp", "nxp"),
                                                 SPACING)])
    nv = nv / torch.linalg.vector_norm(nv, dim=0)
    ahead = map_coordinates(raw, c + 0.5 * nv, order=1)
    behind = map_coordinates(raw, c - 0.5 * nv, order=1)
    return ((ahead - behind).abs() <= 1e-6).numpy()


@pytest.mark.parametrize("step", (1, 2))
@pytest.mark.parametrize("name", ("sphere_aniso", "porous"))
def test_mesh_geometry_device_matches_jax(name, step):
    vol = (_sphere((20, 22, 24), (10.0, 11.0, 12.0), 7.0)
           if name == "sphere_aniso" else _volume("porous"))
    geo_j, n_j = js.mesh_geometry_device(vol, 0.5, spacing=SPACING,
                                         step_size=step)
    geo, n_tri = ts.mesh_geometry_device(vol, 0.5, spacing=SPACING,
                                         step_size=step, device="cpu")
    assert n_tri == n_j
    got = {k: t.numpy() for k, t in geo.items()}
    want = {k: np.asarray(a)[:n_j] for k, a in geo_j.items()}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["areas"], want["areas"], rtol=AREA_RTOL,
                               atol=AREA_RTOL * want["areas"].max())
    np.testing.assert_allclose(got["areas"].sum(), want["areas"].sum(),
                               rtol=AREA_RTOL)
    for c in ("cz", "cy", "cx"):
        np.testing.assert_allclose(got[c], want[c], rtol=0,
                                   atol=VERT_ATOL * step)
    # oriented normals: every triangle whose probe is decisive points the
    # JAX package's way; the area-weighted first moments over those agree
    # as in tests/test_drag.py
    a = want["areas"]
    ties = _probe_ties(geo, vol, step)
    assert ties.mean() < 0.01
    dots = sum(got[nd] * want[nd] for nd in ("nzp", "nyp", "nxp"))
    live = ~ties & (a > 1e-6 * a.max())
    assert (dots[live] > 0.99).all()
    for nd in ("nzp", "nyp", "nxp"):
        np.testing.assert_allclose((got[nd] * got["areas"])[~ties].sum(),
                                   (want[nd] * a)[~ties].sum(), rtol=1e-3,
                                   atol=1e-3)


def test_mesh_geometry_device_matches_host_pipeline():
    """The device pipeline against the port's host trio (extract,
    geometry, orient) at anisotropic spacing."""
    vol = _sphere((20, 22, 24), (10.0, 11.0, 12.0), 7.0)
    host_t = ts.marching_tetrahedra(vol, level=0.5)
    c_h, a_h, n_h = ts.triangle_geometry(host_t, spacing=SPACING)
    n_h = ts.orient_normals(n_h, c_h, vol, spacing=SPACING)
    geo, n_tri = ts.mesh_geometry_device(vol, 0.5, spacing=SPACING,
                                         device="cpu")
    assert n_tri == len(host_t)
    a_d = geo["areas"].numpy()
    np.testing.assert_allclose(a_d.sum(), a_h.sum(), rtol=1e-4)
    for i, nd in enumerate(("nzp", "nyp", "nxp")):
        np.testing.assert_allclose((geo[nd].numpy() * a_d).sum(),
                                   (n_h[:, i] * a_h).sum(), rtol=1e-3,
                                   atol=1e-3)
    for i, cd in enumerate(("cz", "cy", "cx")):
        np.testing.assert_allclose(
            (geo[cd].numpy() * a_d).sum() / a_d.sum(),
            (c_h[:, i] * a_h).sum() / a_h.sum(), rtol=1e-4)


def test_sphere_area_and_inward_normals():
    """An extracted sphere's area is 4πR² within 5%, and the device
    pipeline's normals point into it (increasing label)."""
    n, R = 48, 14.0
    ax = np.arange(n) - n / 2 + 0.5
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    vol = ((X ** 2 + Y ** 2 + Z ** 2) < R ** 2).astype(float)
    geo, n_tri = ts.mesh_geometry_device(vol, 0.5, device="cpu")
    assert n_tri > 1000
    area = float(geo["areas"].sum())
    assert abs(area - 4 * np.pi * R ** 2) / (4 * np.pi * R ** 2) < 0.05
    center = n / 2 - 0.5
    inward = sum((center - geo[c].numpy()) * geo[nd].numpy()
                 for c, nd in (("cz", "nzp"), ("cy", "nyp"), ("cx", "nxp")))
    assert (inward > 0).mean() > 0.99
