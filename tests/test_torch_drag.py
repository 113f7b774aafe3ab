"""The port's ``drag.py`` against the JAX package's on the same numpy
fields, run on the CPU, and against the analytic validations of
``tests/test_drag.py``.

Tolerances are relative to each label's force scale S, the largest |F*|
of its result (a component that nearly cancels, such as the pressure
force across a flat field, is compared on that scale): staircase rtol
1e-5; the mesh route against the JAX package's device pipeline
(``mesh_geometry_device`` + ``_mesh_tractions_t``, called directly — the
same algorithm, run on the CPU) rtol 1e-4; against JAX's public
``compute_interface_drag(method="mesh")``, which takes the host
extractor (f64 crossings) off the TPU, rtol 1e-3. Areas: rtol 1e-5
(staircase counts exactly), 1e-5 device, 1e-3 host.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptv_interpolation_tpu import drag as jd
from ptv_interpolation_tpu import surface as js
from ptv_interpolation_tpu_torch import drag as td
from ptv_interpolation_tpu_torch import surface as ts
from test_drag import (poiseuille_drag_setup, stokes_sphere,  # noqa: F401
                       test_staircase_parity_vs_numpy_port as _np_parity)

torch.set_num_threads(2)

SPACING = (0.7, 0.9, 1.1)            # dx, dy, dz
MU = 1e-3
VOLUME = 123.0


@functools.lru_cache(maxsize=None)
def _problem():
    """Two solid labels (1, 2) in a (32, 34, 36) box of smooth flow, the
    velocity zero inside them; a pressure gradient along z and x; a
    background mask splitting the box at x = 15."""
    zz, yy, xx = np.mgrid[0:32, 0:34, 0:36].astype(np.float64)
    lab = np.zeros(zz.shape, int)
    lab[((zz - 10) ** 2 + (yy - 12) ** 2 + (xx - 14) ** 2) < 36] = 1
    lab[((zz - 22) ** 2 + (yy - 20) ** 2 + (xx - 22) ** 2) < 25] = 2
    u = 0.1 * np.sin(xx * 0.2) + 0.05 * yy / 32
    v = 0.1 * np.cos(yy * 0.15)
    w = 1.0 + 0.2 * np.sin(zz * 0.1)
    p = -0.01 * zz + 0.001 * xx
    u, v, w = (np.asarray(a * (lab == 0), np.float32) for a in (u, v, w))
    p = np.asarray(p, np.float32)
    bg = (xx > 15).astype(int)
    return u, v, w, p, lab, bg


def _assert_drag_close(got, want, rtol, area_rtol):
    assert set(got) == set(want)
    for label in want:
        g, w = got[label], want[label]
        assert set(g) == set(w), (label, set(g) ^ set(w))
        forces = [k for k in w if k.startswith("F")]
        scale = max(abs(w[k]) for k in forces)
        for k in w:
            if k.startswith("Area"):
                tol = area_rtol * abs(w["Area"])
            elif k.startswith("M"):
                tol = rtol * scale / VOLUME
            else:
                tol = rtol * scale
            assert abs(g[k] - w[k]) <= tol, (label, k, g[k], w[k])


@pytest.mark.parametrize("with_p", (False, True), ids=("nopress", "press"))
def test_staircase_matches_jax(with_p):
    u, v, w, p, lab, _ = _problem()
    pr = p if with_p else None
    want = jd.compute_interface_drag(u, v, w, pr, MU, *SPACING, lab,
                                     method="staircase", volume=VOLUME)
    got = td.compute_interface_drag(u, v, w, pr, MU, *SPACING, lab,
                                    method="staircase", volume=VOLUME,
                                    device="cpu")
    assert sorted(got) == [1, 2] and "Mz" in got[1]
    _assert_drag_close(got, want, 1e-5, 1e-12)


def test_staircase_labels_and_defer():
    u, v, w, p, lab, _ = _problem()
    want = jd.compute_interface_drag(u, v, w, p, MU, *SPACING, lab,
                                     labels=[2], method="staircase")
    finish = td.compute_interface_drag(u, v, w, p, MU, *SPACING, lab,
                                       labels=[2], method="staircase",
                                       defer=True, device="cpu")
    got = finish()
    assert list(got) == [2] and "Mx" not in got[2]
    _assert_drag_close(got, want, 1e-5, 1e-12)


@functools.lru_cache(maxsize=None)
def _jax_device_mesh(with_bg):
    """The JAX package's device mesh pipeline, called directly."""
    u, v, w, p, lab, bg = _problem()
    dx, dy, dz = SPACING
    bgj = jnp.asarray(bg if with_bg else np.zeros(u.shape), jnp.float32)
    out = {}
    for label in (1, 2):
        geo, _ = js.mesh_geometry_device((lab == label).astype(np.float64),
                                         0.5, spacing=(dz, dy, dx))
        r = jd._mesh_tractions_t(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), jnp.asarray(p),
            bgj, geo["cz"], geo["cy"], geo["cx"], geo["nzp"], geo["nyp"],
            geo["nxp"], geo["areas"], jnp.asarray([dz, dy, dx], jnp.float32),
            jnp.float32(MU), jnp.asarray(with_bg))
        r = {k: float(x) for k, x in r.items()}
        for c in "xyz":
            r[f"F{c}"] = r[f"F{c}_v"] + r[f"F{c}_p"]
            r[f"M{c}"] = r[f"F{c}"] / VOLUME
        out[label] = r
    return out


def _port_mesh(with_bg):
    u, v, w, p, lab, bg = _problem()
    return td.compute_interface_drag(
        u, v, w, p, MU, *SPACING, lab, method="mesh", volume=VOLUME,
        background_mask=bg if with_bg else None, device="cpu")


@pytest.mark.parametrize("with_bg", (False, True), ids=("nobg", "bg"))
def test_mesh_matches_jax_device_pipeline(with_bg):
    got = _port_mesh(with_bg)
    _assert_drag_close(got, _jax_device_mesh(with_bg), 1e-4, 1e-5)
    if with_bg:
        r = got[1]
        assert 0 < r["Area_water"] < r["Area"]
        np.testing.assert_allclose(r["Area_water"] + r["Area_solid"],
                                   r["Area"], rtol=1e-6)


@pytest.mark.parametrize("with_bg", (False, True), ids=("nobg", "bg"))
def test_mesh_matches_jax_public_host_route(with_bg):
    """JAX's public mesh drag takes the host extractor off the TPU; the
    port's device pipeline agrees with it at rtol 1e-3 of the force scale
    (the gap is recorded in PERF.md)."""
    u, v, w, p, lab, bg = _problem()
    want = jd.compute_interface_drag(
        u, v, w, p, MU, *SPACING, lab, method="mesh", volume=VOLUME,
        background_mask=bg if with_bg else None)
    _assert_drag_close(_port_mesh(with_bg), want, 1e-3, 1e-3)


def test_mesh_defer_and_labels():
    u, v, w, p, lab, _ = _problem()
    finish = td.compute_interface_drag(u, v, w, None, MU, *SPACING, lab,
                                       labels=[1, 7], method="mesh",
                                       defer=True, device="cpu")
    got = finish()
    assert list(got) == [1]                     # label 7 is absent
    assert got[1]["Fz_p"] == 0.0 and "Mz" not in got[1]


def test_host_form_tractions_match_jax():
    """``_mesh_tractions`` on the host extractor's geometry, against the
    JAX package's on the same triangles."""
    u, v, w, p, lab, bg = _problem()
    dx, dy, dz = SPACING
    vol = (lab == 1).astype(np.float64)
    tris = js.marching_tetrahedra(vol, 0.5)
    c, a, n = js.triangle_geometry(tris, (dz, dy, dx))
    n = js.orient_normals(n, c, vol, (dz, dy, dx))
    for has_bg in (False, True):
        bgf = (bg if has_bg else np.zeros(u.shape)).astype(np.float32)
        want = jd._mesh_tractions(
            *(jnp.asarray(f) for f in (u, v, w, p, bgf)),
            jnp.asarray(c, jnp.float32), jnp.asarray(n, jnp.float32),
            jnp.asarray(a, jnp.float32), jnp.asarray([dz, dy, dx],
                                                     jnp.float32),
            jnp.float32(MU), jnp.asarray(has_bg))
        got = td._mesh_tractions(
            *(torch.from_numpy(f) for f in (u, v, w, p, bgf)),
            torch.tensor(c, dtype=torch.float32),
            torch.tensor(n, dtype=torch.float32),
            torch.tensor(a, dtype=torch.float32), (dz, dy, dx), MU, has_bg)
        want = {k: float(x) for k, x in want.items()}
        got = {k: float(x) for k, x in got.items()}
        _assert_drag_close({1: got}, {1: want}, 1e-4, 1e-5)


def test_mesh_uses_the_device_geometry(monkeypatch):
    """The port takes the device mesh pipeline on every device."""
    calls = []
    real = td.mesh_geometry_device

    def spy(*a, **kw):
        calls.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(td, "mesh_geometry_device", spy)
    _port_mesh(False)
    assert len(calls) == 2 and all(str(d) == "cpu" for d in calls)


# --- the analytic validations of tests/test_drag.py, on the port -----------

def test_stokes_sphere_drag_mesh(stokes_sphere):  # noqa: F811
    """Fz_v → −4πμaU, Fz_p → −2πμaU, ratio 1/2 (20% / ratio window)."""
    s = stokes_sphere
    res = td.compute_interface_drag(s["u"], s["v"], s["w"], s["p"], s["mu"],
                                    s["d"], s["d"], s["d"], s["mask"],
                                    method="mesh", device="cpu")
    d = res[1]
    target_v = -4 * np.pi * s["mu"] * s["radius"] * s["U_inf"]
    target_p = -2 * np.pi * s["mu"] * s["radius"] * s["U_inf"]
    assert abs(d["Fz_v"] - target_v) / abs(target_v) < 0.20
    assert abs(d["Fz_p"] - target_p) / abs(target_p) < 0.20
    assert 0.4 < abs(d["Fz_p"] / d["Fz_v"]) < 0.6


def test_poiseuille_pipe_drag_mesh(poiseuille_drag_setup):  # noqa: F811
    """Wall drag F = τ_w·2πRL within 20%, shear fraction > 0.95."""
    s = poiseuille_drag_setup
    d, mu = s["d"], s["mu"]
    dm = td.compute_interface_drag(s["u"], s["u"], s["w"], s["p"], mu,
                                   d, d, d, s["mask_fluid"].astype(int),
                                   method="mesh", device="cpu")[1]
    L = (s["nz"] - 1) * d
    target_f = mu * (-2 * s["U_max"] / s["radius"]) * 2 * np.pi \
        * s["radius"] * L
    assert abs(dm["Fz_v"] - target_f) / abs(target_f) < 0.20
    assert abs(dm["Fz_p"]) < 1e-12
    assert dm["Fz_v_tan"] / dm["Fz_v"] > 0.95


def test_poiseuille_pipe_drag_staircase(poiseuille_drag_setup):  # noqa: F811
    """Correct sign and scale, and the volume normalization that crashes
    the reference works."""
    s = poiseuille_drag_setup
    d, mu = s["d"], s["mu"]
    dm = td.compute_interface_drag(s["u"], s["u"], s["w"], s["p"], mu,
                                   d, d, d, (~s["mask_fluid"]).astype(int),
                                   method="staircase",
                                   volume=(40 * d) ** 3, device="cpu")[1]
    L = (s["nz"] - 1) * d
    target = abs(mu * (-2 * s["U_max"] / s["radius"]) * 2 * np.pi
                 * s["radius"] * L)
    assert dm["Fz_v"] > 0
    assert 0.5 < dm["Fz_v"] / target < 2.0
    assert "Mz" in dm and np.isfinite(dm["Mz"])


def test_staircase_parity_vs_numpy_port(poiseuille_drag_setup,  # noqa: F811
                                        monkeypatch):
    """``tests/test_drag.py``'s literal numpy sweep of the reference's
    face logic, with the port's staircase in place of the JAX package's."""
    import test_drag

    def port(*a, **kw):
        return td.compute_interface_drag(*a, device="cpu", **kw)

    monkeypatch.setattr(test_drag, "compute_interface_drag", port)
    _np_parity(poiseuille_drag_setup)


def test_multiphase_blob_classification():
    """Half-in-pore sphere: water/solid area split ≈ 50/50, zero drag for
    uniform internal velocity."""
    d, U_blob, mu = 1e-5, 0.1, 1e-3
    radius = 15.0 * d
    ax = (np.arange(60) - 30) * d
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    background = (x > 0).astype(int)
    blob = (r <= radius).astype(int)
    u = np.zeros_like(x)
    dm = td.compute_interface_drag(u, u, np.full_like(x, U_blob), u, mu,
                                   d, d, d, blob, method="mesh",
                                   background_mask=background,
                                   device="cpu")[1]
    assert abs(dm["Area_water"] / dm["Area"] - 0.5) < 0.1
    assert abs(dm["Fz_v"]) < 1e-10


def test_trapped_blob_drag_direction():
    """Stationary oil in a cavity under plug water flow: positive X drag
    of the right order."""
    nx, ny, nz = 100, 60, 3
    d, mu, U_water = 1e-6, 1e-3, 1e-4
    x_vox = np.arange(nx)
    y_vox = np.arange(ny) - ny // 2
    cavity_h, depth = 25, 12
    x_start, x_end = 20, 80
    x_rel = (x_vox - (x_start + x_end) / 2) / ((x_end - x_start) / 2)
    y_men = np.where((x_vox >= x_start) & (x_vox <= x_end),
                     -depth * (1 - x_rel ** 2), 0)
    y3 = np.broadcast_to(y_vox[None, :, None], (nz, ny, nx))
    x3 = np.broadcast_to(x_vox[None, None, :], (nz, ny, nx))
    men3 = np.broadcast_to(y_men[None, None, :], (nz, ny, nx))
    blob = ((y3 > -cavity_h) & (y3 <= men3)
            & (x3 >= x_start) & (x3 <= x_end)).astype(int)
    pore = ((y3 > 0) | (y3 > -cavity_h)).astype(int)
    u = np.where(y3 > men3, U_water, 0.0)
    zero = np.zeros_like(u)
    dm = td.compute_interface_drag(u, zero, zero, zero, mu, d, d, d, blob,
                                   method="mesh", background_mask=pore,
                                   device="cpu")[1]
    f_scale = mu * U_water / d * dm["Area"]
    assert dm["Fx_v"] > 0
    assert 0.01 * f_scale < dm["Fx_v"] < 10 * f_scale


def test_device_pipeline_area_matches_host_extractor():
    """The port's device mesh area equals its host extractor's on a label
    of the problem (rtol 1e-5: the same triangles, f32 crossings)."""
    _, _, _, _, lab, _ = _problem()
    vol = (lab == 2).astype(np.float64)
    sp = SPACING[::-1]
    geo, n_tri = ts.mesh_geometry_device(vol, 0.5, spacing=sp, device="cpu")
    tris = ts.marching_tetrahedra(vol, 0.5)
    assert n_tri == len(tris)
    np.testing.assert_allclose(float(geo["areas"].sum()),
                               ts.triangle_geometry(tris, sp)[1].sum(),
                               rtol=1e-5)
