"""Interface drag integration (staircase voxel faces & triangulated mesh).

Counterpart of ``ptv_interpolation_tpu/drag.py``, as PyTorch ops. Two
methods:

* ``staircase`` — sums pressure and one-sided viscous tractions over
  discrete voxel faces between fluid (label 0) and a solid/phase label,
  six masked reductions per label.
* ``mesh`` — triangulates the interface (marching tetrahedra) and
  integrates stresses sampled at ±0.25-voxel offsets along the normal
  ("offset velocity" method).

The JAX package runs the whole mesh pipeline on the device
(``surface.mesh_geometry_device`` → :func:`_mesh_tractions_t`) only on a
TPU, and elsewhere the host extractor with :func:`_mesh_tractions`; the
port takes the device pipeline on every device. :func:`_mesh_tractions`
is kept for the host-geometry form.

Reference quirk fixed deliberately (SURVEY §7 (b)): the reference's
staircase path crashes with ``KeyError: 'Fx'`` when ``volume`` is passed
(`velocity_analysis.py:503-509`) because it never combines Fx = Fx_v + Fx_p;
here both methods always emit the combined force and force density.
"""

from __future__ import annotations

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.ops.sampling import map_coordinates
from ptv_interpolation_tpu_torch.surface import mesh_geometry_device


def _empty_result():
    keys = ["Fx_v", "Fy_v", "Fz_v", "Fx_v_tan", "Fy_v_tan", "Fz_v_tan",
            "Fx_v_nor", "Fy_v_nor", "Fz_v_nor", "Fx_p", "Fy_p", "Fz_p",
            "Area"]
    return {k: 0.0 for k in keys}


def _labels_of(mask, labels):
    if labels is None:
        labels = np.unique(mask)
        labels = labels[labels > 0]
    return labels


def _combine(r, volume):
    """Add the combined force ``F* = F*_v + F*_p`` and, with ``volume``,
    the force density ``M* = F*/volume``."""
    for cname in "xyz":
        r[f"F{cname}"] = r[f"F{cname}_v"] + r[f"F{cname}_p"]
    if volume:
        for cname in "xyz":
            r[f"M{cname}"] = r[f"F{cname}"] / volume
    return r


# ---------------------------------------------------------------------------
# Staircase method
# ---------------------------------------------------------------------------

def _staircase_axis(u, v, w, pressure, label_mask, fluid_mask, axis,
                    viscosity, area, step):
    """Accumulate one axis' face contributions for one label.

    ``label_mask``/``fluid_mask`` are boolean volumes; faces are between
    cell i (curr) and i+1 (next) along ``axis``. Mirrors the index logic of
    `velocity_analysis.py:362-501` with both orientations fused. Returns
    0-d tensors ``(n_faces, f_p_axis, f_u, f_v, f_w)``.
    """
    n = u.shape[axis]

    def nxt(a):
        return a.narrow(axis, 1, n - 1)

    def cur(a):
        return a.narrow(axis, 0, n - 1)

    # orientation A: fluid(curr) → label(next); fluid side = curr
    idx_a = cur(fluid_mask) & nxt(label_mask)
    # orientation B: label(curr) → fluid(next); fluid side = next
    idx_b = cur(label_mask) & nxt(fluid_mask)

    n_faces = idx_a.sum() + idx_b.sum()

    p_face = 0.5 * (cur(pressure) + nxt(pressure))
    # pressure force on the label along +axis for A, −axis for B
    f_p_axis = (torch.where(idx_a, p_face, 0.0).sum()
                - torch.where(idx_b, p_face, 0.0).sum()) * area

    # one-sided wall gradients du/dn = −2 u_fluid / step; viscous force
    # F = −Σ μ (2·normal | 1·tangential) g A
    axis_comp = {0: "w", 1: "v", 2: "u"}[axis]
    forces = []
    for name, f in (("u", u), ("v", v), ("w", w)):
        g_a = -2.0 * cur(f) / step
        g_b = -2.0 * nxt(f) / step
        g = (torch.where(idx_a, g_a, 0.0).sum()
             + torch.where(idx_b, g_b, 0.0).sum())
        factor = 2.0 if name == axis_comp else 1.0
        forces.append(-viscosity * factor * g * area)
    return (n_faces, f_p_axis, *forces)


def compute_interface_drag_staircase(u, v, w, pressure, viscosity, dx, dy, dz,
                                     mask, labels=None, volume=None,
                                     device="cuda"):
    """Staircase drag (`velocity_analysis.py:332-511`). ``mask`` is an int
    label volume: 0 = fluid, >0 = solid/phase labels."""
    dev = resolve_device(device)
    mask = np.asarray(mask)
    labels = _labels_of(mask, labels)
    u, v, w = (as_f32(a, dev) for a in (u, v, w))
    p = (torch.zeros(u.shape, dtype=torch.float32, device=dev)
         if pressure is None else as_f32(pressure, dev))
    has_p = pressure is not None
    mask_d = torch.as_tensor(mask, device=dev)
    fluid = mask_d == 0

    dA = {0: dy * dx, 1: dz * dx, 2: dz * dy}
    h = {0: dz, 1: dy, 2: dx}
    results = {}
    for label in labels:
        r = _empty_result()
        label_mask = mask_d == int(label)
        for axis in range(3):
            out = torch.stack([t.to(torch.float64) for t in _staircase_axis(
                u, v, w, p, label_mask, fluid, axis, viscosity, dA[axis],
                h[axis])]).tolist()              # one host read per axis
            n_faces, f_p, fu, fv, fw = out
            r["Area"] += n_faces * dA[axis]
            axis_comp = {0: "z", 1: "y", 2: "x"}[axis]
            if has_p:
                r[f"F{axis_comp}_p"] += f_p
            for cname, fval in (("x", fu), ("y", fv), ("z", fw)):
                r[f"F{cname}_v"] += fval
                part = "nor" if cname == axis_comp else "tan"
                r[f"F{cname}_v_{part}"] += fval
        results[int(label)] = _combine(r, volume)
    return results


# ---------------------------------------------------------------------------
# Mesh method
# ---------------------------------------------------------------------------

def _traction_integrals(u, v, w, p, bg, ctr, inner, outer, nxp, nyp, nzp,
                        areas, delta_phys, viscosity, has_bg):
    """The offset-velocity tractions at the triangles, decomposed,
    classified and integrated: a dict of 0-d tensors. ``ctr``, ``inner``
    and ``outer`` are (3, N) voxel coordinates of the centroids and the
    ±0.25-voxel probes."""
    u_in = map_coordinates(u, inner, order=3)
    v_in = map_coordinates(v, inner, order=3)
    w_in = map_coordinates(w, inner, order=3)
    u_if = map_coordinates(u, ctr, order=1)
    v_if = map_coordinates(v, ctr, order=1)
    w_if = map_coordinates(w, ctr, order=1)

    tx_v = viscosity * (u_if - u_in) / delta_phys
    ty_v = viscosity * (v_if - v_in) / delta_phys
    tz_v = viscosity * (w_if - w_in) / delta_phys

    p_tri = map_coordinates(p, ctr, order=1)
    tx_p = p_tri * nxp
    ty_p = p_tri * nyp
    tz_p = p_tri * nzp

    t_dot_n = tx_v * nxp + ty_v * nyp + tz_v * nzp
    tx_nor, ty_nor, tz_nor = t_dot_n * nxp, t_dot_n * nyp, t_dot_n * nzp
    tx_tan, ty_tan, tz_tan = tx_v - tx_nor, ty_v - ty_nor, tz_v - tz_nor

    if has_bg:
        water = (map_coordinates(bg, outer, order=0) > 0.5).float()
    else:
        water = torch.ones_like(areas)
    solid = 1.0 - water

    def integ(t):
        return torch.sum(t * areas)

    return {
        "Fx_v": integ(tx_v), "Fy_v": integ(ty_v), "Fz_v": integ(tz_v),
        "Fx_v_tan": integ(tx_tan), "Fy_v_tan": integ(ty_tan),
        "Fz_v_tan": integ(tz_tan),
        "Fx_v_nor": integ(tx_nor), "Fy_v_nor": integ(ty_nor),
        "Fz_v_nor": integ(tz_nor),
        "Fx_p": integ(tx_p), "Fy_p": integ(ty_p), "Fz_p": integ(tz_p),
        "Area": torch.sum(areas),
        "Fx_water": integ((tx_v + tx_p) * water),
        "Fy_water": integ((ty_v + ty_p) * water),
        "Fz_water": integ((tz_v + tz_p) * water),
        "Fx_solid": integ((tx_v + tx_p) * solid),
        "Fy_solid": integ((ty_v + ty_p) * solid),
        "Fz_solid": integ((tz_v + tz_p) * solid),
        "Area_water": torch.sum(areas * water),
        "Area_solid": torch.sum(areas * solid),
    }


def _mesh_tractions(u, v, w, p, bg, centroids, n_unit_physical,
                    tri_areas, spacing_zyx, viscosity, has_bg):
    """The mesh drag's integrals from host-form geometry: (N, 3) voxel
    centroids and physical unit normals in (z, y, x) order, (N,) areas,
    as :func:`ptv_interpolation_tpu_torch.surface.triangle_geometry` and
    ``orient_normals`` give them (tensors on the fields' device). The
    voxel-space unit normals and the physical offset distance are derived
    from the physical normals and the spacing."""
    sp = torch.as_tensor(spacing_zyx, dtype=torch.float32,
                         device=centroids.device)
    n_vox = n_unit_physical / sp[None, :]
    n_vox = n_vox / torch.clamp_min(
        torch.linalg.vector_norm(n_vox, dim=1, keepdim=True), 1e-20)
    delta_phys = 0.25 * torch.sqrt(torch.sum((n_vox * sp[None, :]) ** 2,
                                             dim=1))
    nzp, nyp, nxp = n_unit_physical.unbind(1)
    return _traction_integrals(
        u, v, w, p, bg, centroids.T, (centroids + 0.25 * n_vox).T,
        (centroids - 0.25 * n_vox).T, nxp, nyp, nzp, tri_areas, delta_phys,
        viscosity, has_bg)


def _mesh_tractions_t(u, v, w, p, bg, cz, cy, cx, nzp, nyp, nxp, areas,
                      spacing_zyx, viscosity, has_bg):
    """:func:`_mesh_tractions` on component planes — the device mesh
    pipeline's form (centroids and normals arrive as (N,) planes from
    ``surface.mesh_geometry_device``)."""
    dz_, dy_, dx_ = (float(s) for s in spacing_zyx)
    nvz = nzp / dz_
    nvy = nyp / dy_
    nvx = nxp / dx_
    nrm = 1.0 / torch.clamp_min(
        torch.sqrt(nvz * nvz + nvy * nvy + nvx * nvx), 1e-20)
    nvz, nvy, nvx = nvz * nrm, nvy * nrm, nvx * nrm
    delta_phys = 0.25 * torch.sqrt((nvz * dz_) ** 2 + (nvy * dy_) ** 2
                                   + (nvx * dx_) ** 2)
    inner = torch.stack([cz + 0.25 * nvz, cy + 0.25 * nvy, cx + 0.25 * nvx])
    outer = torch.stack([cz - 0.25 * nvz, cy - 0.25 * nvy, cx - 0.25 * nvx])
    ctr = torch.stack([cz, cy, cx])
    return _traction_integrals(u, v, w, p, bg, ctr, inner, outer, nxp, nyp,
                               nzp, areas, delta_phys, viscosity, has_bg)


def compute_interface_drag_mesh(u, v, w, pressure, viscosity, dx, dy, dz,
                                mask, labels=None, mesh_step: int = 1,
                                volume=None, background_mask=None,
                                defer: bool = False, device="cuda"):
    """Mesh drag via marching tetrahedra + offset-velocity stress recovery
    (`velocity_analysis.py:513-657`), extraction, geometry, orientation and
    tractions all on ``device``; only the triangle counts and the force
    scalars come back.

    ``defer=True`` returns a zero-arg finisher instead of the results:
    all device work is dispatched, but the force scalars are read only
    when the finisher is called."""
    dev = resolve_device(device)
    mask = np.asarray(mask)
    labels = _labels_of(mask, labels)
    u, v, w = (as_f32(a, dev) for a in (u, v, w))
    p = (torch.zeros(u.shape, dtype=torch.float32, device=dev)
         if pressure is None else as_f32(pressure, dev))
    has_bg = background_mask is not None
    bg = as_f32(np.asarray(background_mask), dev) if has_bg else None
    mask_d = torch.as_tensor(mask, device=dev)

    pending = {}
    for label in labels:
        label_vol = mask_d == int(label)
        if not bool(label_vol.any()):
            continue
        geo, n_tri = mesh_geometry_device(
            label_vol, level=0.5, spacing=(dz, dy, dx), step_size=mesh_step,
            device=dev)
        if n_tri == 0:
            continue
        out = _mesh_tractions_t(
            u, v, w, p, bg, geo["cz"], geo["cy"], geo["cx"], geo["nzp"],
            geo["nyp"], geo["nxp"], geo["areas"], (dz, dy, dx), viscosity,
            has_bg)
        pending[int(label)] = out

    def finish():
        results = {}
        for label, out in pending.items():
            # one host read per label
            vals = torch.stack(list(out.values())).tolist()
            results[label] = _combine(dict(zip(out, vals)), volume)
        return results

    return finish if defer else finish()


def compute_interface_drag(u, v, w, pressure, viscosity, dx, dy, dz, mask,
                           labels=None, method: str = "staircase",
                           mesh_step: int = 1, volume=None,
                           background_mask=None, defer: bool = False,
                           device="cuda"):
    """Dispatcher matching the reference signature
    (`velocity_analysis.py:332-344`). ``defer`` — see
    :func:`compute_interface_drag_mesh`; the staircase path computes
    eagerly and wraps its result."""
    if method == "mesh":
        return compute_interface_drag_mesh(
            u, v, w, pressure, viscosity, dx, dy, dz, mask, labels,
            mesh_step=mesh_step, volume=volume,
            background_mask=background_mask, defer=defer, device=device)
    res = compute_interface_drag_staircase(
        u, v, w, pressure, viscosity, dx, dy, dz, mask, labels,
        volume=volume, device=device)
    return (lambda: res) if defer else res
