"""Isosurface triangulation via marching tetrahedra.

Counterpart of ``ptv_interpolation_tpu/surface.py``. Two parts:

* host (numpy, copied from the JAX package unchanged): the case tables,
  :func:`_box_smooth`, :func:`marching_tetrahedra`, :func:`triangle_geometry`
  and :func:`orient_normals` (scipy's ``map_coordinates``);
* device (PyTorch): :func:`marching_tetrahedra_device` and
  :func:`mesh_geometry_device`, the same Kuhn subdivision, case tables and
  f32 crossings ``(lvl − va)/(vb − va)`` as flat passes over the active
  cubes, emitting triangles in the JAX package's order (tet, then
  triangle slot, then cube). The JAX package pads the active-cube and
  triangle counts to bound its jit cache; here both are compacted to the
  exact count with ``torch.nonzero``, so no padded lane exists.

Vertices are in voxel-index coordinates (z, y, x), level-0.5 crossing,
matching the skimage call the reference makes. Triangle normals are
oriented toward increasing field value (into the labeled phase), the same
convention skimage documents.
"""

from __future__ import annotations

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.ops.sampling import map_coordinates

# Kuhn subdivision: 6 tetrahedra around the main diagonal (corner 0 → 7).
# Cube corners are indexed by bits (z << 2 | y << 1 | x).
_TETS = np.asarray([
    (0, 1, 3, 7),
    (0, 1, 5, 7),
    (0, 2, 3, 7),
    (0, 2, 6, 7),
    (0, 4, 5, 7),
    (0, 4, 6, 7),
], np.int64)

# tet edge ids: e0=(0,1) e1=(0,2) e2=(0,3) e3=(1,2) e4=(1,3) e5=(2,3)
_EDGES = np.asarray([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], np.int64)

# case (4-bit inside mask) → up to 2 triangles of edge ids (-1 = unused)
_TRI_TABLE = -np.ones((16, 2, 3), np.int64)
_TRI_TABLE[1, 0] = (0, 1, 2)      # v0 inside
_TRI_TABLE[2, 0] = (0, 3, 4)      # v1
_TRI_TABLE[4, 0] = (1, 3, 5)      # v2
_TRI_TABLE[8, 0] = (2, 4, 5)      # v3
_TRI_TABLE[3] = [(1, 3, 4), (1, 4, 2)]       # v0,v1
_TRI_TABLE[5] = [(0, 2, 5), (0, 5, 3)]       # v0,v2
_TRI_TABLE[6] = [(0, 1, 5), (0, 5, 4)]       # v1,v2
_TRI_TABLE[9] = [(0, 1, 5), (0, 5, 4)]       # v0,v3
_TRI_TABLE[10] = [(0, 3, 5), (0, 5, 2)]      # v1,v3
_TRI_TABLE[12] = [(1, 3, 4), (1, 4, 2)]      # v2,v3
_TRI_TABLE[7, 0] = (2, 4, 5)      # all but v3
_TRI_TABLE[11, 0] = (1, 3, 5)     # all but v2
_TRI_TABLE[13, 0] = (0, 3, 4)     # all but v1
_TRI_TABLE[14, 0] = (0, 1, 2)     # all but v0

# cube-corner offsets (dz, dy, dx) per corner id
_CORNER_OFFSETS = np.asarray(
    [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], np.float64)


def _box_smooth(vol: np.ndarray, passes: int = 1) -> np.ndarray:
    """Separable 3-point box filter (edge-clamped). Applied to binary
    volumes before extraction so edge crossings interpolate sub-voxel:
    marching a raw 0/1 field puts every crossing at t=0.5, yielding a
    jagged surface whose area overshoots by ~25%; one smoothing pass
    brings sphere areas within ~2% of truth."""
    v = vol
    for _ in range(passes):
        for axis in range(3):
            lo = np.take(v, [0], axis=axis)
            hi = np.take(v, [-1], axis=axis)
            ext = np.concatenate([lo, v, hi], axis=axis)
            n = v.shape[axis]
            v = (np.take(ext, range(0, n), axis=axis)
                 + np.take(ext, range(1, n + 1), axis=axis)
                 + np.take(ext, range(2, n + 2), axis=axis)) / 3.0
    return v


def marching_tetrahedra(volume: np.ndarray, level: float = 0.5,
                        step_size: int = 1, slab: int = 32,
                        presmooth: int | None = None) -> np.ndarray:
    """Extract the ``level`` isosurface of ``volume`` (nz, ny, nx).

    Returns ``tri_verts`` of shape (n_tri, 3, 3): triangle vertices in
    (z, y, x) voxel-index coordinates, unoriented (see
    :func:`orient_normals`). ``step_size`` coarsens the cube lattice like
    skimage's parameter; ``slab`` bounds host memory by processing the
    volume in z-chunks. ``presmooth`` box-filter passes default to 1 for
    binary volumes (see :func:`_box_smooth`), 0 otherwise.
    """
    vol = np.ascontiguousarray(volume, np.float64)
    if step_size > 1:
        vol = vol[::step_size, ::step_size, ::step_size]
    if presmooth is None:
        presmooth = 1 if np.unique(vol).size <= 2 else 0
    if presmooth:
        vol = _box_smooth(vol, presmooth)
    nz, ny, nx = vol.shape
    if min(nz, ny, nx) < 2:
        return np.zeros((0, 3, 3))

    out = []
    for z0 in range(0, nz - 1, slab):
        z1 = min(z0 + slab + 1, nz)
        sub = vol[z0:z1]
        tris = _march_block(sub, level)
        if len(tris):
            tris[:, :, 0] += z0
            out.append(tris)
    if not out:
        return np.zeros((0, 3, 3))
    tris = np.concatenate(out)
    if step_size > 1:
        tris *= step_size
    return tris


def _march_block(vol: np.ndarray, level: float) -> np.ndarray:
    nz, ny, nx = vol.shape
    inside = vol > level

    # active cubes: mixed corners (cheap prefilter, O(volume) bitwise)
    c = inside[:-1, :-1, :-1]
    any_in = np.zeros_like(c)
    all_in = np.ones_like(c)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corner = inside[dz:nz - 1 + dz, dy:ny - 1 + dy, dx:nx - 1 + dx]
                any_in |= corner
                all_in &= corner
    active = any_in & (~all_in)
    zi, yi, xi = np.nonzero(active)
    if len(zi) == 0:
        return np.zeros((0, 3, 3))
    base = np.stack([zi, yi, xi], axis=1).astype(np.float64)   # (M, 3)

    # corner values for active cubes: (8, M)
    vals = np.empty((8, len(zi)))
    for cid in range(8):
        dz, dy, dx = (cid >> 2) & 1, (cid >> 1) & 1, cid & 1
        vals[cid] = vol[zi + dz, yi + dy, xi + dx]

    tris_out = []
    for tet in _TETS:
        tv = vals[tet]                                        # (4, M)
        bits = (tv > level)
        case = (bits[0].astype(np.int64) + 2 * bits[1]
                + 4 * bits[2] + 8 * bits[3])
        for k in range(2):
            edge_ids = _TRI_TABLE[case, k]                    # (M, 3)
            sel = edge_ids[:, 0] >= 0
            if not sel.any():
                continue
            eids = edge_ids[sel]                              # (Ms, 3)
            msel = np.nonzero(sel)[0]
            tri = np.empty((len(msel), 3, 3))
            for vtx in range(3):
                ea = _EDGES[eids[:, vtx], 0]                  # tet-local ids
                eb = _EDGES[eids[:, vtx], 1]
                ca = tet[ea]                                  # cube corner ids
                cb = tet[eb]
                va = vals[ca, msel]
                vb = vals[cb, msel]
                t = (level - va) / (vb - va)
                pa = base[msel] + _CORNER_OFFSETS[ca]
                pb = base[msel] + _CORNER_OFFSETS[cb]
                tri[:, vtx, :] = pa + t[:, None] * (pb - pa)
            tris_out.append(tri)
    if not tris_out:
        return np.zeros((0, 3, 3))
    return np.concatenate(tris_out)




# ---------------------------------------------------------------------------
# Device extractor (PyTorch)
# ---------------------------------------------------------------------------

def _device_volume(volume, step_size: int, presmooth, dev):
    """The (coarsened) f32 volume on ``dev`` and the presmooth passes:
    1 for a binary volume, else 0, unless given."""
    vol = torch.as_tensor(volume, dtype=torch.float32, device=dev)
    if step_size > 1:
        vol = vol[::step_size, ::step_size, ::step_size]
    vol = vol.contiguous()
    if presmooth is None:
        presmooth = 1 if torch.unique(vol).numel() <= 2 else 0
    return vol, presmooth


def _extract(vol, presmooth: int, level: float):
    """Smooth, find the active cubes, march and compact: the (9, n_tri)
    vertex planes (v0z, v0y, v0x, v1z, …) of the extracted triangles,
    or ``None`` when there are none."""
    vol_s = _device_smooth(vol, presmooth)
    active = _device_active(vol_s, level)
    if not bool(active.any()):
        return None
    planes, valid = _device_march(vol_s, active, level)
    tris = _device_compact(planes, valid)
    return tris if tris.shape[1] else None


def marching_tetrahedra_device(volume, level: float = 0.5,
                               step_size: int = 1,
                               presmooth: int | None = None, device="cuda"):
    """Device-side :func:`marching_tetrahedra`: the same Kuhn subdivision
    and case tables, evaluated as flat passes over the active cubes on
    ``device``. Returns the same (n_tri, 3, 3) numpy vertex array in
    (z, y, x) voxel coordinates as the host extractor — same triangles,
    order differing only by the flat-index sweep (tet, triangle slot,
    cube)."""
    dev = resolve_device(device)
    vol, presmooth = _device_volume(volume, step_size, presmooth, dev)
    if min(vol.shape) < 2:
        return np.zeros((0, 3, 3))
    tris = _extract(vol, presmooth, level)
    if tris is None:
        return np.zeros((0, 3, 3))
    n_tri = tris.shape[1]
    out = tris.cpu().numpy().T.reshape(n_tri, 3, 3).astype(np.float64)
    if step_size > 1:
        out *= step_size
    return out


def _device_smooth(vol, passes: int):
    """:func:`_box_smooth` on the device, in f32."""
    v = vol
    for _ in range(passes):
        for axis in range(3):
            n = v.shape[axis]
            ext = torch.cat([v.narrow(axis, 0, 1), v,
                             v.narrow(axis, n - 1, 1)], axis)
            v = (ext.narrow(axis, 0, n) + ext.narrow(axis, 1, n)
                 + ext.narrow(axis, 2, n)) / 3.0
    return v


def _device_active(vol, level):
    """Cubes whose 8 corners are neither all inside nor all outside."""
    inside = vol > level
    nz, ny, nx = vol.shape
    any_in = torch.zeros((nz - 1, ny - 1, nx - 1), dtype=torch.bool,
                         device=vol.device)
    all_in = torch.ones_like(any_in)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = inside[dz:nz - 1 + dz, dy:ny - 1 + dy, dx:nx - 1 + dx]
                any_in |= c
                all_in &= c
    return any_in & ~all_in


def _case_tables(dev):
    """Per (tet, triangle slot, vertex): the (16,) tables case → cube
    corner ids of the vertex's edge endpoints (invalid cases → corner 0),
    and per slot the (16,) table of cases that emit a triangle there."""
    has = [torch.as_tensor(_TRI_TABLE[:, kk, 0] >= 0, device=dev)
           for kk in range(2)]
    corners = {}
    for t in range(6):
        tet = _TETS[t]
        for kk in range(2):
            e_clip = np.clip(_TRI_TABLE[:, kk, :], 0, 5)       # (16, 3)
            for vtx in range(3):
                corners[t, kk, vtx] = tuple(
                    torch.as_tensor(tet[_EDGES[e_clip[:, vtx], end]],
                                    device=dev) for end in (0, 1))
    return has, corners


def _device_march(vol, active, level):
    """Triangle candidate planes for the active cubes: ``(planes, valid)``
    with ``planes`` (9, 12·m) — rows (v0z, v0y, v0x, v1z, …), one segment
    of m cubes per (tet, triangle slot) in that order — and ``valid``
    (12·m,). The active cubes are listed exactly (``torch.nonzero``), so
    no padded lane can repeat a cube."""
    nz, ny, nx = vol.shape
    flat = torch.nonzero(active.reshape(-1)).squeeze(1)
    ncyx = (ny - 1) * (nx - 1)
    zi = flat // ncyx
    yi = (flat // (nx - 1)) % (ny - 1)
    xi = flat % (nx - 1)
    vflat = vol.reshape(-1)
    vals = torch.stack([
        vflat[((zi + ((cid >> 2) & 1)) * ny + (yi + ((cid >> 1) & 1))) * nx
              + (xi + (cid & 1))] for cid in range(8)])       # (8, m)
    base = (zi.float(), yi.float(), xi.float())
    has, corners = _case_tables(vol.device)

    planes_all = [[] for _ in range(9)]
    valid_all = []
    for t in range(6):
        tv = vals[torch.as_tensor(_TETS[t], device=vol.device)]   # (4, m)
        case = ((tv[0] > level).long() + 2 * (tv[1] > level)
                + 4 * (tv[2] > level) + 8 * (tv[3] > level))
        for kk in range(2):
            for vtx in range(3):
                ca_tab, cb_tab = corners[t, kk, vtx]
                ca, cb = ca_tab[case], cb_tab[case]
                va = vals.gather(0, ca[None])[0]
                vb = vals.gather(0, cb[None])[0]
                tt = (level - va) / (vb - va)
                # corner offsets from the id bits, per axis z, y, x
                for a, bit in enumerate((2, 1, 0)):
                    oa = ((ca >> bit) & 1).float()
                    ob = ((cb >> bit) & 1).float()
                    planes_all[3 * vtx + a].append(
                        base[a] + oa + tt * (ob - oa))
            valid_all.append(has[kk][case])
    planes = torch.stack([torch.cat(row) for row in planes_all])
    return planes, torch.cat(valid_all)


def _device_compact(planes, valid):
    """The valid columns of ``planes``, in order: (9, n_tri)."""
    return planes[:, torch.nonzero(valid).squeeze(1)]


def mesh_geometry_device(label_vol, level: float = 0.5,
                         spacing=(1.0, 1.0, 1.0), step_size: int = 1,
                         presmooth: int | None = None, device="cuda"):
    """Marching tetrahedra + triangle geometry + normal orientation as
    one device pipeline; only the triangle count crosses to the host.

    Returns ``(geo, n_tri)`` where ``geo`` is a dict of (n_tri,) tensors on
    ``device``: centroid planes ``cz, cy, cx`` (voxel coords), oriented
    physical unit-normal planes ``nzp, nyp, nxp``, and physical
    ``areas``. Semantics match :func:`triangle_geometry` +
    :func:`orient_normals` (orientation probes the raw label volume
    trilinearly at ±0.5 voxel). ``label_vol`` is a numpy array or a
    tensor."""
    dev = resolve_device(device)
    raw, presmooth = _device_volume(label_vol, step_size, presmooth, dev)
    if min(raw.shape) < 2:
        return None, 0
    tris = _extract(raw, presmooth, level)
    if tris is None:
        return None, 0
    geo = _device_geometry_orient(tris, raw, spacing, float(step_size))
    return geo, tris.shape[1]


def _device_geometry_orient(tris, raw_vol, spacing_zyx, scale):
    """(9, N) vertex planes → centroids / oriented physical normals /
    areas. ``scale`` rescales step_size-coarsened voxel coordinates back
    to the full lattice."""
    v = [tris[i] for i in range(9)]                    # 9 × (N,) z,y,x ×3
    dz_, dy_, dx_ = (float(s) for s in spacing_zyx)
    # physical edge vectors (note planes are (z, y, x))
    e1z, e1y, e1x = ((v[3] - v[0]) * dz_, (v[4] - v[1]) * dy_,
                     (v[5] - v[2]) * dx_)
    e2z, e2y, e2x = ((v[6] - v[0]) * dz_, (v[7] - v[1]) * dy_,
                     (v[8] - v[2]) * dx_)
    # 0.5 · e1 × e2 in (z, y, x) component order, matching
    # triangle_geometry's np.cross on (z, y, x) triples
    crz = 0.5 * (e1y * e2x - e1x * e2y)
    cry = 0.5 * (e1x * e2z - e1z * e2x)
    crx = 0.5 * (e1z * e2y - e1y * e2z)
    area = torch.sqrt(crz * crz + cry * cry + crx * crx)
    inv = 1.0 / torch.clamp_min(area, 1e-20)
    nzp, nyp, nxp = crz * inv, cry * inv, crx * inv
    cz = (v[0] + v[3] + v[6]) / 3.0
    cy = (v[1] + v[4] + v[7]) / 3.0
    cx = (v[2] + v[5] + v[8]) / 3.0

    # orientation probe on the raw label volume (trilinear, ±0.5 voxel
    # along the voxel-space normal — orient_normals semantics)
    nvz = nzp / dz_
    nvy = nyp / dy_
    nvx = nxp / dx_
    nrm = 1.0 / torch.clamp_min(
        torch.sqrt(nvz * nvz + nvy * nvy + nvx * nvx), 1e-20)
    nvz, nvy, nvx = nvz * nrm, nvy * nrm, nvx * nrm
    ahead = map_coordinates(raw_vol, torch.stack(
        [cz + 0.5 * nvz, cy + 0.5 * nvy, cx + 0.5 * nvx]), order=1)
    behind = map_coordinates(raw_vol, torch.stack(
        [cz - 0.5 * nvz, cy - 0.5 * nvy, cx - 0.5 * nvx]), order=1)
    sgn = torch.where(ahead < behind, -1.0, 1.0)
    return {"cz": cz * scale, "cy": cy * scale, "cx": cx * scale,
            "nzp": nzp * sgn, "nyp": nyp * sgn, "nxp": nxp * sgn,
            "areas": area * (scale * scale)}


def triangle_geometry(tri_verts: np.ndarray, spacing=(1.0, 1.0, 1.0)):
    """Centroids, physical areas, and unit normals of (n, 3, 3) triangles.

    ``spacing`` is (dz, dy, dx); areas/normals are computed in physical
    space exactly as the reference does (`velocity_analysis.py:550-564`).
    Normals are unoriented here — see :func:`orient_normals`.
    """
    sp = np.asarray(spacing, np.float64)
    v0, v1, v2 = tri_verts[:, 0], tri_verts[:, 1], tri_verts[:, 2]
    e1 = (v1 - v0) * sp
    e2 = (v2 - v0) * sp
    n_scaled = 0.5 * np.cross(e1, e2)
    areas = np.linalg.norm(n_scaled, axis=1)
    normals = n_scaled / np.maximum(areas[:, None], 1e-20)
    centroids = tri_verts.mean(axis=1)
    return centroids, areas, normals


def orient_normals(normals: np.ndarray, centroids: np.ndarray,
                   volume: np.ndarray,
                   spacing=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Flip normals to point toward increasing ``volume`` (into the labeled
    phase) — skimage's marching-cubes convention, which the reference's
    drag math relies on. The field is sampled trilinearly at ±0.5 voxel
    along each normal; the normal keeps the direction of the larger value
    (robust on binary step volumes where voxel gradients vanish).

    ``normals`` are physical-space unit normals while ``centroids`` are in
    voxel-index coordinates, so the probe direction is converted with
    ``spacing`` (dz, dy, dx) — on anisotropic grids the raw physical vector
    points the wrong way in index space."""
    from scipy.ndimage import map_coordinates as _scipy_map

    vol = np.ascontiguousarray(volume, np.float64)
    sp = np.asarray(spacing, np.float64)
    n_vox = normals / sp
    n_vox = n_vox / np.maximum(
        np.linalg.norm(n_vox, axis=1, keepdims=True), 1e-20)
    ahead = _scipy_map(vol, (centroids + 0.5 * n_vox).T, order=1,
                       mode="nearest")
    behind = _scipy_map(vol, (centroids - 0.5 * n_vox).T, order=1,
                        mode="nearest")
    flip = ahead < behind
    out = normals.copy()
    out[flip] *= -1
    return out
