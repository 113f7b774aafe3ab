"""The plain reference of the porous-media pipeline: the upstream's
``main.py`` steps for the flags the benchmark's configurations use, in
plain PyTorch and NumPy, at the dtype it is given.

Steps, in the upstream's order: clip the tracks to the mask's bounds
(``lo <= c < hi``), drop tracks faster than ``filter_max_speed``, drop
tracks whose speed lies more than ``filter_threshold`` MADs from the median
speed of their ``filter_neighbors`` nearest tracks, resample the mask onto
the grid (nearest, half to even), add zero-velocity particles on every
``boundary_sampling``-th solid voxel within ``boundary_thickness`` face
steps of the fluid, sibson-interpolate at the fluid nodes, zero the solid,
and, where asked, solve the variational cleaning ``(I + λ D̃ᵀD̃) U = U0``
on the fluid. It works everything out from the raw inputs and imports
nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.cleaning import clean_variational
from perfbench.reference.knn import knn
from perfbench.reference.sibson import sibson

MAD_EPS = 1e-6


def resolution(raw_shape, downscale):
    """Grid nodes per axis (x, y, z) of a raw (z, y, x) mask: the raw
    extent over ``downscale``, rounded half to even."""
    nz, ny, nx = raw_shape
    return tuple(max(1, int(round(n / downscale))) for n in (nx, ny, nz))


def axis(lo, hi, n):
    """Node coordinates ``lo, …, hi - 1`` of one grid axis, float64."""
    if n <= 1:
        return np.asarray([float(lo)])
    return np.linspace(float(lo), float(hi) - 1.0, n)


def nearest_index(n_raw, n_out):
    """The raw voxel nearest each of ``n_out`` nodes spread over the same
    extent: ``i·(n_raw−1)/(n_out−1)`` rounded half to even, in exact
    integer arithmetic."""
    if n_out <= 1:
        return np.zeros(1, np.int64)
    num = np.arange(n_out, dtype=np.int64) * (n_raw - 1)
    den = n_out - 1
    q, r = np.divmod(num, den)
    up = (2 * r > den) | ((2 * r == den) & (q % 2 == 1))
    return q + up


def mask_on_grid(fluid_raw, res):
    """The (nz, ny, nx) fluid mask of the grid, nearest raw voxel."""
    nz, ny, nx = fluid_raw.shape
    gx, gy, gz = res
    return fluid_raw[np.ix_(nearest_index(nz, gz), nearest_index(ny, gy),
                            nearest_index(nx, gx))]


def boundary_voxels(fluid_raw, thickness, stride, device):
    """Indices (M, 3) z, y, x of every ``stride``-th solid voxel, in C
    order, that lies within ``thickness`` face steps of the fluid; outside
    the volume counts as solid."""
    f = torch.as_tensor(np.ascontiguousarray(fluid_raw), device=device)
    grown = f.clone()
    for _ in range(int(thickness)):
        prev = grown
        grown = prev.clone()
        for dim in range(3):
            n = prev.shape[dim]
            grown.narrow(dim, 1, n - 1).logical_or_(prev.narrow(dim, 0, n - 1))
            grown.narrow(dim, 0, n - 1).logical_or_(prev.narrow(dim, 1, n - 1))
    idx = torch.nonzero(grown & ~f)
    return idx[::max(1, int(stride))]


def mad_keep(points, speed, k, threshold, cell):
    """Keep flags of the kNN median/MAD test: the k nearest other tracks'
    speeds (the nearest, the track itself, dropped), their median (the
    mean of the two middle ones at an even count) and the median of the
    absolute deviations from it."""
    _, idx, _ = knn(points, points, k + 1, cell)
    neigh = speed[idx[:, 1:]]
    med = _median(neigh)
    mad = _median((neigh - med[:, None]).abs())
    return (speed - med).abs() / (mad + MAD_EPS) <= threshold


def _median(x):
    s = torch.sort(x, dim=1).values
    n = x.shape[1]
    return (s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5


def knn_cell(n_points, extent, k):
    """A cell side that holds about k points at the cloud's mean density."""
    volume = float(np.prod(np.maximum(np.asarray(extent, float), 1e-9)))
    return (k * volume / max(n_points, 1)) ** (1.0 / 3.0)


def run(flags, points, values, fluid_raw, dtype, device, clean):
    """The pipeline on one dataset. ``flags``: the configuration's
    pipeline flags; ``points``/``values`` (N, 3) host arrays; ``fluid_raw``
    the (z, y, x) raw mask, True = fluid. Returns a dict with ``mask``
    (host bool grid), ``field`` (3, nz, ny, nx) tensor before cleaning,
    ``cleaned`` (or None), ``spacing``, ``n_kept``, ``n_boundary``."""
    if flags["method"] != "sibson":
        raise ValueError("the reference serves method='sibson' only")
    nz, ny, nx = fluid_raw.shape
    bounds = ((0.0, float(nx)), (0.0, float(ny)), (0.0, float(nz)))
    p = torch.as_tensor(np.asarray(points, np.float64), device=device)
    v = torch.as_tensor(np.asarray(values, np.float64), device=device)
    inside = torch.ones(len(p), dtype=torch.bool, device=device)
    for a, (lo, hi) in enumerate(bounds):
        inside &= (p[:, a] >= lo) & (p[:, a] < hi)
    p, v = p[inside].to(dtype), v[inside].to(dtype)

    if flags.get("filter_outliers"):
        speed = (v * v).sum(dim=1).sqrt()
        keep = speed <= flags["filter_max_speed"]
        p, v, speed = p[keep], v[keep], speed[keep]
        k = int(flags["filter_neighbors"])
        if len(p) > k:
            cell = knn_cell(len(p), (nx, ny, nz), k + 1)
            keep = mad_keep(p, speed, k, float(flags["filter_threshold"]),
                            cell)
            p, v = p[keep], v[keep]
    n_kept = len(p)

    res = resolution(fluid_raw.shape, float(flags["downscale"]))
    xs, ys, zs = (axis(lo, hi, n) for (lo, hi), n in zip(bounds, res))
    mask = mask_on_grid(fluid_raw, res)
    spacing = tuple(float(a[1] - a[0]) if len(a) > 1 else 1.0
                    for a in (xs, ys, zs))

    n_boundary = 0
    if flags.get("boundary_particles"):
        b = boundary_voxels(fluid_raw, flags["boundary_thickness"],
                            flags["boundary_sampling"], device)
        n_boundary = len(b)
        if n_boundary:
            scale = torch.tensor(
                [(hi - 1 - lo) / (n - 1) if n > 1 else 0.0
                 for (lo, hi), n in zip(bounds, (nx, ny, nz))],
                dtype=torch.float64, device=device)
            los = torch.tensor([lo for lo, _ in bounds], dtype=torch.float64,
                               device=device)
            bp = los + b.flip(1).double() * scale            # x, y, z
            p = torch.cat([p, bp.to(dtype)])
            v = torch.cat([v, torch.zeros_like(bp, dtype=dtype)])

    mask_t = torch.as_tensor(mask, device=device)
    iz, iy, ix = torch.nonzero(mask_t, as_tuple=True)
    axes = [torch.as_tensor(a, device=device) for a in (xs, ys, zs)]
    nodes = torch.stack([axes[0][ix], axes[1][iy], axes[2][iz]], dim=1)
    k = min(int(flags["sibson_neighbors"]), len(p))
    cell = knn_cell(len(p), (nx, ny, nz), k)
    vals = sibson(p, v, nodes.to(dtype), k, cell)
    field = torch.zeros((3,) + mask.shape, dtype=dtype, device=device)
    for c in range(3):
        field[c][mask_t] = vals[:, c]

    cleaned = None
    if clean:
        if flags.get("cleaning_method") != "variational":
            raise ValueError("the reference serves variational cleaning only")
        cleaned = clean_variational(field, mask_t, spacing,
                                    float(flags["cleaning_lambda"]))
    return {"mask": mask, "field": field, "cleaned": cleaned,
            "spacing": spacing, "n_kept": n_kept, "n_boundary": n_boundary}
