"""Synthetic sphere-pack PTV dataset.

Counterpart of ``ptv_interpolation_tpu/datasets/sphere_pack.py``, carried over
as host numpy.

Re-implementation of the reference fixture generator
(``generate_sphere_pack.py``): six unit-diameter spheres
in two stacked triangles, uniformly seeded tracer points with constant
``w = 1`` outside the solid, plus a ``size**3`` boolean mask volume.

Returns arrays (and optionally writes CSV/TIFF) instead of only files, so the
benchmark and tests can stay in memory.
"""

from __future__ import annotations

import numpy as np

from ptv_interpolation_tpu_torch.io.csvio import PointCloud


def sphere_pack_centers(R: float = 0.5):
    D = 2 * R
    cx1, cy1 = 0.0, 0.0
    cx2, cy2 = D, 0.0
    cx3, cy3 = D / 2.0, np.sqrt(3) * D / 2.0
    return [
        (cx1, cy1, 0.0), (cx2, cy2, 0.0), (cx3, cy3, 0.0),
        (cx1, cy1, D), (cx2, cy2, D), (cx3, cy3, D),
    ]


def generate(n_points: int = 8000, size: int = 64, seed: int = 0,
             filename: str | None = None, maskname: str | None = None,
             voxel_units: bool = False):
    """Generate the sphere-pack dataset.

    Returns
    -------
    cloud : PointCloud — tracer vectors outside the solid.
    mask_grid : (size, size, size) bool — True inside a sphere (solid), matching
        the reference's TIFF content (solid voxels nonzero,
        `generate_sphere_pack.py:109-114`). Note ``load_mask`` flips this to
        fluid=True via ``--invert-mask`` semantics downstream.
    bounds : ((xmin, xmax), (ymin, ymax), (zmin, zmax)) of the point domain.

    ``voxel_units=True`` rescales the tracer coordinates into the mask's
    voxel-index space (like real PTV data, which is tracked in scan voxel
    coordinates), so the CSV + TIFF pair feeds the pipeline directly.
    """
    rng = np.random.default_rng(seed)
    R = 0.5
    centers = sphere_pack_centers(R)

    xmin = min(c[0] for c in centers) - R - 0.2
    xmax = max(c[0] for c in centers) + R + 0.2
    ymin = min(c[1] for c in centers) - R - 0.2
    ymax = max(c[1] for c in centers) + R + 0.2
    zmin = min(c[2] for c in centers) - R - 0.2
    zmax = max(c[2] for c in centers) + R + 0.2

    x = rng.uniform(xmin, xmax, n_points)
    y = rng.uniform(ymin, ymax, n_points)
    z = rng.uniform(zmin, zmax, n_points)

    inside = np.zeros(n_points, dtype=bool)
    for (cx, cy, cz) in centers:
        inside |= (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 < R ** 2

    u = np.zeros_like(x)
    v = np.zeros_like(x)
    w = np.ones_like(x)
    keep = ~inside
    xk, yk, zk = x[keep], y[keep], z[keep]
    if voxel_units:
        # mask voxel i sits at lo + i*(hi-lo)/(size-1) (np.linspace below)
        xk = (xk - xmin) / (xmax - xmin) * (size - 1)
        yk = (yk - ymin) / (ymax - ymin) * (size - 1)
        zk = (zk - zmin) / (zmax - zmin) * (size - 1)
    cloud = PointCloud.from_arrays(xk, yk, zk, u[keep], v[keep], w[keep])

    gx = np.linspace(xmin, xmax, size)
    gy = np.linspace(ymin, ymax, size)
    gz = np.linspace(zmin, zmax, size)
    MX, MY, MZ = np.meshgrid(gx, gy, gz, indexing="ij")
    mask_grid = np.zeros(MX.shape, dtype=bool)
    for (cx, cy, cz) in centers:
        mask_grid |= (MX - cx) ** 2 + (MY - cy) ** 2 + (MZ - cz) ** 2 < R ** 2
    if voxel_units:
        # the reference generator writes the mask in (x, y, z) index order
        # (`generate_sphere_pack.py:107-114`) although the pipeline reads
        # TIFFs as (z, y, x) — a documented quirk. In voxel-units mode emit
        # the pipeline-consistent orientation so the CSV+TIFF pair aligns.
        mask_grid = mask_grid.transpose(2, 1, 0)

    if filename is not None:
        from ptv_interpolation_tpu_torch.io.csvio import save_ptv_data
        save_ptv_data(filename, cloud)
    if maskname is not None:
        from ptv_interpolation_tpu_torch.io.tiff import write_tiff
        write_tiff(maskname, mask_grid.astype(np.uint8))

    bounds = ((xmin, xmax), (ymin, ymax), (zmin, zmax))
    return cloud, mask_grid, bounds


if __name__ == "__main__":
    generate(filename="spheres_ptv.csv", maskname="spheres_mask.tif")
