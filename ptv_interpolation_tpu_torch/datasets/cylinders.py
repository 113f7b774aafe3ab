"""Synthetic cylinder-array potential-flow dataset.

Counterpart of ``ptv_interpolation_tpu/datasets/cylinders.py``, carried over
as host numpy.

Re-implementation of the reference's ``generate_cylinders.py``: potential
flow past two cylinders (uniform stream + superposed doublet perturbations),
quasi-2D slab seeding, and a ``(size, size//2, 16)``-XYZ mask volume.
The analytical field makes this the fixture for interpolation-accuracy tests.
"""

from __future__ import annotations

import numpy as np

from ptv_interpolation_tpu_torch.io.csvio import PointCloud


def flow_past_cylinder(x, y, U0, R, xc, yc):
    """Potential flow past a cylinder at (xc, yc):
    u = U0 (1 - R²/r² cos 2θ), v = -U0 R²/r² sin 2θ
    (reference `generate_cylinders.py:6-51`)."""
    X = x - xc
    Y = y - yc
    r2 = X ** 2 + Y ** 2
    theta = np.arctan2(Y, X)
    u = U0 * (1 - (R ** 2 / r2) * np.cos(2 * theta))
    v = -U0 * (R ** 2 / r2) * np.sin(2 * theta)
    return u, v


def analytic_velocity(x, y, U0=1.0, R=0.25, c1=(0.0, 0.0), c2=(3.0, 0.0)):
    """Superposed two-cylinder field used for both tracers and truth grids."""
    u1, v1 = flow_past_cylinder(x, y, U0, R, c1[0], c1[1])
    u2, v2 = flow_past_cylinder(x, y, U0, R, c2[0], c2[1])
    u = U0 + (u1 - U0) + (u2 - U0)
    v = v1 + v2
    return u, v


def generate(n_points: int = 5000, size: int = 64, seed: int = 0,
             filename: str | None = None, maskname: str | None = None):
    """Generate the cylinder dataset.

    Returns (cloud, mask_grid, bounds); mask_grid is solid=True with XYZ axis
    order (nx, ny, nz) exactly as the reference writes it
    (`generate_cylinders.py:107-126` — note the reference's mask here is in
    (x, y, z) index order, another of its documented quirks).
    """
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 6, n_points)
    y = rng.uniform(-2, 2, n_points)
    z = rng.uniform(0, 1, n_points)

    R = 0.25
    c1, c2 = (0.0, 0.0), (3.0, 0.0)
    U0 = 1.0
    u, v = analytic_velocity(x, y, U0, R, c1, c2)
    w = np.zeros_like(u)

    dist1 = np.sqrt((x - c1[0]) ** 2 + (y - c1[1]) ** 2)
    dist2 = np.sqrt((x - c2[0]) ** 2 + (y - c2[1]) ** 2)
    inside = (dist1 < R) | (dist2 < R)
    u[inside] = 0
    v[inside] = 0
    keep = ~inside
    cloud = PointCloud.from_arrays(x[keep], y[keep], z[keep], u[keep], v[keep], w[keep])

    nx, ny, nz = size, size // 2, 16
    grid_x = np.linspace(-2, 6, nx)
    grid_y = np.linspace(-2, 2, ny)
    grid_z = np.linspace(0, 1, nz)
    X, Y, Z = np.meshgrid(grid_x, grid_y, grid_z, indexing="ij")
    D1 = np.sqrt((X - c1[0]) ** 2 + (Y - c1[1]) ** 2)
    D2 = np.sqrt((X - c2[0]) ** 2 + (Y - c2[1]) ** 2)
    mask_grid = (D1 < R) | (D2 < R)

    if filename is not None:
        from ptv_interpolation_tpu_torch.io.csvio import save_ptv_data
        save_ptv_data(filename, cloud)
    if maskname is not None:
        from ptv_interpolation_tpu_torch.io.tiff import write_tiff
        write_tiff(maskname, mask_grid.astype(np.uint8))

    bounds = ((-2.0, 6.0), (-2.0, 2.0), (0.0, 1.0))
    return cloud, mask_grid, bounds


if __name__ == "__main__":
    generate(filename="cylinders_ptv.csv", maskname="cylinders_mask.tif")
