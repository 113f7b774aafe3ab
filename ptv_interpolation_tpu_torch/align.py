"""Point-cloud ↔ mask alignment.

Counterpart of ``ptv_interpolation_tpu/align.py`` (the reference's
`auto_align.py:10-62`), kept as the port's own copy: the objective is the
sum of distance-transform values (distance to the nearest fluid voxel) at
the shifted point locations plus an out-of-bounds penalty, minimized over
an (dx, dy, dz) offset with Powell's method.

The EDT and the Powell iteration are host-side (scipy): both are
output-sized preprocessing over a few thousand sampled points, with no
work worth a device.
"""

from __future__ import annotations

import numpy as np


def find_best_offset(cloud, fluid_mask, initial_offset=(0, 0, 0),
                     invert=False, verbose=True):
    """Find the (dx, dy, dz) offset minimizing points-in-solid; returns
    Powell's ``(res.x, res.fun)``.

    Parameters
    ----------
    cloud : PointCloud (or anything with ``.points`` (N, 3)).
    fluid_mask : bool volume, True = fluid (set ``invert=True`` when passing
        a solid mask, mirroring the reference flag).
    """
    from scipy import ndimage
    from scipy.optimize import minimize

    mask = np.asarray(fluid_mask, bool)
    solid_mask = mask if invert else ~mask
    if verbose:
        print("Computing Distance Transform...")
    dt = ndimage.distance_transform_edt(solid_mask)
    dt_max = dt.max()

    nz, ny, nx = mask.shape
    points = np.asarray(cloud.points if hasattr(cloud, "points") else cloud,
                        np.float64)

    def objective(offset):
        shifted = points + np.asarray(offset)
        ix = np.round(shifted[:, 0]).astype(int)
        iy = np.round(shifted[:, 1]).astype(int)
        iz = np.round(shifted[:, 2]).astype(int)
        valid = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
                 & (iz >= 0) & (iz < nz))
        if not valid.any():
            return 1e9
        distances = dt[iz[valid], iy[valid], ix[valid]]
        penalty = (~valid).sum() * dt_max
        return distances.sum() + penalty

    if verbose:
        print(f"Starting optimization from initial offset {tuple(initial_offset)}...")
    res = minimize(objective, np.asarray(initial_offset, float),
                   method="Powell", tol=1e-1)
    return res.x, res.fun
