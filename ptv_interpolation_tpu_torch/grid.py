"""Regular-grid core types (numpy only).

Counterpart of ``ptv_interpolation_tpu/grid.py`` (``Grid``, ``create_grid``,
``_axis_coords``). The conventions are load-bearing and kept unchanged:

* Fields are stored ``(nz, ny, nx)``.
* Grid axes are ``linspace(lo, hi - 1, n)``: voxel 0 sits at ``lo`` and
  voxel ``n-1`` at ``hi - 1``; a single-voxel axis collapses to ``[lo]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np

Bounds = Tuple[Tuple[float, float], Tuple[float, float], Tuple[float, float]]
Resolution = Union[int, Tuple[int, int, int]]


def _axis_coords(lo: float, hi: float, n: int) -> np.ndarray:
    """``linspace(lo, hi - 1, n)``; degenerate single-voxel axes collapse
    to ``[lo]``."""
    if n <= 1:
        return np.asarray([lo], dtype=np.float64)
    return np.linspace(lo, hi - 1.0, n)


@dataclasses.dataclass(frozen=True)
class Grid:
    """An immutable regular 3D grid: ``bounds`` is ((xmin, xmax), (ymin,
    ymax), (zmin, zmax)) in the inclusive-exclusive convention, ``shape``
    the (nz, ny, nx) field shape."""

    bounds: Bounds
    shape: Tuple[int, int, int]  # (nz, ny, nx)

    @property
    def nx(self) -> int:
        return self.shape[2]

    @property
    def ny(self) -> int:
        return self.shape[1]

    @property
    def nz(self) -> int:
        return self.shape[0]

    @property
    def x(self) -> np.ndarray:
        (xmin, xmax), _, _ = self.bounds
        return _axis_coords(xmin, xmax, self.nx)

    @property
    def y(self) -> np.ndarray:
        _, (ymin, ymax), _ = self.bounds
        return _axis_coords(ymin, ymax, self.ny)

    @property
    def z(self) -> np.ndarray:
        _, _, (zmin, zmax) = self.bounds
        return _axis_coords(zmin, zmax, self.nz)

    @property
    def spacing(self) -> Tuple[float, float, float]:
        """(dx, dy, dz); degenerate axes report spacing 1.0."""
        x, y, z = self.x, self.y, self.z
        dx = float(x[1] - x[0]) if len(x) > 1 else 1.0
        dy = float(y[1] - y[0]) if len(y) > 1 else 1.0
        dz = float(z[1] - z[0]) if len(z) > 1 else 1.0
        return dx, dy, dz

    @property
    def n_points(self) -> int:
        return self.nx * self.ny * self.nz


def create_grid(bounds: Bounds, resolution: Resolution) -> Grid:
    """Build a :class:`Grid` from bounds and ``resolution`` — ``(nx, ny,
    nz)`` or an isotropic int."""
    if isinstance(resolution, (int, np.integer)):
        nx = ny = nz = int(resolution)
    else:
        nx, ny, nz = (int(r) for r in resolution)
    b = tuple((float(lo), float(hi)) for (lo, hi) in bounds)
    return Grid(bounds=b, shape=(nz, ny, nx))
