"""Regular-grid core types, mask resampling and 6-connected morphology.

Counterpart of ``ptv_interpolation_tpu/grid.py`` (``Grid``, ``create_grid``,
``grid_from_mask_shape``, ``_axis_coords``, ``sample_mask_on_grid``,
``binary_dilation6``, ``binary_erosion6``, ``extract_boundary_particles``). The conventions are
load-bearing and kept unchanged:

* Fields are stored ``(nz, ny, nx)``.
* Grid axes are ``linspace(lo, hi - 1, n)``: voxel 0 sits at ``lo`` and
  voxel ``n-1`` at ``hi - 1``; a single-voxel axis collapses to ``[lo]``.

The mask resample is host numpy (a byte shuffle whose data starts and ends
on the host); the morphology runs on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import resolve_device

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

    def flat_coords(self, device="cuda") -> torch.Tensor:
        """All grid points as an (n_points, 3) f32 tensor of (x, y, z)
        rows on ``device``, in the C order of the (nz, ny, nx) layout."""
        dev = resolve_device(device)
        z, y, x = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                   for a in (self.z, self.y, self.x))
        Z, Y, X = torch.meshgrid(z, y, x, indexing="ij")
        return torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)],
                           dim=-1)


def create_grid(bounds: Bounds, resolution: Resolution) -> Grid:
    """Build a :class:`Grid` from bounds and ``resolution`` — ``(nx, ny,
    nz)`` or an isotropic int."""
    if isinstance(resolution, (int, np.integer)):
        nx = ny = nz = int(resolution)
    else:
        nx, ny, nz = (int(r) for r in resolution)
    b = tuple((float(lo), float(hi)) for (lo, hi) in bounds)
    return Grid(bounds=b, shape=(nz, ny, nx))


def grid_from_mask_shape(mask_shape: Tuple[int, int, int],
                         bounds: Bounds | None = None,
                         downscale: float = 1.0) -> Grid:
    """Grid covering a raw-mask volume, optionally downscaled
    (reference ``main.py:104-119``)."""
    nz, ny, nx = mask_shape
    if bounds is None:
        bounds = ((0.0, float(nx)), (0.0, float(ny)), (0.0, float(nz)))
    resolution = (
        max(1, int(round(nx / downscale))),
        max(1, int(round(ny / downscale))),
        max(1, int(round(nz / downscale))),
    )
    return create_grid(bounds, resolution)


# --------------------------------------------------------------------------
# Mask resampling
# --------------------------------------------------------------------------

def sample_mask_on_grid(mask_raw, grid: Grid, bounds_raw: Bounds | None = None):
    """Nearest-neighbour resample of a raw boolean mask (True = fluid)
    onto ``grid``; host numpy, the JAX package's code unchanged.

    The target grid coordinates map to fractional raw-voxel indices and
    round half to even (``RegularGridInterpolator`` 'nearest'); samples
    outside the raw bounds become solid. Nearest lookup on a product grid
    is separable, so the resample is three per-axis index vectors and one
    outer-product fancy index. ``bounds_raw`` defaults to ``grid.bounds``.
    """
    mask_raw = np.asarray(mask_raw).astype(bool)
    if bounds_raw is None:
        bounds_raw = grid.bounds
    bounds_arr = np.asarray(bounds_raw, np.float32)         # (3, 2) x/y/z
    grid_bounds_arr = np.asarray(grid.bounds, np.float32)
    nz, ny, nx = mask_raw.shape
    onz, ony, onx = grid.shape

    def axis_coords(lo, hi, n):
        if n <= 1:
            return np.full((1,), lo, np.float32)
        return lo + (hi - 1.0 - lo) * np.arange(n, dtype=np.float32) / (n - 1)

    def frac_index(coords, lo, hi, n):
        # Raw voxel i sits at lo + i * step with step = (hi-1-lo)/(n-1).
        if n <= 1:
            return np.zeros_like(coords)
        step = (hi - 1.0 - lo) / (n - 1)
        return (coords - lo) / step

    idx, ok = [], []
    for d, (n_raw, n_out) in enumerate(((nz, onz), (ny, ony), (nx, onx))):
        b = 2 - d                                    # bounds rows are x,y,z
        c = axis_coords(grid_bounds_arr[b, 0], grid_bounds_arr[b, 1], n_out)
        f = frac_index(c, bounds_arr[b, 0], bounds_arr[b, 1], n_raw)
        idx.append(np.clip(np.round(f).astype(np.int64), 0, n_raw - 1))
        ok.append((f >= 0.0) & (f <= n_raw - 1.0))

    sampled = mask_raw[np.ix_(*idx)]
    in_bounds = (ok[0][:, None, None] & ok[1][None, :, None]
                 & ok[2][None, None, :])
    return sampled & in_bounds


# --------------------------------------------------------------------------
# Morphology (used by boundary particles)
# --------------------------------------------------------------------------

def _shift6(mask, iterations: int, dilate: bool, device) -> torch.Tensor:
    """``iterations`` rounds of 6-connected shift-and-or (dilation) or
    shift-and-and (erosion); voxels outside the volume are False, so
    nothing wraps around. Each round combines shifts of its own input."""
    m = torch.as_tensor(mask, dtype=torch.bool, device=resolve_device(device))
    for _ in range(int(iterations)):
        out = m.clone()
        for axis in range(3):
            n = m.shape[axis]
            shape = list(m.shape)
            shape[axis] = n + 2
            padded = m.new_zeros(shape)
            padded.narrow(axis, 1, n).copy_(m)
            for start in (0, 2):
                side = padded.narrow(axis, start, n)
                out = (out | side) if dilate else (out & side)
        m = out
    return m


def binary_dilation6(mask, iterations: int = 1, device="cuda") -> torch.Tensor:
    """Binary dilation with 6-connectivity (face neighbours), no
    wraparound: ``scipy.ndimage.binary_dilation`` with
    ``generate_binary_structure(3, 1)``. Returns a bool tensor on
    ``device``."""
    return _shift6(mask, iterations, True, device)


def binary_erosion6(mask, iterations: int = 1, device="cuda") -> torch.Tensor:
    """Binary erosion with 6-connectivity; out-of-volume voxels count as
    False (scipy's default ``border_value=0``). Returns a bool tensor on
    ``device``."""
    return _shift6(mask, iterations, False, device)


def extract_boundary_particles(fluid_mask, bounds: Bounds,
                               sampling_step: int = 1, thickness: int = 1,
                               device="cuda"):
    """Zero-velocity virtual particles at the fluid-solid interface.

    Dilate the fluid into the solid by ``thickness`` 6-connected layers
    on ``device``; interface voxels = dilated fluid ∩ solid, listed in C
    order (``nonzero``, the order of ``np.where``) and pulled to the host;
    keep every ``sampling_step``-th; map voxel indices to physical
    coordinates with ``x = xmin + i·(xmax - 1 - xmin)/(nx - 1)``.

    Returns ``(x_phys, y_phys, z_phys)`` numpy arrays."""
    if fluid_mask is None:
        return np.array([]), np.array([]), np.array([])
    dev = resolve_device(device)
    fluid = torch.as_tensor(fluid_mask, dtype=torch.bool, device=dev)
    nz, ny, nx = fluid.shape
    (xmin, xmax), (ymin, ymax), (zmin, zmax) = bounds

    dilated = binary_dilation6(fluid, iterations=thickness, device=dev)
    idx = torch.nonzero(dilated & ~fluid).cpu().numpy()
    if len(idx) == 0:
        return np.array([]), np.array([]), np.array([])
    if sampling_step > 1:
        idx = idx[::sampling_step]
    Z_idx, Y_idx, X_idx = idx[:, 0], idx[:, 1], idx[:, 2]

    z_phys = zmin + Z_idx * (zmax - 1 - zmin) / (nz - 1) if nz > 1 else np.full(len(Z_idx), zmin, float)
    y_phys = ymin + Y_idx * (ymax - 1 - ymin) / (ny - 1) if ny > 1 else np.full(len(Y_idx), ymin, float)
    x_phys = xmin + X_idx * (xmax - 1 - xmin) / (nx - 1) if nx > 1 else np.full(len(X_idx), xmin, float)
    return x_phys, y_phys, z_phys
