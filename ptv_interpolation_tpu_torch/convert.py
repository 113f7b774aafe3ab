"""State carried across from the JAX package.

The system holds no weights; its state is the CSR cell list (and the
values sorted by it), and a fitted global RBF model.
:func:`cells_from_numpy` turns a JAX ``CellList``'s arrays, pulled to the
host, into the port's :class:`CellList`, so that both packages can run
their later stages on one and the same cell list;
:func:`global_rbf_from_numpy` does the same for a JAX ``GlobalRBF``, so
that both evaluate one fitted model.
"""

from __future__ import annotations

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.interpolate.rbf_global import GlobalRBF
from ptv_interpolation_tpu_torch.ops.neighbors import CellList


def cells_from_numpy(starts, order, points_sorted, origin, inv_cell, dims,
                     cap: int, n_pts: int, inv_host: float | None = None,
                     device="cuda") -> CellList:
    """The port's cell list from host arrays: ``starts`` (n_cells+1,),
    ``order`` (n,), ``points_sorted`` (n+pad, 3), ``origin`` (3,),
    ``inv_cell`` (3,), ``dims`` (ncx, ncy, ncz). ``inv_host`` is the
    unrounded 1/cell_size where the source kept it (the JAX package's
    ``CellList.inv_host``); default ``inv_cell[0]``."""
    dev = resolve_device(device)
    origin = np.array(origin, np.float32)
    inv_cell = np.array(inv_cell, np.float32)
    return CellList(
        starts=torch.as_tensor(np.array(starts, np.int32), device=dev),
        order=torch.as_tensor(np.array(order, np.int32), device=dev),
        points_sorted=torch.as_tensor(np.array(points_sorted, np.float32),
                                      device=dev),
        origin=torch.as_tensor(origin, device=dev),
        inv_cell=torch.as_tensor(inv_cell, device=dev),
        dims=tuple(int(d) for d in dims),
        cap=int(cap),
        n_pts=int(n_pts),
        origin_host=origin,
        inv_host=float(inv_cell[0]) if inv_host is None else float(inv_host),
    )


def global_rbf_from_numpy(points_scaled, coeffs, poly_coeffs, shift, scale,
                          kernel: str, epsilon: float, degree: int,
                          device="cuda") -> GlobalRBF:
    """The port's :class:`GlobalRBF` from a fitted model's host arrays:
    ``points_scaled`` (N, 3), ``coeffs`` (N, C), ``poly_coeffs`` (m, C),
    ``shift`` (3,), ``scale`` (a scalar), and its kernel, epsilon and
    polynomial degree."""
    dev = resolve_device(device)
    return GlobalRBF(
        points_scaled=as_f32(np.array(points_scaled, np.float32), dev),
        coeffs=as_f32(np.array(coeffs, np.float32), dev),
        poly_coeffs=as_f32(np.array(poly_coeffs, np.float32), dev),
        shift=as_f32(np.array(shift, np.float32), dev),
        scale=as_f32(np.array(scale, np.float32), dev).reshape(()),
        kernel=kernel, epsilon=float(epsilon), degree=int(degree))
