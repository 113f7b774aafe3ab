"""Interpolation dispatcher — the ``interpolate_field`` entry point.

Counterpart of ``ptv_interpolation_tpu/interpolate/dispatch.py`` for the
two kNN-weighted methods ported so far:

  idw      — inverse-distance weighting
  sibson   — the reference's smoothed-IDW variant

Grid targets of large problems go to the block-centric grid kernel
(``ops/grid_knn.py``); the rest go to exact brute-force kNN. Where the JAX
package would build a cell list for the generic path, the port uses brute
force, which is exact and memory-bounded (the cell-list search,
``celllist_tile_fn``, is not ported yet). The other methods (linear,
nearest, rbf, cubic) raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.grid import Grid
from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
    idw_grid_interpolate, idw_interpolate, sibson_grid_interpolate,
    sibson_interpolate)

_PORTED_METHODS = ("idw", "sibson")

# Q·N at and above which the grid kernel serves a grid target (with at
# least _GRID_FASTPATH_MIN_POINTS points). The JAX package measured this
# crossover on its own device; it has not been measured on a GPU.
_GRID_FASTPATH_MIN_WORK = 2 ** 29
_GRID_FASTPATH_MIN_POINTS = 4096


def _check_method(method: str) -> None:
    if method not in _PORTED_METHODS:
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ported: idw, sibson); "
            f"the other interpolation methods are ROADMAP Queue 1 item 9")


def interpolate_values(points, values, queries, method: str = "linear",
                       idw_power: float = 2.0, idw_neighbors: int = 50,
                       sibson_neighbors: int = 30, verbose: bool = False,
                       device="cuda") -> torch.Tensor:
    """Interpolate scattered ``values`` (N, C) onto ``queries`` (Q, 3) by
    exact brute-force kNN on ``device``; returns (Q, C). The default
    method is the JAX package's, 'linear', which is not ported yet."""
    _check_method(method)
    n_pts = int(points.shape[0])
    if method == "sibson":
        if verbose:
            print(f"Using Sibson (Natural Neighbor) Interpolation (neighbors={sibson_neighbors})...")
        return sibson_interpolate(points, values, queries,
                                  k=min(sibson_neighbors, n_pts),
                                  device=device)
    if verbose:
        print(f"Using IDW Interpolation (power={idw_power}, neighbors={idw_neighbors})...")
    return idw_interpolate(points, values, queries,
                           k=min(idw_neighbors, n_pts), power=idw_power,
                           device=device)


def interpolate_field(points, values, grid: Grid, method: str = "linear",
                      use_grid_kernel: str = "auto", skip_mask=None,
                      tau_mode: str = "bisect", device="cuda", **kwargs):
    """Interpolate onto a :class:`Grid` on ``device``; returns ``(U, V,
    W)`` tensors of shape ``grid.shape``.

    ``use_grid_kernel``: 'auto' (the grid kernel when Q·N ≥ 2²⁹ and
    N ≥ 4096), 'always', or 'never'. ``skip_mask`` ((nz, ny, nx) bool,
    True = value will be discarded) lets the grid kernel skip the repair
    of nodes the caller overwrites anyway. ``kwargs``: ``idw_power``,
    ``idw_neighbors``, ``sibson_neighbors``, ``verbose``."""
    _check_method(method)
    dev = resolve_device(device)
    n_pts = int(points.shape[0])
    work = n_pts * grid.n_points
    use_fast = (use_grid_kernel == "always"
                or (use_grid_kernel == "auto"
                    and work >= _GRID_FASTPATH_MIN_WORK
                    and n_pts >= _GRID_FASTPATH_MIN_POINTS))
    if use_fast:
        if method == "idw":
            out = idw_grid_interpolate(
                points, values, grid,
                k=min(kwargs.get("idw_neighbors", 50), n_pts),
                power=kwargs.get("idw_power", 2.0), skip_mask=skip_mask,
                tau_mode=tau_mode, device=dev)
        else:
            out = sibson_grid_interpolate(
                points, values, grid,
                k=min(kwargs.get("sibson_neighbors", 30), n_pts),
                skip_mask=skip_mask, tau_mode=tau_mode, device=dev)
        return out[..., 0], out[..., 1], out[..., 2]

    out = interpolate_values(points, values, grid.flat_coords(dev),
                             method=method, device=dev, **kwargs)
    out = out.reshape(grid.shape + (out.shape[-1],))
    return out[..., 0], out[..., 1], out[..., 2]
