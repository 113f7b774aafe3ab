"""Interpolation dispatcher — the ``interpolate_field`` entry point.

Counterpart of ``ptv_interpolation_tpu/interpolate/dispatch.py``. One call
serves the six methods of the reference dispatcher:

  linear   — Delaunay barycentric (host Qhull topology, device or host
             blend)
  nearest  — kNN k=1 on the device
  cubic    — unsupported in 3D (scipy's griddata 'cubic' is 2D-only).
             Raises with guidance, or serves local RBF kernel='cubic' under
             cubic_fallback=True.
  rbf      — local kNN RBF (batched small solves); ``rbf_neighbors=None``
             escalates to the global solve
  idw      — inverse-distance weighting
  sibson   — the reference's smoothed-IDW variant

Large kNN problems on a grid go to the block-centric grid kernels
(``ops/grid_knn.py``); the generic scattered paths use exact brute force,
or the cell-list search when Q·N > 2³¹ (a prebuilt ``cells`` list is used
as given).
"""

from __future__ import annotations

from typing import Optional

import torch

from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.grid import Grid
from ptv_interpolation_tpu_torch.interpolate.delaunay import (
    linear_grid_interpolate, linear_interpolate)
from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
    idw_grid_interpolate, idw_interpolate, nearest_interpolate,
    sibson_grid_interpolate, sibson_interpolate)
from ptv_interpolation_tpu_torch.interpolate.rbf_global import (
    rbf_global_interpolate)
from ptv_interpolation_tpu_torch.interpolate.rbf_local import (
    rbf_local_grid_interpolate, rbf_local_interpolate)
from ptv_interpolation_tpu_torch.ops.neighbors import (CellList,
                                                       bounded_cell_list)
from ptv_interpolation_tpu_torch.utils import span

_CELLLIST_THRESHOLD = 2 ** 31  # Q·N beyond which brute force is wasteful

# Q·N at and above which the grid kernel serves a grid target (with at
# least _GRID_FASTPATH_MIN_POINTS points). The JAX package measured this
# crossover on its own device; it has not been measured on a GPU.
_GRID_FASTPATH_MIN_WORK = 2 ** 29
_GRID_FASTPATH_MIN_POINTS = 4096


def interpolate_values(points, values, queries, method: str = "linear",
                       rbf_neighbors: Optional[int] = 20,
                       rbf_kernel: str = "thin_plate_spline",
                       smoothing: float = 0.0, epsilon: float = 1.0,
                       idw_power: float = 2.0, idw_neighbors: int = 50,
                       sibson_neighbors: int = 30,
                       cells: CellList | None = None,
                       neighbor_method: str = "auto",
                       rings: int = 1, verbose: bool = False,
                       cubic_fallback: bool = False,
                       tri_cache_dir: Optional[str] = None,
                       device="cuda") -> torch.Tensor:
    """Interpolate scattered ``values`` (N, C) onto ``queries`` (Q, 3) on
    ``device``; returns (Q, C)."""
    dev = resolve_device(device)
    n_pts = int(points.shape[0])
    n_q = int(queries.shape[0])

    def make_progress():
        # per-chunk progress lines during long RBF evaluations, at ~10%
        # steps, as the reference prints them
        if not verbose or n_q < 500_000:
            return None
        last = [0]

        def report(done, total):
            pct = done * 10 // total
            if pct > last[0]:
                last[0] = pct
                print(f"  Interpolated {done}/{total} points...", flush=True)
        return report

    def get_cells(k):
        nonlocal cells
        if neighbor_method == "bruteforce":
            return None
        if neighbor_method == "auto" and n_pts * n_q <= _CELLLIST_THRESHOLD:
            return None
        if cells is None:
            cells = bounded_cell_list(points, k, rings, device=dev)
        return cells

    if method == "sibson":
        if verbose:
            print(f"Using Sibson (Natural Neighbor) Interpolation (neighbors={sibson_neighbors})...")
        k = min(sibson_neighbors, n_pts)
        return sibson_interpolate(points, values, queries, k=k,
                                  cells=get_cells(k), rings=rings, device=dev)
    if method == "idw":
        if verbose:
            print(f"Using IDW Interpolation (power={idw_power}, neighbors={idw_neighbors})...")
        k = min(idw_neighbors, n_pts)
        return idw_interpolate(points, values, queries, k=k, power=idw_power,
                               cells=get_cells(k), rings=rings, device=dev)
    if method == "rbf":
        if rbf_neighbors is None or rbf_neighbors >= n_pts:
            if verbose:
                print(f"Using global RBF ({rbf_kernel}), dense solve over {n_pts} points...")
            return rbf_global_interpolate(points, values, queries,
                                          kernel=rbf_kernel,
                                          smoothing=smoothing, epsilon=epsilon,
                                          progress=make_progress(),
                                          device=dev)
        if verbose:
            print(f"Using RBF Interpolation ({rbf_kernel}) with {rbf_neighbors} "
                  f"neighbors, smoothing={smoothing}...")
        k = min(rbf_neighbors, n_pts)
        return rbf_local_interpolate(points, values, queries, k=k,
                                     kernel=rbf_kernel, smoothing=smoothing,
                                     epsilon=epsilon, cells=get_cells(k),
                                     rings=rings, progress=make_progress(),
                                     device=dev)
    if method == "nearest":
        return nearest_interpolate(points, values, queries,
                                   cells=get_cells(1), rings=rings,
                                   device=dev)
    if method == "linear":
        return linear_interpolate(points, values, queries, fill_value=0.0,
                                  cache_dir=tri_cache_dir, device=dev)
    if method == "cubic":
        # scipy's griddata 'cubic' is 2D-only; with cubic_fallback=True the
        # documented substitute serves: local RBF with the cubic kernel, a
        # smooth C² 3D interpolant
        if cubic_fallback:
            if verbose:
                print("method='cubic': serving local RBF (kernel='cubic') "
                      "as the 3D substitute...")
            k = min(rbf_neighbors or 20, n_pts)
            return rbf_local_interpolate(points, values, queries, k=k,
                                         kernel="cubic", smoothing=smoothing,
                                         cells=get_cells(k), rings=rings,
                                         device=dev)
        raise ValueError(
            "method='cubic' is 2D-only in scipy's griddata and unsupported "
            "in 3D here as well — pass cubic_fallback=True (CLI: "
            "--cubic-fallback) to serve rbf kernel='cubic' instead.")
    raise ValueError(f"unknown interpolation method {method!r}")


def interpolate_field(points, values, grid: Grid, method: str = "linear",
                      use_grid_kernel: str = "auto", skip_mask=None,
                      tau_mode: str = "bisect", device="cuda", **kwargs):
    """Interpolate onto a :class:`Grid` on ``device``; returns ``(U, V,
    W)`` tensors of shape ``grid.shape`` on ``device``.

    For idw, sibson and local rbf on large problems the evaluation routes
    through the block-centric grid kernels. ``use_grid_kernel``: 'auto'
    (the grid kernels when Q·N ≥ 2²⁹ and N ≥ 4096), 'always', or 'never'.
    ``skip_mask`` ((nz, ny, nx) bool, True = value will be discarded) lets
    the idw/sibson grid kernel skip the repair of nodes the caller
    overwrites anyway. 'linear' goes to ``linear_grid_interpolate``'s
    host walk. ``kwargs`` go to :func:`interpolate_values` (and name the
    grid routes' neighbour counts, power, kernel, smoothing, epsilon and
    ``tri_cache_dir``)."""
    dev = resolve_device(device)
    n_pts = int(points.shape[0])
    work = n_pts * grid.n_points
    use_fast = (use_grid_kernel == "always"
                or (use_grid_kernel == "auto"
                    and work >= _GRID_FASTPATH_MIN_WORK
                    and n_pts >= _GRID_FASTPATH_MIN_POINTS))
    k = {"idw": kwargs.get("idw_neighbors", 50),
         "sibson": kwargs.get("sibson_neighbors", 30),
         "rbf": kwargs.get("rbf_neighbors", 20)}.get(method)
    if method == "rbf" and (k is None or k >= n_pts):
        use_fast = False                  # global RBF: no grid fast path
    if use_fast and k is not None:
        k = min(k, n_pts)
        with span("ptv.grid", method=method, n_points=n_pts,
                  nodes=grid.n_points, k=k):
            if method == "idw":
                out = idw_grid_interpolate(
                    points, values, grid, k=k,
                    power=kwargs.get("idw_power", 2.0), skip_mask=skip_mask,
                    tau_mode=tau_mode, device=dev)
            elif method == "sibson":
                out = sibson_grid_interpolate(
                    points, values, grid, k=k, skip_mask=skip_mask,
                    tau_mode=tau_mode, device=dev)
            else:
                out = rbf_local_grid_interpolate(
                    points, values, grid, k=k,
                    kernel=kwargs.get("rbf_kernel", "thin_plate_spline"),
                    smoothing=kwargs.get("smoothing", 0.0),
                    epsilon=kwargs.get("epsilon", 1.0), device=dev)
        return out[..., 0], out[..., 1], out[..., 2]

    if method == "linear":
        # grid targets use the fastest exact evaluator, scipy's walk and
        # blend; the Qhull triangulation dominates the wall either way
        out = linear_grid_interpolate(points, values, grid, fill_value=0.0,
                                      cache_dir=kwargs.get("tri_cache_dir"),
                                      device=dev)
        return out[..., 0], out[..., 1], out[..., 2]

    out = interpolate_values(points, values, grid.flat_coords(dev),
                             method=method, device=dev, **kwargs)
    out = out.reshape(grid.shape + (out.shape[-1],))
    return out[..., 0], out[..., 1], out[..., 2]
