"""Outlier rejection for scattered PTV vectors.

Counterpart of ``ptv_interpolation_tpu/filtering.py``:

* a global speed threshold;
* the k-NN median/MAD statistical filter: a point is an outlier when its
  speed deviates from the median of its k nearest neighbours' speeds by
  more than ``threshold`` MAD units (ε = 1e-6 guards uniform regions).

Decisions (a boolean keep mask) are computed on ``device``; dropping rows
is a host-side finalisation on the :class:`PointCloud`. Medians follow
``np.median``: the mean of the two middle values at even counts, NaN
skipped (``torch.median`` would return the lower one).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.io.csvio import PointCloud
from ptv_interpolation_tpu_torch.utils import count
from ptv_interpolation_tpu_torch.ops.neighbors import (bounded_cell_list,
                                                       bruteforce_tile_fn,
                                                       celllist_tile_fn,
                                                       map_query_tiles)

# above this many points the filter takes the scatter-block route; below
# it, the exact brute-force route (O(N²) beyond it is wasteful)
_SCATTER_MIN_POINTS = 200_000


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Mirrors the reference CLI flags."""

    filter_outliers: bool = False
    filter_neighbors: int = 25        # --filter-neighbors
    filter_threshold: float = 3.0     # --filter-threshold (MAD units)
    filter_max_speed: float = 10.0    # --filter-max-speed


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``np.nanmedian`` along ``dim``: the mean of the two middle non-NaN
    values (one when their count is odd), NaN where a slice holds none.
    f32 in, f32 out, formed as ``(lo + hi)·0.5`` like the JAX package."""
    s = torch.sort(x, dim=dim).values              # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    top = x.shape[dim] - 1
    lo = s.gather(dim, torch.div(n - 1, 2, rounding_mode="floor")
                  .clamp(0, top))
    hi = s.gather(dim, torch.div(n, 2, rounding_mode="floor").clamp(0, top))
    med = (lo + hi) * 0.5
    return torch.where(n > 0, med, torch.nan).squeeze(dim)


def _speed(v: torch.Tensor) -> torch.Tensor:
    """|v| summed left to right, as numpy sums three components."""
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                      + v[:, 2] * v[:, 2])


def speed_threshold_mask(values, max_speed, device="cuda") -> torch.Tensor:
    """Keep mask of the global speed filter, on ``device``."""
    return _speed(as_f32(values, resolve_device(device))) <= max_speed


def knn_mad_mask(points, values, k: int = 25, threshold: float = 3.0,
                 query_tile: int = 1024, cells=None, rings: int = 1,
                 device="cuda"):
    """Keep mask of the k-NN median/MAD filter over exact brute-force kNN,
    or the cell-list search over ``cells`` (small clouds, parity tests,
    and the fallback of clustered clouds); the pipeline uses
    :func:`knn_mad_mask_scatter` at scale.

    Queries the k+1 nearest (self included, then dropped as the
    reference's ``idx[:, 1:]``), takes the neighbourhood speed median and
    MAD, and flags ``|speed - median| / (MAD + 1e-6) > threshold``.
    Returns ``(keep_mask, median_filter_radius)`` tensors on ``device``;
    the radius is the median distance to the k-th neighbour. A cell-list
    slot with no point (id ``n_points``) reads the last point's speed, as
    the JAX package's clamped gather does."""
    dev = resolve_device(device)
    pts = as_f32(points, dev)
    speed = _speed(as_f32(values, dev))
    if cells is not None:
        if cells.device != pts.device:
            raise ValueError(f"cells live on {cells.device}, not on "
                             f"{pts.device}")
        neighbor = celllist_tile_fn(cells, k + 1, rings)
    else:
        neighbor = bruteforce_tile_fn(pts, k + 1)

    def tile(q_tile):
        sq, idx = neighbor(q_tile)
        n_idx = idx[:, 1:]                 # drop self, the nearest
        n_sq = sq[:, 1:]
        n_speeds = torch.where(
            n_idx >= 0, speed[n_idx.clamp(0, speed.shape[0] - 1)], torch.nan)
        med = nanmedian(n_speeds, dim=1)
        mad = nanmedian((n_speeds - med[:, None]).abs(), dim=1)
        kth = torch.sqrt(torch.clamp_min(n_sq[:, -1], 0.0))
        return med, mad, kth

    med, mad, kth = map_query_tiles(tile, pts, query_tile)
    z = (speed - med).abs() / (mad + 1e-6)
    return z <= threshold, nanmedian(kth, dim=0)


def remove_outliers_threshold(cloud: PointCloud, max_speed: float = 10.0,
                              verbose: bool = True) -> PointCloud:
    # host numpy on purpose: the values live on the host before and after,
    # and a 650k-point norm is cheaper there than a round trip
    v = np.asarray(cloud.values, np.float32)
    keep = np.sqrt((v * v).sum(axis=-1)) <= max_speed
    n_removed = int((~keep).sum())
    if n_removed > 0:
        if verbose:
            print(f"  Threshold Filter: Removed {n_removed} points with speed > {max_speed}.")
        return cloud.select(keep)
    return cloud


@functools.lru_cache(maxsize=8)
def _mad_consume(k: int, threshold: float):
    """Scatter-block consumer: per-point keep flag + k-th neighbour
    distance. The query set IS the point set, so the nearest candidate
    (distance 0) is the point itself, dropped as the reference drops
    ``idx[:, 1:]``. Neighbour *speeds* ride in the value channel."""
    def consume(sq, n_pos, n_val, ok, q):
        speeds = n_val[:, :, 0]
        own = speeds[:, 0]
        neigh = torch.where(ok[:, 1:], speeds[:, 1:], torch.nan)
        med = nanmedian(neigh, dim=1)
        mad = nanmedian((neigh - med[:, None]).abs(), dim=1)
        z = (own - med).abs() / (mad + 1e-6)
        keep = (z <= threshold).float()
        kth = torch.sqrt(torch.clamp_min(sq[:, -1], 0.0))
        return torch.stack([keep, kth], dim=-1)
    return consume


def _host_exact_mad_decide(pts, speed, idx, k, threshold):
    """Exact keep decisions for a handful of panel-uncovered points: the
    reference formulation in f64, brute-forced over the full cloud — one
    O(N) distance pass per point, so only sensible for len(idx) ≲ 16."""
    p = pts.astype(np.float64)
    s = np.asarray(speed, np.float64)
    # one vectorized (len(idx), N) distance pass — ~60 MB f64 at the
    # 16-point cap, vs one full traversal per point when looped
    d2 = ((p[idx, None, :] - p[None, :, :]) ** 2).sum(axis=2)
    kk = min(k + 1, len(p) - 1)
    nn = np.argpartition(d2, kk, axis=1)[:, :k + 2]
    ord_ = np.argsort(np.take_along_axis(d2, nn, axis=1), axis=1,
                      kind="stable")
    nn = np.take_along_axis(nn, ord_, axis=1)[:, :k + 1]
    neigh = s[nn[:, 1:]]                        # drop one self-copy
    med = np.median(neigh, axis=1)
    mad = np.median(np.abs(neigh - med[:, None]), axis=1)
    return np.abs(s[idx] - med) / (mad + 1e-6) <= threshold


def knn_mad_mask_scatter(points, values, k: int = 25, threshold: float = 3.0,
                         device="cuda", **kwargs):
    """At-scale kNN-MAD decisions on ``device``; returns ``(keep, radius)``
    — a numpy bool array and a float.

    With no ``kwargs`` the fused panel kernel serves
    (``ops/fused_mad.py``): every statistic the filter needs is an order
    statistic, found by monotone counting over a candidate panel. Points
    the panel could not certify (domain corners, density holes, decisions
    within the bisection's error bound) are re-decided exactly: up to 16
    on the host in f64, up to 5% through the exact scatter-block kNN, and
    past that (pathological coverage) every point takes the selection
    path. Where ``fused_mad_filter`` declines (panel past its bounds), or
    when ``kwargs`` pin the selection (``exact_topk``, ``recall_target``:
    both served by exact selection), the scatter-block kNN serves
    directly. The JAX package takes the fused route on a TPU only; here
    it is the route on both devices.

    The counter ``filter.branch.<branch>`` counts what served the call's
    uncovered points, branch one of ``fused`` (none uncovered),
    ``host_f64``, ``exact_scatter`` or ``selection``, and
    ``filter.uncovered`` counts those points."""
    from ptv_interpolation_tpu_torch.ops.grid_knn import scatter_knn_apply

    pts = np.asarray(points, np.float32)
    v = np.asarray(values, np.float32)
    speed = np.sqrt((v * v).sum(axis=-1, keepdims=True))

    n_unc = len(pts)
    if not kwargs:
        from ptv_interpolation_tpu_torch.ops.fused_mad import fused_mad_filter
        res = fused_mad_filter(pts, speed[:, 0], int(k), float(threshold),
                               device=device)
        if res is not None:
            keep, covered, radius, _ = res
            unc = ~covered
            n_unc = int(unc.sum())
            branch = "fused"
            if 0 < n_unc <= 16:
                # a handful of corner/density-hole points: one O(N) host
                # pass per point beats a second dispatch chain
                keep[unc] = _host_exact_mad_decide(
                    pts, speed[:, 0], np.flatnonzero(unc), int(k),
                    float(threshold))
                branch = "host_f64"
            elif 0 < n_unc <= 0.05 * len(pts):
                sub = scatter_knn_apply(
                    pts, speed, pts[unc], k + 1,
                    _mad_consume(int(k), float(threshold)), out_dim=2,
                    exact_topk=True, device=device)
                keep[unc] = sub[:, 0] > 0.5
                branch = "exact_scatter"
            if branch != "fused" or n_unc == 0:
                count("filter.branch." + branch)
                count("filter.uncovered", n_unc)
                return keep, radius
            # pathological coverage (>5% uncovered): selection path below

    out = scatter_knn_apply(pts, speed, pts, k + 1,
                            _mad_consume(int(k), float(threshold)),
                            out_dim=2, device=device, **kwargs)
    count("filter.branch.selection")
    count("filter.uncovered", n_unc)
    keep = out[:, 0] > 0.5
    radius = float(np.median(out[:, 1]))
    return keep, radius



def remove_outliers_knn(cloud: PointCloud, k: int = 25, threshold: float = 3.0,
                        use_celllist: bool | None = None,
                        verbose: bool = True, device="cuda") -> PointCloud:
    n = len(cloud)
    if n <= k:
        if verbose:
            print(f"  Warning: point cloud too small ({n}) for k-NN filter (k={k}). Skipping.")
        return cloud
    if use_celllist is None:
        use_celllist = n > _SCATTER_MIN_POINTS
    if use_celllist:
        from ptv_interpolation_tpu_torch.ops.grid_knn import RowCapacityError
        try:
            keep, radius = knn_mad_mask_scatter(cloud.points, cloud.values,
                                                k=k, threshold=threshold,
                                                device=device)
        except RowCapacityError:
            # pathologically clustered cloud: the generic cell-list search
            # (its per-cell capacity is not bound by the scatter kernel's
            # 1024-row padding), or the streamed brute force where even the
            # cell list cannot bound its panel
            cells = bounded_cell_list(cloud.points, k + 1, device=device)
            keep, radius = knn_mad_mask(cloud.points, cloud.values, k=k,
                                        threshold=threshold, cells=cells,
                                        device=device)
    else:
        keep, radius = knn_mad_mask(cloud.points, cloud.values, k=k,
                                    threshold=threshold, device=device)
    if torch.is_tensor(keep):
        keep = keep.cpu().numpy()
    if verbose:
        print(f"  Filtering radius: median voxel distance to {k}-th neighbor = {float(radius):.4f}")
    n_removed = int((~keep).sum())
    if n_removed > 0:
        if verbose:
            print(f"  Outlier Filter: Removed {n_removed} points ({n_removed / n * 100:.2f}%).")
        return cloud.select(keep)
    if verbose:
        print("  Outlier Filter: No outliers detected.")
    return cloud


def apply_filters(cloud: PointCloud, config: FilterConfig,
                  verbose: bool = True, device="cuda") -> PointCloud:
    """Centralized filtering entry point: threshold, then kNN-MAD."""
    if not config.filter_outliers:
        return cloud
    cloud = remove_outliers_threshold(cloud, config.filter_max_speed, verbose)
    if len(cloud) > 0:
        cloud = remove_outliers_knn(cloud, k=config.filter_neighbors,
                                    threshold=config.filter_threshold,
                                    verbose=verbose, device=device)
    return cloud
