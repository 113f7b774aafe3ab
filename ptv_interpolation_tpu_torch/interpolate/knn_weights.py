"""kNN-weighted interpolation: IDW and the reference's "sibson" variant.

Counterpart of ``ptv_interpolation_tpu/interpolate/knn_weights.py``:

* IDW — weights ``1/(d^p + 1e-10)``, normalised, per-channel weighted sum
  over the k nearest particles.
* "sibson" — not natural-neighbour interpolation: inverse-distance weights
  times an ``exp(-(d - min d)/std(d))`` smoothing factor, renormalised. The
  shift by ``min d`` cancels under normalisation and keeps the f32 exp from
  underflowing to an all-zero row for queries far from the cloud.

Scattered queries use exact brute-force kNN, or the generic cell-list
search when a ``cells`` list is given; grid targets use the block-centric
paths of ``ops/grid_knn.py`` (the fused kernel, the one-phase kernel of
``backend='pallas'``, the streaming path, or the exact top-k gather path
of ``exact_topk=True``). :func:`nearest_interpolate` is kNN with k = 1.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ptv_interpolation_tpu_torch.device import (as_f32, flush_subnormal,
                                                resolve_device)
from ptv_interpolation_tpu_torch.ops.neighbors import (CellList,
                                                       bruteforce_tile_fn,
                                                       celllist_tile_fn,
                                                       map_query_tiles)

_EPS = 1e-10


def _idw_weights(dist: torch.Tensor, power: float, ok=None) -> torch.Tensor:
    """Normalised IDW weights; ``ok`` masks invalid neighbour slots and
    the weights renormalise over the valid ones. Subnormal weights are 0,
    as the JAX package's are: that decides the value of a query whose only
    neighbours are the cell list's empty slots (d² = 3.4e38, weight
    2.9e-39), which is 0."""
    w = flush_subnormal(1.0 / (dist ** power + _EPS))
    if ok is not None:
        w = torch.where(ok, w, 0.0)
    return w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-37)


def _sibson_weights(dist: torch.Tensor, ok=None) -> torch.Tensor:
    """Normalised smoothed-IDW weights; with ``ok``, the min/std statistics
    and the normalisation run over the valid slots only (numpy std,
    ddof=0)."""
    if ok is None:
        ok = torch.ones_like(dist, dtype=torch.bool)
    okf = ok.to(dist.dtype)
    n_ok = torch.clamp_min(okf.sum(dim=-1, keepdim=True), 1.0)
    inv = torch.where(ok, 1.0 / (dist + _EPS), 0.0)
    d_ok = torch.where(ok, dist, 0.0)
    mean = d_ok.sum(dim=-1, keepdim=True) / n_ok
    var = (okf * (d_ok - mean) ** 2).sum(dim=-1, keepdim=True) / n_ok
    dist_std = torch.sqrt(torch.clamp_min(var, 0.0))
    dmin = torch.where(ok, dist, torch.inf).amin(dim=-1, keepdim=True)
    dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)
    smoothing = torch.where(ok, torch.exp(-(dist - dmin) / (dist_std + _EPS)),
                            0.0)
    w = inv * smoothing
    return w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-37)


def _gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` with ``idx`` clamped into range, as the JAX
    package's gathers clamp: -1 (a missing neighbour) reads row 0, and the
    cell list's empty-slot id ``n_points`` reads the last row."""
    return values[idx.clamp(0, values.shape[0] - 1)]


def _weighted_tile(neighbor_fn, values: torch.Tensor, weight_fn: Callable):
    def tile(q_tile):
        sq, idx = neighbor_fn(q_tile)
        ok = idx >= 0
        # clamp missing-slot distances (~3.4e38) before weighting: they
        # overflow f32 inside dist**power
        dist = torch.sqrt(torch.clamp_min(torch.where(ok, sq, 1.0), 0.0))
        w = weight_fn(dist, ok)                               # (T, k)
        vals = _gather_rows(values, idx)                      # (T, k, C)
        return (w[..., None] * vals).sum(dim=1)               # exact f32

    return tile


def _neighbor_fn(points: torch.Tensor, k: int, cells: CellList | None,
                 rings: int, point_chunk: int):
    """The cell-list search when ``cells`` is given (on the points'
    device), else exact brute force."""
    if cells is not None:
        if cells.device != points.device:
            raise ValueError(f"cells live on {cells.device}, not on "
                             f"{points.device}")
        return celllist_tile_fn(cells, k, rings)
    return bruteforce_tile_fn(points, k, point_chunk)


def idw_interpolate(points, values, queries, k: int = 50, power: float = 2.0,
                    cells: CellList | None = None, rings: int = 1,
                    query_tile: int = 1024, point_chunk: int = 4096,
                    device="cuda") -> torch.Tensor:
    """IDW interpolation of ``values`` (N, C) at ``queries`` (Q, 3) on
    ``device``, by exact brute-force kNN or the cell-list search over
    ``cells``. Returns (Q, C)."""
    dev = resolve_device(device)
    tile = _weighted_tile(
        _neighbor_fn(as_f32(points, dev), k, cells, rings, point_chunk),
        as_f32(values, dev), lambda d, ok: _idw_weights(d, power, ok))
    return map_query_tiles(tile, as_f32(queries, dev), query_tile)


def sibson_interpolate(points, values, queries, k: int = 30,
                       cells: CellList | None = None, rings: int = 1,
                       query_tile: int = 1024, point_chunk: int = 4096,
                       device="cuda") -> torch.Tensor:
    """Reference-parity "sibson" (smoothed-IDW) interpolation at
    ``queries`` (Q, 3) on ``device``, by exact brute-force kNN or the
    cell-list search over ``cells``."""
    dev = resolve_device(device)
    tile = _weighted_tile(
        _neighbor_fn(as_f32(points, dev), k, cells, rings, point_chunk),
        as_f32(values, dev), _sibson_weights)
    return map_query_tiles(tile, as_f32(queries, dev), query_tile)


def nearest_interpolate(points, values, queries,
                        cells: CellList | None = None, rings: int = 1,
                        query_tile: int = 1024, point_chunk: int = 4096,
                        device="cuda") -> torch.Tensor:
    """Nearest-neighbour interpolation (``griddata(method='nearest')``):
    kNN with k = 1 on ``device``. Returns (Q, C). With ``cells``, a query
    whose neighbourhood holds no point reads the last point's values, as
    the JAX package's clamped gather does."""
    dev = resolve_device(device)
    vals = as_f32(values, dev)
    neighbor = _neighbor_fn(as_f32(points, dev), 1, cells, rings, point_chunk)

    def tile(q_tile):
        _, idx = neighbor(q_tile)
        return _gather_rows(vals, idx[:, 0])

    return map_query_tiles(tile, as_f32(queries, dev), query_tile)


# ---------------------------------------------------------------------------
# Grid fast paths: block-centric evaluation (ops/grid_knn.py)
# ---------------------------------------------------------------------------

def _consume(weights: Callable):
    """``consume(sq, n_pos, n_val, ok, q)`` of ``grid_knn_apply``: the
    weighted sum of the k neighbours' values, (rows, V)."""
    def consume(sq, n_pos, n_val, ok, q):
        d = torch.sqrt(torch.clamp_min(torch.where(ok, sq, 1.0), 0.0))
        return (weights(d, ok)[..., None] * n_val).sum(dim=1)
    return consume


@functools.lru_cache(maxsize=32)
def _idw_consume(power: float):
    return _consume(lambda d, ok: _idw_weights(d, power, ok))


@functools.lru_cache(maxsize=1)
def _sibson_consume():
    return _consume(_sibson_weights)


@functools.lru_cache(maxsize=32)
def _idw_panel_weights(power: float):
    """IDW panel weight function ``fn(d, mask, sq_topk)``, tagged with
    ``canned_mode`` so that ``grid_weighted_interpolate`` may route the
    call to the fused kernel, which derives the same weights itself."""
    def weight_fn(d, mask, sq_topk):
        return 1.0 / (d ** power + _EPS)
    weight_fn.canned_mode = "idw"
    return weight_fn


@functools.lru_cache(maxsize=1)
def _sibson_panel_weights():
    """Sibson panel weight function ``fn(d, mask, sq_topk)``: the k-set
    statistics come from masked reductions over the panel (``sq_topk``
    None) or from the selected top-k squared distances. Tagged with
    ``canned_mode`` like :func:`_idw_panel_weights`."""
    def weight_fn(d, mask, sq_topk):
        if sq_topk is None:
            okf = mask.to(d.dtype)
            n_ok = torch.clamp_min(okf.sum(dim=-1, keepdim=True), 1.0)
            d_ok = torch.where(mask, d, 0.0)
            mean = d_ok.sum(dim=-1, keepdim=True) / n_ok
            var = (okf * (d_ok - mean) ** 2).sum(dim=-1, keepdim=True) / n_ok
            std = torch.sqrt(torch.clamp_min(var, 0.0))
            dmin = torch.where(mask, d, torch.inf).amin(dim=-1, keepdim=True)
            dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)
        else:
            d_k = torch.sqrt(torch.clamp_min(sq_topk, 0.0))
            std = d_k.std(dim=-1, keepdim=True, correction=0)
            dmin = d_k[:, :1]
        inv = 1.0 / (d + _EPS)
        return inv * torch.exp(-(d - dmin) / (std + _EPS))
    weight_fn.canned_mode = "sibson"
    return weight_fn


def _gather_route(points, values, grid, k: int, consume, kwargs):
    """``exact_topk=True``: the exact top-k gather path, which has no
    repair stage and no τ threshold."""
    from ptv_interpolation_tpu_torch.ops.grid_knn import grid_knn_apply
    kwargs.pop("skip_mask", None)
    kwargs.pop("tau_mode", None)
    return grid_knn_apply(points, values, grid, k, consume,
                          out_dim=int(values.shape[1]), exact_topk=True,
                          needs_positions=False, **kwargs)


def idw_grid_interpolate(points, values, grid, k: int = 50,
                         power: float = 2.0, exact_topk: bool = False,
                         **kwargs) -> torch.Tensor:
    """IDW onto a :class:`Grid` via the block-centric τ-threshold kernel;
    returns (nz, ny, nx, C) on ``device`` (a keyword, default 'cuda').
    ``exact_topk=True`` routes through the gather path with exact top-k
    selection (``grid_knn_apply``, the parity oracle); other keywords go
    to ``grid_weighted_interpolate`` (``backend``, ``tau_mode``, ...)."""
    if exact_topk:
        return _gather_route(points, values, grid, k,
                             _idw_consume(float(power)), kwargs)
    from ptv_interpolation_tpu_torch.ops.grid_knn import (
        grid_weighted_interpolate)
    return grid_weighted_interpolate(points, values, grid, k,
                                     _idw_panel_weights(float(power)),
                                     mode="idw", power=float(power),
                                     **kwargs)


def sibson_grid_interpolate(points, values, grid, k: int = 30,
                            exact_topk: bool = False,
                            **kwargs) -> torch.Tensor:
    """Sibson (smoothed IDW) onto a :class:`Grid` via the block-centric
    τ-threshold kernel; returns (nz, ny, nx, C) on ``device`` (a keyword,
    default 'cuda'). ``exact_topk`` and the other keywords as for
    :func:`idw_grid_interpolate`."""
    if exact_topk:
        return _gather_route(points, values, grid, k, _sibson_consume(),
                             kwargs)
    from ptv_interpolation_tpu_torch.ops.grid_knn import (
        grid_weighted_interpolate)
    return grid_weighted_interpolate(points, values, grid, k,
                                     _sibson_panel_weights(), mode="sibson",
                                     **kwargs)
