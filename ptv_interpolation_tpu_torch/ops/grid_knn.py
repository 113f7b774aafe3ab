"""Block-centric kNN evaluation over regular grids: host setup, repair and
the entry point.

Counterpart of ``ptv_interpolation_tpu/ops/grid_knn.py``. This slice ports
the setup the fused path shares (cell list, margin, candidate-region
dimensions, row capacity, padded axes, cell-sorted values), the repair of
uncovered nodes, and the entry point routed to the fused kernel
(``ops/fused_grid_knn.py``). The streaming one-phase path
(``_grid_block_weighted_sum``), its subset and cell-list repair stages,
the ``backend='pallas'`` kernel and ``grid_knn_apply`` are not ported yet:
the routes that need them raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.grid import Grid
from ptv_interpolation_tpu_torch.ops.neighbors import (CellList,
                                                       build_cell_list)

_ROW_PAD = 1024   # sentinel rows after the sorted arrays bound a row's length


def _block_counts(n: int, b: int) -> int:
    return (n + b - 1) // b


def _pad_axis(ax, b: int) -> np.ndarray:
    """Axis coordinates (host f32) padded to a block multiple: the padded
    tail continues the grid spacing and is sliced away after reassembly.
    The main pass and the repair pass MUST agree on these coordinates."""
    ax = np.asarray(ax, np.float32)
    n_ax = len(ax)
    target = _block_counts(n_ax, b) * b
    if target == n_ax:
        return ax
    step = ax[1] - ax[0] if n_ax > 1 else 1.0
    extra = ax[-1] + step * np.arange(1, target - n_ax + 1)
    return np.concatenate([ax, extra]).astype(np.float32)


class RowCapacityError(ValueError):
    """No cell resolution keeps a candidate row within the 1024-row
    sentinel padding (pathologically clustered or coincident points)."""


def _row_capacity(cells: CellList, mcx: int) -> int:
    """Maximum number of points in any ``mcx``-wide x-run of cells,
    computed where ``starts`` lives; one scalar crosses to the host."""
    ncx, ncy, ncz = cells.dims
    w = min(mcx, ncx)
    counts = torch.diff(cells.starts).reshape(ncz * ncy, ncx).to(torch.int64)
    csum = torch.cat([counts.new_zeros((ncz * ncy, 1)),
                      torch.cumsum(counts, dim=1)], dim=1)
    windows = csum[:, w:] - csum[:, :-w] if ncx > w else csum[:, -1:]
    return max(int(windows.max().item()), 1)


def _host_setup(points, values, grid: Grid, k: int, block, margin_factor,
                cell_divisor: float = 2.0, device="cuda"):
    """Shared setup: cell list, margin, static candidate-region dimensions
    ``mc = (mcz, mcy, mcx)`` in cells, row capacity, padded axes and
    cell-sorted values. Auto cell edge = margin / ``cell_divisor`` (the
    fused path passes 3).

    On strongly clustered clouds a candidate row can exceed 1024 points;
    the cell list is then rebuilt at finer resolution (a row's y/z
    thickness is one cell, so capacity shrinks about quadratically with
    the cell edge), and :class:`RowCapacityError` is raised when that
    cannot help. Returns ``(cells, values_sorted, axes, margin, mc,
    row_len, values_dev)``; ``axes`` are host f32 arrays."""
    dev = resolve_device(device)
    pts = as_f32(points, dev)
    vals = as_f32(values, dev)
    n = pts.shape[0]
    lo = pts.amin(dim=0).cpu().numpy()
    hi = pts.amax(dim=0).cpu().numpy()
    extent = np.maximum(hi - lo, 1e-12)
    density = n / float(np.prod(extent))
    r_k = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    cell_size = max(r_k * margin_factor / cell_divisor, 1e-6)
    cells = build_cell_list(pts, cell_size=cell_size, bounds=(lo, hi),
                            device=dev)

    margin = r_k * margin_factor
    dx, dy, dz = grid.spacing
    block_ext = (block[2] * dx, block[1] * dy, block[0] * dz)  # x, y, z

    def region_dims(cs):
        return tuple(int(math.ceil((ext + 2.0 * margin) / cs)) + 1
                     for ext in block_ext)[::-1]

    mc = region_dims(cell_size)
    row_len = _row_capacity(cells, mc[2])
    for _ in range(6):
        if row_len <= _ROW_PAD:
            break
        shrink = min(math.sqrt(float(_ROW_PAD) / row_len) * 0.9, 0.7)
        cell_size = cell_size * shrink
        if cell_size < 1e-9:
            break
        cells = build_cell_list(pts, cell_size=cell_size, bounds=(lo, hi),
                                device=dev)
        mc = region_dims(cell_size)
        row_len = _row_capacity(cells, mc[2])
    if row_len > _ROW_PAD:
        raise RowCapacityError(
            f"cell row capacity {row_len} exceeds the sorted-array padding "
            f"at every cell resolution tried — cloud too clustered for the "
            f"block kernel")

    axes = (_pad_axis(grid.x, block[2]), _pad_axis(grid.y, block[1]),
            _pad_axis(grid.z, block[0]))
    values_sorted = _sort_values(vals, cells.order)
    return cells, values_sorted, axes, margin, mc, row_len, vals


def _sort_values(vals: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Values in cell order, padded with 1024 zero rows (the sentinel
    rows of ``points_sorted``)."""
    return torch.cat([vals[order.long()],
                      vals.new_zeros((_ROW_PAD, vals.shape[1]))])


def repair_empty_nodes(out, den, points, values, grid: Grid, k: int,
                       mode: str, power: float = 2.0,
                       cells: CellList | None = None,
                       margin: float | None = None, skip_mask=None,
                       values_sorted=None, block=None):
    """Recompute the nodes the block kernel could not serve exactly — they
    arrive with ``den == 0`` (the coverage sentinel) — in two stages:

    1. ``fused_repair``: the fused kernel again at 1.6× the margin over
       just the blocks holding uncovered nodes; nodes certify themselves
       through the widened coverage sentinel (needs ``cells``, ``margin``,
       ``values_sorted`` and ``block``).
    2. exact brute force against the whole cloud for what stage 1 left,
       or for every uncovered node when stage 1 declines (too many
       uncovered blocks, or a void-dominated cloud).

    ``out``: (nz, ny, nx, V) and ``den``: (nz, ny, nx) tensors on the
    device; ``skip_mask`` (True = skip) excludes nodes the caller
    overwrites anyway. Returns the repaired (nz, ny, nx, V) field."""
    if (cells is not None and margin is not None and block is not None
            and values_sorted is not None):
        from ptv_interpolation_tpu_torch.ops import fused_grid_knn
        res = fused_grid_knn.fused_repair(
            out, den, skip_mask, cells, values_sorted, grid, k, mode, power,
            tuple(block), float(margin))
        if res is not None:
            out, den2, n_left = res
            if n_left == 0:
                return out
            return repair_empty_nodes(out, den2, points, values, grid, k,
                                      mode, power, skip_mask=skip_mask)
    dev = out.device
    den_zero = den == 0.0
    if skip_mask is not None:
        den_zero &= ~torch.as_tensor(skip_mask, dtype=torch.bool, device=dev)
    flat = torch.nonzero(den_zero.reshape(-1)).squeeze(1)
    n_fix = flat.numel()
    if n_fix == 0:
        return out
    nz, ny, nx = den.shape
    iz, iy, ix = flat // (ny * nx), (flat // nx) % ny, flat % nx
    axes = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (grid.x, grid.y, grid.z)]
    queries = torch.stack([axes[0][ix], axes[1][iy], axes[2][iz]], dim=-1)
    n_nodes = nz * ny * nx
    if n_fix > 0.01 * n_nodes:
        print(f"[grid_knn] repairing {n_fix}/{n_nodes} uncovered grid nodes "
              f"({100.0 * n_fix / n_nodes:.1f}%) through the exact "
              f"brute-force path — the point cloud has large voids relative "
              f"to the kNN margin")
    from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
        idw_interpolate, sibson_interpolate)
    kk = min(k, points.shape[0])
    if mode == "idw":
        fixed = idw_interpolate(points, values, queries, k=kk, power=power,
                                device=dev)
    else:
        fixed = sibson_interpolate(points, values, queries, k=kk, device=dev)
    V = out.shape[-1]
    out = out.reshape(-1, V).clone()
    out[flat] = fixed
    return out.reshape(den.shape + (V,))


def grid_weighted_interpolate(points, values, grid: Grid, k: int,
                              weight_fn: Callable,
                              cells: CellList | None = None,
                              block: Tuple[int, int, int] | None = None,
                              margin_factor: float = 1.45,
                              backend: str = "auto", mode: str = "sibson",
                              power: float = 2.0, tau_mode: str = "bisect",
                              skip_mask=None, device="cuda"):
    """IDW/sibson onto ``grid`` on ``device``; returns an (nz, ny, nx, V)
    tensor there.

    ``backend``: ``'auto'`` and ``'fused'`` both run the fused two-phase
    kernel (``ops/fused_grid_knn.py``) with ``tau_mode='bisect'``, which
    needs ``weight_fn`` to be the canned formula for ``mode``
    (``knn_weights._idw_panel_weights`` / ``_sibson_panel_weights``). The
    streaming path that would serve ``backend='xla'``, other τ modes, a
    custom ``weight_fn`` or a prebuilt ``cells`` is not ported yet, and
    neither is ``backend='pallas'``: those raise ``NotImplementedError``.
    ``FusedCapacityError`` and ``RowCapacityError`` propagate."""
    if backend not in ("auto", "fused"):
        if backend in ("xla", "pallas"):
            raise NotImplementedError(
                f"backend={backend!r} is not ported yet; use 'fused'")
        raise ValueError(f"unknown backend {backend!r}")
    canned = getattr(weight_fn, "canned_mode", None) == mode
    if backend == "fused" and not canned:
        raise ValueError(
            "backend='fused' computes its own idw/sibson weights and "
            "cannot honor a custom weight_fn; use backend='xla'")
    if backend == "fused" and tau_mode != "bisect":
        raise ValueError(
            "backend='fused' implements tau_mode='bisect' only; use "
            "backend='xla' for approx/exact selection modes")
    if not canned or tau_mode != "bisect" or cells is not None:
        raise NotImplementedError(
            "a custom weight_fn, tau_mode other than 'bisect' or a prebuilt "
            "cell list needs the streaming path, which is not ported yet")
    from ptv_interpolation_tpu_torch.ops.fused_grid_knn import (
        fused_grid_weighted_interpolate)
    return fused_grid_weighted_interpolate(
        points, values, grid, k, mode=mode, power=power, block=block,
        margin_factor=margin_factor, skip_mask=skip_mask, device=device)
