"""Block-centric kNN evaluation over regular grids and scattered queries:
host setup, repair, the grid entry point and the scatter-block path.

Counterpart of ``ptv_interpolation_tpu/ops/grid_knn.py``. Ported: the
setup the fused path shares (cell list, margin, candidate-region
dimensions, row capacity, padded axes, cell-sorted values), the repair of
uncovered nodes, the grid entry point routed to the fused kernel
(``ops/fused_grid_knn.py``), and the scatter-block kNN over arbitrary
query points (``scatter_knn_apply``) with exact ``torch.topk`` selection.
The streaming one-phase grid path (``_grid_block_weighted_sum``), its
subset and cell-list repair stages, the ``backend='pallas'`` kernel,
``grid_knn_apply`` and ``approx_min_k`` selection are not ported yet: the
routes that need them raise ``NotImplementedError``.
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
_BIG = 3.4e38     # sentinel squared distance of an empty candidate slot
_SCATTER_ELEMS = 1 << 24   # bound on (blocks × b_cap × C) distance panels


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


# ---------------------------------------------------------------------------
# Scatter-block variant: arbitrary query points grouped into spatial blocks
# ---------------------------------------------------------------------------

def _scatter_block_eval(cells: CellList, values_sorted: torch.Tensor,
                        queries_padded: torch.Tensor, q_table: torch.Tensor,
                        block_origins: torch.Tensor, margin: float, k: int,
                        mc: Tuple[int, int, int], row_len: int,
                        out_dim: int, consume_fn: Callable) -> torch.Tensor:
    """Exact kNN of queries pre-grouped into spatial blocks (``q_table``:
    (n_blocks, b_cap) indices into ``queries_padded``, whose last row is
    a far sentinel) against each block's candidate region of ``mcz·mcy``
    CSR rows of at most ``row_len`` points. Returns (n_blocks·b_cap,
    out_dim): ``consume_fn(sq, None, n_val, n_ok, q)`` of the k nearest,
    ascending, per query.

    A block's candidates are its compacted CSR rows
    (``fused_grid_knn._compact_rows`` at width mcz·mcy·row_len): the
    valid ones come in the JAX package's slot order (row by row, lane
    ascending), empty slots get d² = 3.4e38. Selection is ``torch.topk``,
    then ties ordered by slot as ``lax.top_k`` orders them, so that
    coincident points give the same neighbour order. Blocks are evaluated
    in chunks whose (blocks, b_cap, C) panel stays bounded."""
    from ptv_interpolation_tpu_torch.ops.fused_grid_knn import _compact_rows
    n_blocks, b_cap = q_table.shape
    C = mc[0] * mc[1] * row_len
    kk = min(k, C)
    outs = []
    group = max(1, _SCATTER_ELEMS // (b_cap * C))
    for s in range(0, n_blocks, group):
        G = _compact_rows(cells, block_origins[s:s + group], margin, mc,
                          C).long()                           # (g, C)
        valid = G < cells.n_points
        cand = cells.points_sorted[G]                         # (g, C, 3)
        q = queries_padded[q_table[s:s + group]]              # (g, b, 3)
        d = q[:, :, None, 0] - cand[:, None, :, 0]
        d2 = d * d
        d = q[:, :, None, 1] - cand[:, None, :, 1]
        d2 = d2 + d * d
        d = q[:, :, None, 2] - cand[:, None, :, 2]
        d2 = d2 + d * d                                       # (g, b, C)
        del d
        d2 = torch.where(valid[:, None, :], d2, _BIG)
        sq, args = torch.topk(d2, kk, dim=-1, largest=False)
        del d2
        args, perm = torch.sort(args, dim=-1)
        sq, perm2 = torch.sort(torch.gather(sq, -1, perm), dim=-1,
                               stable=True)
        args = torch.gather(args, -1, perm2)
        rows = torch.gather(G, 1, args.reshape(args.shape[0], -1))
        n_val = values_sorted[rows].reshape(args.shape + (-1,))
        n_ok = (torch.gather(valid, 1, args.reshape(args.shape[0], -1))
                .reshape(args.shape) & (sq < _BIG))
        g, b = args.shape[:2]
        outs.append(consume_fn(sq.reshape(g * b, kk), None,
                               n_val.reshape(g * b, kk, -1),
                               n_ok.reshape(g * b, kk),
                               q.reshape(g * b, 3)))
    return torch.cat(outs).reshape(n_blocks * b_cap, out_dim)


def scatter_knn_apply(points, values, queries, k: int, consume_fn: Callable,
                      out_dim: int, cell_size: float | None = None,
                      margin_factor: float = 1.45, exact_topk: bool = False,
                      recall_target: float | None = None,
                      device="cuda") -> np.ndarray:
    """Block-centric kNN over *arbitrary* query points on ``device``:
    queries are bucketed into margin-sized spatial blocks on the host,
    and each block shares one candidate fetch. This is the at-scale path
    for point-cloud self-queries (the kNN-MAD filter's exact re-decide).
    Returns (Q, out_dim) numpy in query order.

    Selection is always exact: ``exact_topk`` is accepted for the JAX
    package's signature, and ``recall_target`` (its ``approx_min_k``
    mode) raises ``NotImplementedError``."""
    del exact_topk                       # every selection here is exact
    if recall_target is not None:
        raise NotImplementedError(
            "approx_min_k selection (recall_target) has no PyTorch "
            "counterpart and is not ported; the exact selection serves")
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    vals = np.asarray(values, np.float32)
    qrs = np.asarray(queries, np.float32)
    n = pts.shape[0]

    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    density = n / float(np.prod(extent))
    r_k = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    if cell_size is None:
        cell_size = max(r_k * margin_factor / 2.0, 1e-6)
    pts_dev = torch.as_tensor(pts, device=dev)
    cells = build_cell_list(pts_dev, cell_size=cell_size, device=dev)
    margin = r_k * margin_factor

    # block lattice over the query bbox, edge ≈ 2·margin
    block_edge = 2.0 * margin

    # clustered-cloud refinement: shrink cells until the candidate-row
    # capacity fits the 1024-row sentinel padding (capacity ~ cell_size²)
    for _ in range(6):
        mc_x = int(math.ceil((block_edge + 2 * margin) / cell_size)) + 1
        row_len = _row_capacity(cells, mc_x)
        if row_len <= _ROW_PAD:
            break
        cell_size *= min(math.sqrt(float(_ROW_PAD) / row_len) * 0.9, 0.7)
        if cell_size < 1e-9:
            break
        cells = build_cell_list(pts_dev, cell_size=cell_size, device=dev)
    else:
        row_len = _row_capacity(
            cells, int(math.ceil((block_edge + 2 * margin) / cell_size)) + 1)
    if row_len > _ROW_PAD:
        raise RowCapacityError(
            f"cell row capacity {row_len} exceeds the sorted-array padding "
            f"at every cell resolution tried — cloud too clustered for the "
            f"scatter-block kernel; use the generic kNN path")
    q_lo = qrs.min(axis=0)
    dims = np.maximum(np.ceil((qrs.max(axis=0) - q_lo) / block_edge
                              ).astype(int), 1)
    bidx = np.clip(((qrs - q_lo) / block_edge).astype(np.int64), 0, dims - 1)
    bid = (bidx[:, 2] * dims[1] + bidx[:, 1]) * dims[0] + bidx[:, 0]
    order = np.argsort(bid, kind="stable")
    sorted_bid = bid[order]
    # occupied blocks only
    uniq, inv_start = np.unique(sorted_bid, return_index=True)
    counts = np.diff(np.append(inv_start, len(sorted_bid)))
    b_cap = int(counts.max())
    n_blocks = len(uniq)
    q_table = np.full((n_blocks, b_cap), len(qrs), np.int64)
    rank = np.arange(len(sorted_bid)) - np.repeat(inv_start, counts)
    q_table[np.repeat(np.arange(n_blocks), counts), rank] = order
    # physical origin (x, y, z) of each occupied block, rounded to f32 as
    # the JAX package hands it to the device
    uz = uniq // (dims[1] * dims[0])
    uy = (uniq // dims[0]) % dims[1]
    ux = uniq % dims[0]
    block_origins = (q_lo[None, :]
                     + np.stack([ux, uy, uz], axis=-1) * block_edge)

    # static candidate-region dims for a block of edge block_edge + 2·margin
    mc = tuple(int(math.ceil((block_edge + 2 * margin) / cell_size)) + 1
               for _ in range(3))
    row_len = _row_capacity(cells, mc[2])

    queries_padded = torch.as_tensor(np.concatenate(
        [qrs, np.full((1, 3), 1e19, np.float32)]), device=dev)
    values_sorted = _sort_values(torch.as_tensor(vals, device=dev),
                                 cells.order)
    out = _scatter_block_eval(
        cells, values_sorted, queries_padded,
        torch.as_tensor(q_table, device=dev),
        torch.as_tensor(block_origins.astype(np.float32), device=dev),
        margin, k, mc, row_len, out_dim, consume_fn)
    # unscatter: out rows follow q_table order
    result = np.empty((len(qrs), out_dim), np.float32)
    flat_idx = q_table.reshape(-1)
    valid = flat_idx < len(qrs)
    result[flat_idx[valid]] = out.cpu().numpy()[valid]
    return result
