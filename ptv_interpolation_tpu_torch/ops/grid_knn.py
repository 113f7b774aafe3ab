"""Block-centric kNN evaluation over regular grids and scattered queries:
host setup, the streaming grid path, repair, the grid entry points and
the scatter-block path.

Counterpart of ``ptv_interpolation_tpu/ops/grid_knn.py``. Each grid block
of ``bz×by×bx`` nodes gathers the candidates of its dilated bounding box
once — ``mcz·mcy`` CSR rows of at most ``row_len`` points — and scores all
its nodes against them:

* :func:`_grid_block_weighted_sum` — the streaming one-phase path of
  ``backend='xla'``: per node the k-th-distance threshold τ (24 halvings
  of [0, margin²], or exact top-k), weights from a ``weight_fn`` over the
  τ mask, per-channel sums, and a coverage sentinel (``den == 0`` when
  fewer than k candidates lie within the margin);
* :func:`_grid_block_eval` / :func:`grid_knn_apply` — the exact top-k
  gather path that feeds a ``consume_fn`` (``exact_topk=True``);
* :func:`repair_empty_nodes` — the ladder that recomputes uncovered
  nodes: the fused repair, the cell-list CSR stage, then brute force;
* :func:`grid_weighted_interpolate` — the entry point that routes between
  the fused kernel (``ops/fused_grid_knn.py``), the one-phase kernel of
  ``backend='pallas'`` (``ops/pallas_grid_knn.py``) and the streaming
  path;
* :func:`scatter_knn_apply` — the scatter-block kNN over arbitrary query
  points.

Blocks are evaluated in chunks whose (blocks, B, C) panels stay bounded.
Selection is exact everywhere. The approximate modes (``tau_mode='approx'``,
``exact_topk=False``, ``recall_target``) are served by exact selection:
off the TPU ``approx_min_k`` is an exact sort, whose values the exact
path gives bit for bit (only its order among tied distances differs),
and exact selection meets any recall target.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.grid import Grid
from ptv_interpolation_tpu_torch.ops.neighbors import (CellList,
                                                       build_cell_list,
                                                       cell_meta_np)
from ptv_interpolation_tpu_torch.utils import count, span, tracing, wait

_ROW_PAD = 1024   # sentinel rows after the sorted arrays bound a row's length
_BIG = 3.4e38     # sentinel squared distance of an empty candidate slot
_SCATTER_ELEMS = 1 << 24   # bound on (blocks × b_cap × C) distance panels
_PANEL_ELEMS = 1 << 24     # bound on (blocks × B × C) panels of the grid paths
_BISECT_ITERS = 24
_BRUTE_CHUNK = 131072      # queries per brute-force repair chunk


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
    with wait("row_capacity"):
        return max(int(windows.max().item()), 1)


def _host_setup(points, values, grid: Grid, k: int, block, margin_factor,
                cell_divisor: float = 2.0, device="cuda",
                cells: CellList | None = None,
                cell_size: float | None = None):
    """Shared setup: cell list, margin, static candidate-region dimensions
    ``mc = (mcz, mcy, mcx)`` in cells, row capacity, padded axes and
    cell-sorted values. Auto cell edge = margin / ``cell_divisor`` (the
    fused path passes 3) unless ``cell_size`` is given; a prebuilt
    ``cells`` (on ``device``) is used as it is, its origin standing for
    the cloud's low corner.

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
    with wait("bounds"):
        hi = pts.amax(dim=0).cpu().numpy()
    if cells is None:
        with wait("bounds"):
            lo = pts.amin(dim=0).cpu().numpy()
    else:
        if cells.device != pts.device:   # 'cuda' and 'cuda:0' are one
            raise ValueError(f"cells live on {cells.device}, not on "
                             f"{pts.device}")
        lo, inv_c = cell_meta_np(cells)
        cell_size = 1.0 / inv_c
    extent = np.maximum(hi - lo, 1e-12)
    density = n / float(np.prod(extent))
    r_k = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    if cells is None:
        if cell_size is None:
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


# ---------------------------------------------------------------------------
# Per-block candidate regions
# ---------------------------------------------------------------------------

def _block_rows(cells: CellList, lo: torch.Tensor, m32: torch.Tensor,
                mc: Tuple[int, int, int]):
    """For blocks whose low corners are ``lo`` ((g, 3) f32 x, y, z), the
    CSR ranges of their candidate regions: ``(start, cnt)``, each (g, R)
    int64 with R = mcz·mcy rows of ``mcx`` cells starting ``margin``
    (``m32``, an f32 scalar tensor) below the corner. Rows outside the
    cell grid are empty (start 0, count 0)."""
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    dev = cells.device
    roz = torch.arange(mcz, dtype=torch.int32,
                       device=dev).repeat_interleave(mcy)
    roy = torch.arange(mcy, dtype=torch.int32, device=dev).repeat(mcz)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    # f32, in the JAX package's op order: ((lo - margin) - origin) * inv
    base = torch.floor(((lo - m32) - cells.origin)
                       * cells.inv_cell).to(torch.int32)           # (g, 3)
    cz = base[:, 2:3] + roz
    cy = base[:, 1:2] + roy                                        # (g, R)
    row_ok = (cz >= 0) & (cz < ncz) & (cy >= 0) & (cy < ncy)
    x0 = base[:, 0:1].clamp(0, ncx)
    x1 = (base[:, 0:1] + mcx).clamp(0, ncx)
    rid = (cz * ncy + cy) * ncx
    start = torch.where(row_ok,
                        cells.starts[torch.where(row_ok, rid + x0, zero)],
                        zero).long()
    end = torch.where(row_ok,
                      cells.starts[torch.where(row_ok, rid + x1, zero)],
                      zero).long()
    return start, end - start


def _block_queries(axes, block: Tuple[int, int, int], nby: int, nbx: int,
                   ids: torch.Tensor):
    """Node coordinates of the blocks ``ids`` (flat block indices): three
    (n, B) f32 tensors x, y, z, nodes in local (z, y, x) order, read from
    the padded ``axes`` tensors. Also the blocks' low corners (n, 3)."""
    bz, by, bx = block
    x_ax, y_ax, z_ax = axes
    dev = x_ax.device
    ibz = ids // (nby * nbx)
    iby = (ids // nbx) % nby
    ibx = ids % nbx
    t = torch.arange(bz * by * bx, device=dev)
    qx = x_ax[ibx[:, None] * bx + (t % bx)[None, :]]
    qy = y_ax[iby[:, None] * by + ((t // bx) % by)[None, :]]
    qz = z_ax[ibz[:, None] * bz + (t // (by * bx))[None, :]]
    lo = torch.stack([x_ax[ibx * bx], y_ax[iby * by], z_ax[ibz * bz]], dim=1)
    return qx, qy, qz, lo


def _axes_tensors(axes, device):
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in axes)


def _block_panels(cells: CellList, values_sorted: torch.Tensor, axes_t,
                  m32: torch.Tensor, ids: torch.Tensor,
                  block: Tuple[int, int, int], nb: Tuple[int, int, int],
                  mc: Tuple[int, int, int], row_len: int):
    """The candidate panels of the blocks ``ids``: node coordinates q
    (g, B, 3), candidate points (g, C, 3) and values (g, C, V) — R row
    slices of ``row_len`` sorted rows each, C = R·row_len — their valid
    mask (g, C) and d² (g, B, C), ``_BIG`` at invalid slots. d² is summed
    as ``((dx·dx + dy·dy) + dz·dz)``, the JAX package's order."""
    qx, qy, qz, lo = _block_queries(axes_t, block, nb[1], nb[2], ids)
    start, cnt = _block_rows(cells, lo, m32, mc)
    g, R = start.shape
    lane = torch.arange(row_len, device=cells.device)
    idx = (start[:, :, None] + lane).reshape(g, R * row_len)
    valid = (lane < cnt[:, :, None]).reshape(g, R * row_len)
    cand = cells.points_sorted[idx]
    vals = values_sorted[idx]
    d = qx[:, :, None] - cand[:, None, :, 0]
    d2 = d * d
    d = qy[:, :, None] - cand[:, None, :, 1]
    d2 = d2 + d * d
    d = qz[:, :, None] - cand[:, None, :, 2]
    d2 = d2 + d * d
    d2 = torch.where(valid[:, None, :], d2, _BIG)
    q = torch.stack([qx, qy, qz], dim=-1)
    return q, cand, vals, valid, d2


def _block_chunks(n: int, B: int, C: int):
    step = max(1, _PANEL_ELEMS // (B * C))
    return range(0, n, step), step


def _bisect_tau2(d2: torch.Tensor, kk: int, hi: torch.Tensor) -> torch.Tensor:
    """τ² by 24 halvings of [0, hi] on the count #{d² ≤ mid} < kk (→ lo),
    along the last axis of ``d2``; ``hi`` is an f32 scalar tensor."""
    lo = torch.zeros_like(d2[..., :1])
    hi = hi.expand_as(lo)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        short = (d2 <= mid).sum(dim=-1, keepdim=True) < kk
        lo = torch.where(short, mid, lo)
        hi = torch.where(short, hi, mid)
    return hi


def _topk_slot_order(d2: torch.Tensor, kk: int):
    """The kk smallest of each row of ``d2`` (rows, C), ascending, with
    ties in slot order as ``lax.top_k`` gives them: ``(sq, args)``."""
    sq, args = torch.topk(d2, kk, dim=-1, largest=False)
    args, perm = torch.sort(args, dim=-1)
    sq, perm2 = torch.sort(torch.gather(sq, -1, perm), dim=-1, stable=True)
    return sq, torch.gather(args, -1, perm2)


# ---------------------------------------------------------------------------
# The streaming weighted-sum path
# ---------------------------------------------------------------------------

def _weighted_block_sum(cells: CellList, values_sorted: torch.Tensor, axes,
                        margin, ids: torch.Tensor, k: int,
                        block: Tuple[int, int, int],
                        nb: Tuple[int, int, int], mc: Tuple[int, int, int],
                        row_len: int, weight_fn: Callable,
                        tau_mode: str) -> torch.Tensor:
    """The weighted sums of the blocks ``ids``: (n_ids, B, V+1) with
    ``Σw·v / max(Σw, 1e-37)`` per channel and ``Σw`` in the last column
    where the node is covered (≥ min(k, C) candidates within the margin),
    0 where it is not. ``margin`` is taken as an f32 value; τ² is bisected
    on [0, margin²] (``tau_mode='bisect'``) or is the exact k-th distance²
    clamped to margin² where covered (``'exact'``). ``weight_fn(d, mask,
    sq_topk)`` gets (rows, C) panels (``sq_topk`` None when bisecting)."""
    bz, by, bx = block
    B = bz * by * bx
    C = mc[0] * mc[1] * row_len
    kk = min(k, C)
    V = values_sorted.shape[1]
    dev = cells.device
    m32 = torch.tensor(np.float32(margin), device=dev)
    m2 = m32 * m32
    axes_t = _axes_tensors(axes, dev)
    out = torch.empty((ids.shape[0], B, V + 1), dtype=torch.float32,
                      device=dev)
    starts, step = _block_chunks(ids.shape[0], B, C)
    for s in starts:
        _, _, vals, valid, d2 = _block_panels(
            cells, values_sorted, axes_t, m32, ids[s:s + step], block, nb,
            mc, row_len)
        g = d2.shape[0]
        d2 = d2.reshape(g * B, C)
        valid = valid[:, None, :].expand(g, B, C).reshape(g * B, C)
        covered = (d2 <= m2).sum(dim=-1, keepdim=True) >= kk
        if tau_mode == "bisect":
            sq_topk = None
            tau2 = _bisect_tau2(d2, kk, m2)
        else:
            sq_topk = torch.topk(d2, kk, dim=-1, largest=False).values
            tau2 = torch.minimum(sq_topk[:, -1:],
                                 torch.where(covered, m2, _BIG))
        mask = (d2 <= tau2) & valid
        d = torch.sqrt(torch.clamp_min(d2, 0.0))
        w = torch.where(mask, weight_fn(d, mask, sq_topk), 0.0).reshape(
            g, B, C)
        den = w.sum(dim=-1)
        inv = 1.0 / torch.clamp_min(den, 1e-37)
        for c in range(V):
            out[s:s + g, :, c] = (w * vals[:, None, :, c]).sum(dim=-1) * inv
        out[s:s + g, :, V] = torch.where(covered.reshape(g, B), den, 0.0)
    return out


def _tau_mode(tau_mode: str, exact_tau: bool) -> str:
    """The selection path, ``'bisect'`` or ``'exact'``: ``'approx'``
    (``approx_min_k``) takes the exact one, τ² = min(k-th d², margin²)
    where covered, as the JAX package forms it for both modes."""
    mode = "exact" if exact_tau else tau_mode
    if mode not in ("bisect", "exact", "approx"):
        raise ValueError(f"unknown tau_mode {tau_mode!r}")
    return "bisect" if mode == "bisect" else "exact"


def _reassemble_blocks(rows: torch.Tensor, block: Tuple[int, int, int],
                       grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(n_blocks, B, ·) rows of every block → (nz, ny, nx, ·) node order."""
    bz, by, bx = block
    nz, ny, nx = grid_shape
    nbz, nby, nbx = (_block_counts(nz, bz), _block_counts(ny, by),
                     _block_counts(nx, bx))
    o = rows.reshape(nbz, nby, nbx, bz, by, bx, -1)
    o = o.permute(0, 3, 1, 4, 2, 5, 6)
    o = o.reshape(nbz * bz, nby * by, nbx * bx, -1)
    return o[:nz, :ny, :nx]


def _grid_block_weighted_sum(cells: CellList, values_sorted: torch.Tensor,
                             axes, margin, k: int,
                             block: Tuple[int, int, int],
                             grid_shape: Tuple[int, int, int],
                             mc: Tuple[int, int, int], row_len: int,
                             weight_fn: Callable, exact_tau: bool = False,
                             tau_mode: str = "bisect"):
    """The streaming weighted-sum path over every grid block: returns
    ``(out, den)``, (nz, ny, nx, V) and (nz, ny, nx), with ``den == 0``
    at the nodes the coverage sentinel flags for repair.

    ``tau_mode``: ``'bisect'`` (τ² by 24 halvings of [0, margin²]) or
    ``'exact'`` (top-k; ``exact_tau=True`` is the same); ``'approx'``
    takes the exact path."""
    mode = _tau_mode(tau_mode, exact_tau)
    nz, ny, nx = grid_shape
    bz, by, bx = block
    nb = (_block_counts(nz, bz), _block_counts(ny, by),
          _block_counts(nx, bx))
    ids = torch.arange(nb[0] * nb[1] * nb[2], device=cells.device)
    rows = _weighted_block_sum(cells, values_sorted, axes, margin, ids, k,
                               block, nb, mc, row_len, weight_fn, mode)
    out = _reassemble_blocks(rows, block, grid_shape)
    V = values_sorted.shape[1]
    return out[..., :V], out[..., V]


def _grid_block_weighted_sum_subset(cells: CellList,
                                    values_sorted: torch.Tensor, axes,
                                    margin, ids, k: int,
                                    block: Tuple[int, int, int],
                                    grid_shape: Tuple[int, int, int],
                                    mc: Tuple[int, int, int], row_len: int,
                                    weight_fn: Callable) -> torch.Tensor:
    """The bisect-τ weighted sum over a subset of grid blocks (``ids``:
    flat block indices): returns (n_ids, B, V+1) in ``ids`` order — the
    widened-margin repair's evaluator where kernel 1's panel is too
    wide."""
    nz, ny, nx = grid_shape
    bz, by, bx = block
    nb = (_block_counts(nz, bz), _block_counts(ny, by),
          _block_counts(nx, bx))
    ids = torch.as_tensor(ids, dtype=torch.int64, device=cells.device)
    return _weighted_block_sum(cells, values_sorted, axes, margin, ids, k,
                               block, nb, mc, row_len, weight_fn, "bisect")


def _generic_knn_fallback(points, values, queries, mode: str, power: float,
                          k: int, device="cuda") -> torch.Tensor:
    """Exact per-query interpolation through brute-force kNN with the
    caller's ``k`` — for nodes, or whole clouds, the block paths cannot
    serve."""
    from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
        idw_interpolate, sibson_interpolate)
    k = min(k, int(points.shape[0]))
    if mode == "idw":
        return idw_interpolate(points, values, queries, k=k, power=power,
                               device=device)
    return sibson_interpolate(points, values, queries, k=k, device=device)


# ---------------------------------------------------------------------------
# Repair
# ---------------------------------------------------------------------------

def _celllist_repair_eval(cells: CellList, values: torch.Tensor,
                          queries: torch.Tensor, k: int, rings: int,
                          mode: str, power: float, guard_radius,
                          query_tile: int = 512):
    """IDW/sibson at ``queries`` over the exact k nearest of each one's
    ``(2·rings+1)³`` cell neighbourhood (the generic search,
    :func:`~ptv_interpolation_tpu_torch.ops.neighbors.celllist_tile_fn`,
    with original point ids), plus a coverage certificate.

    Returns ``(vals, good)``: (Q, V) weighted sums and (Q,) bool, True iff
    the k-th neighbour is a point within ``guard_radius`` (taken as an
    f32 value) — then the neighbourhood provably holds the true k-set.
    The stage :func:`repair_empty_nodes` takes when no cell-sorted values
    are given."""
    from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
        _gather_rows, _idw_weights, _sibson_weights)
    from ptv_interpolation_tpu_torch.ops.neighbors import (celllist_tile_fn,
                                                           map_query_tiles)
    neighbor = celllist_tile_fn(cells, k, rings, exact_topk=True)
    g32 = torch.tensor(np.float32(guard_radius), device=cells.device)

    def tile(q_tile):
        sq, idx = neighbor(q_tile)
        ok = idx >= 0
        dist = torch.sqrt(torch.clamp_min(torch.where(ok, sq, 1.0), 0.0))
        good = ok[:, -1] & (dist[:, -1] <= g32)
        w = (_idw_weights(dist, power, ok) if mode == "idw"
             else _sibson_weights(dist, ok))
        vals = _gather_rows(values, idx)                      # (T, k, V)
        return (w[..., None] * vals).sum(dim=1), good

    return map_query_tiles(tile, queries, query_tile)


def _celllist_repair_eval_csr(cells: CellList, values_sorted: torch.Tensor,
                              queries: torch.Tensor, k: int, rings: int,
                              mode: str, power: float, guard_radius,
                              query_tile: int = 512):
    """IDW/sibson at ``queries`` over each one's ``(2·rings+1)³`` cell
    neighbourhood in the CSR layout, with a coverage certificate.

    Returns ``(vals, good)``: (Q, V) weighted sums and (Q,) bool, True iff
    at least min(k, n_cand) candidates lie within ``guard_radius`` (taken
    as an f32 value) — then the neighbourhood provably holds the true
    k-set. τ² is bisected (24 halvings of [0, guard²]), as in the block
    paths."""
    from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
        _idw_panel_weights, _sibson_panel_weights)
    from ptv_interpolation_tpu_torch.ops.neighbors import (
        csr_candidate_panel, map_query_tiles)
    n_offsets = (2 * rings + 1) ** 3
    kk = min(k, n_offsets * cells.cap)
    weight_fn = (_idw_panel_weights(power) if mode == "idw"
                 else _sibson_panel_weights())
    g32 = torch.tensor(np.float32(guard_radius), device=cells.device)
    g2 = g32 * g32
    V = values_sorted.shape[1]

    def tile(q_tile):
        cand, d2 = csr_candidate_panel(cells, q_tile, rings)
        good = (d2 <= g2).sum(dim=1) >= kk
        tau2 = _bisect_tau2(d2, kk, g2)
        mask = d2 <= tau2
        d = torch.sqrt(torch.clamp_min(d2, 0.0))
        w = torch.where(mask, weight_fn(d, mask, None), 0.0)
        vals = values_sorted[cand]         # sentinel rows gather zeros
        num = torch.stack([(w * vals[..., c]).sum(dim=1) for c in range(V)],
                          dim=1)
        den = w.sum(dim=1, keepdim=True)
        return num / torch.clamp_min(den, 1e-37), good

    return map_query_tiles(tile, queries, query_tile)


def repair_empty_nodes(out, den, points, values, grid: Grid, k: int,
                       mode: str, power: float = 2.0,
                       cells: CellList | None = None,
                       margin: float | None = None, skip_mask=None,
                       values_sorted=None, block=None):
    """Recompute the nodes the block kernels could not serve exactly —
    they arrive with ``den == 0`` (the coverage sentinel) — down a ladder
    of stages, in the JAX package's order:

    1. ``fused_repair``: the blocks holding uncovered nodes at 1.6× the
       margin, through kernel 1 or, where its panel is too wide, the
       streaming subset evaluator; what it cannot certify goes straight
       to brute force (step 3). It declines when the uncovered blocks are
       many for the nodes (``n_blocks·B > max(32·n_fix, 64·B)``), or when
       neither evaluator fits;
    2. when it declines, the cell-list stage: each node's
       ``(2·rings+1)³`` cell neighbourhood at a guard radius of
       ``rings·cell_size`` ≥ 1.6× the margin (``rings ≤ 6`` and at most
       16 384 candidates per node) — τ² bisected over the CSR panel
       (:func:`_celllist_repair_eval_csr`) when ``values_sorted`` is
       given, else the exact k nearest of the generic search
       (:func:`_celllist_repair_eval`, the JAX package's table form);
    3. exact brute force against the whole cloud for the rest, in chunks
       of 131 072 nodes.

    Stage 1 needs ``cells``, ``margin``, ``values_sorted`` and ``block``;
    stage 2 ``cells`` and ``margin``. Every cell list of the port serves
    the table form: the JAX package's dense per-cell table holds the CSR
    panel's candidates in its slot order. ``out``: (nz, ny, nx, V) and
    ``den``: (nz, ny, nx) tensors on one device; ``skip_mask`` (True =
    skip) excludes nodes the caller overwrites anyway. The CUDA device
    runs the kernels, the CPU their plain versions. Returns the repaired
    (nz, ny, nx, V) field.

    It runs in the span ``ptv.grid.repair`` and each stage that runs in
    ``ptv.grid.repair.<stage>``; the counter ``repair.uncovered`` counts
    the uncovered nodes and ``repair.<stage>`` the nodes each stage that
    ran served (``fused``, ``celllist``, ``bruteforce``)."""
    with span("ptv.grid.repair"):
        return _repair_ladder(out, den, points, values, grid, k, mode, power,
                              cells, margin, skip_mask, values_sorted, block)


def _repair_ladder(out, den, points, values, grid: Grid, k: int, mode: str,
                   power: float, cells, margin, skip_mask, values_sorted,
                   block):
    """The body of :func:`repair_empty_nodes`."""
    from ptv_interpolation_tpu_torch.ops import fused_grid_knn as fg
    dev = out.device
    skip = (None if skip_mask is None else
            torch.as_tensor(skip_mask, dtype=torch.bool, device=dev))

    def uncovered(den):
        den_zero = den == 0.0
        if skip is not None:
            den_zero &= ~skip
        with wait("repair.uncovered"):
            return torch.nonzero(den_zero.reshape(-1)).squeeze(1)

    flat = uncovered(den)
    count("repair.uncovered", flat.numel())
    if flat.numel() == 0:
        return out
    ladder = cells is not None and margin is not None
    if ladder and block is not None and values_sorted is not None:
        with span("ptv.grid.repair.fused"):
            res = fg.fused_repair(out, den, skip_mask, cells, values_sorted,
                                  grid, k, mode, power, tuple(block),
                                  float(margin))
        if res is not None:
            out, den, n_left = res
            count("repair.fused", flat.numel() - n_left)
            if n_left == 0:
                return out
            # the widened margin could not certify these: brute force
            flat = uncovered(den)
            ladder = False

    n_fix = flat.numel()
    nz, ny, nx = den.shape
    V = out.shape[-1]
    iz, iy, ix = flat // (ny * nx), (flat // nx) % ny, flat % nx
    axes = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (grid.x, grid.y, grid.z)]
    queries = torch.stack([axes[0][ix], axes[1][iy], axes[2][iz]], dim=-1)
    kk = min(k, int(points.shape[0]))
    fixed = out.new_empty((n_fix, V))
    todo = torch.arange(n_fix, device=dev)

    if ladder:
        cell_size = 1.0 / cell_meta_np(cells)[1]
        rings = int(math.ceil(fg.REPAIR_MARGIN_FACTOR * float(margin)
                              / cell_size))
        n_cand = (2 * rings + 1) ** 3 * cells.cap
        # a per-node panel of n_cand candidates, bounded as the JAX
        # package bounds it; bigger neighbourhoods go to brute force,
        # which streams the points instead
        if rings <= 6 and n_cand <= 16384:
            with span("ptv.grid.repair.celllist"):
                if values_sorted is not None:
                    vals_cl, good = _celllist_repair_eval_csr(
                        cells, values_sorted, queries, kk, rings, mode,
                        float(power), rings * cell_size, query_tile=256)
                else:
                    vals_cl, good = _celllist_repair_eval(
                        cells, as_f32(values, dev), queries, kk, rings, mode,
                        float(power), rings * cell_size, query_tile=256)
                fixed[good] = vals_cl[good]
                todo = todo[~good]
                count("repair.celllist", good.sum())

    if todo.numel():
        _repair_bruteforce(points, values, queries, todo, fixed, kk, mode,
                           power, nz * ny * nx, dev)

    out = out.reshape(-1, V).clone()
    out[flat] = fixed
    return out.reshape(den.shape + (V,))


def _repair_bruteforce(points, values, queries, todo, fixed, kk: int,
                       mode: str, power: float, n_nodes: int, dev):
    """Stage 3 of :func:`repair_empty_nodes`: exact brute force for the
    nodes ``todo``, written into ``fixed``."""
    with span("ptv.grid.repair.bruteforce"):
        if todo.numel() > 0.01 * n_nodes:
            print(f"[grid_knn] repairing {todo.numel()}/{n_nodes} uncovered "
                  f"grid nodes ({100.0 * todo.numel() / n_nodes:.1f}%) "
                  f"through the exact brute-force path — the point cloud "
                  f"has large voids relative to the kNN margin")
        from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
            idw_interpolate, sibson_interpolate)
        for s in range(0, todo.numel(), _BRUTE_CHUNK):
            sel = todo[s:s + _BRUTE_CHUNK]
            if mode == "idw":
                part = idw_interpolate(points, values, queries[sel], k=kk,
                                       power=power, device=dev)
            else:
                part = sibson_interpolate(points, values, queries[sel], k=kk,
                                          device=dev)
            fixed[sel] = part
        count("repair.bruteforce", todo.numel())


# ---------------------------------------------------------------------------
# Grid entry points
# ---------------------------------------------------------------------------

def grid_weighted_interpolate(points, values, grid: Grid, k: int,
                              weight_fn: Callable,
                              cells: CellList | None = None,
                              cell_size: float | None = None,
                              block: Tuple[int, int, int] | None = None,
                              margin_factor: float = 1.45,
                              recall_target: float = 0.9,
                              backend: str = "auto", mode: str = "sibson",
                              power: float = 2.0, exact_tau: bool = False,
                              tau_mode: str = "bisect", skip_mask=None,
                              device="cuda") -> torch.Tensor:
    """IDW/sibson onto ``grid`` on ``device``; returns an (nz, ny, nx, V)
    tensor there.

    ``backend`` selects the formulation:

    * ``'auto'``: the fused two-phase kernel (``ops/fused_grid_knn.py``)
      when ``weight_fn`` is the canned formula for ``mode``
      (``knn_weights._idw_panel_weights`` / ``_sibson_panel_weights``),
      ``tau_mode='bisect'`` and no prebuilt ``cells`` is given; the
      streaming path otherwise, and when the fused panel is too wide
      (``FusedCapacityError``) or no cell size fits (``RowCapacityError``);
    * ``'fused'``: the fused kernel, no fallback;
    * ``'xla'``: the streaming one-phase path (:func:`_grid_block_weighted_sum`);
    * ``'pallas'``: the one-phase kernel of ``ops/pallas_grid_knn.py``
      with its own defaults (block (2, 8, 8), 14 halvings, no repair);
      ``block``, ``skip_mask`` and the τ options are ignored.

    ``tau_mode``: ``'bisect'`` or ``'exact'`` (``exact_tau=True``);
    ``'approx'`` takes the exact selection, which meets any
    ``recall_target``. When no cell resolution fits the block paths' row
    capacity (e.g. >1024 coincident points), the whole grid goes through
    exact brute-force kNN."""
    del recall_target                    # every selection here is exact
    if block is None:
        block = (4, 8, 16) if skip_mask is not None else (8, 8, 16)
    if backend == "pallas":
        from ptv_interpolation_tpu_torch.ops.pallas_grid_knn import (
            pallas_grid_weighted_interpolate)
        return pallas_grid_weighted_interpolate(
            points, values, grid, k, mode=mode, power=power,
            margin_factor=margin_factor, device=device)
    if backend not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    canned = getattr(weight_fn, "canned_mode", None) == mode
    if backend == "fused" and not canned:
        raise ValueError(
            "backend='fused' computes its own idw/sibson weights and "
            "cannot honor a custom weight_fn; use backend='xla'")
    if backend == "fused" and (exact_tau or tau_mode != "bisect"):
        raise ValueError(
            "backend='fused' implements tau_mode='bisect' only; use "
            "backend='xla' for approx/exact selection modes")
    _tau_mode(tau_mode, exact_tau)
    if backend == "fused" or (
            backend == "auto" and canned and tau_mode == "bisect"
            and not exact_tau and cells is None
            and mode in ("idw", "sibson")):
        from ptv_interpolation_tpu_torch.ops.fused_grid_knn import (
            FusedCapacityError, fused_grid_weighted_interpolate)
        try:
            return fused_grid_weighted_interpolate(
                points, values, grid, k, mode=mode, power=power, block=block,
                margin_factor=margin_factor, skip_mask=skip_mask,
                device=device)
        except (FusedCapacityError, RowCapacityError):
            if backend == "fused":
                raise
    dev = resolve_device(device)
    try:
        with span("ptv.grid.prepare"), span("ptv.grid.cells"):
            setup = _host_setup(points, values, grid, k, block,
                                margin_factor, device=dev, cells=cells,
                                cell_size=cell_size)
    except RowCapacityError:
        out = _generic_knn_fallback(points, values, grid.flat_coords(dev),
                                    mode, power, k, device=dev)
        return out.reshape(grid.shape + (-1,))
    cells, values_sorted, axes, margin, mc, row_len, vals = setup
    out, den = _grid_block_weighted_sum(cells, values_sorted, axes, margin, k,
                                        tuple(block), grid.shape, mc,
                                        row_len, weight_fn, exact_tau,
                                        tau_mode)
    return repair_empty_nodes(out, den, as_f32(points, dev), vals, grid, k,
                              mode, power, cells=cells, margin=margin,
                              skip_mask=skip_mask,
                              values_sorted=values_sorted, block=block)


def _grid_block_eval(cells: CellList, values_sorted: torch.Tensor, axes,
                     margin, k: int, block: Tuple[int, int, int],
                     grid_shape: Tuple[int, int, int],
                     mc: Tuple[int, int, int], row_len: int, out_dim: int,
                     consume_fn: Callable,
                     needs_positions: bool = True) -> torch.Tensor:
    """Exact top-k of every grid node among its block's candidates, fed
    to ``consume_fn(sq, n_pos, n_val, n_ok, q)`` on (rows, kk[, ·])
    batches (``n_pos`` None unless ``needs_positions``); returns
    (nz, ny, nx, out_dim). Ties come in slot order, as ``lax.top_k``
    orders them.

    While tracing, counts ``knn.uncovered``: the grid nodes whose last
    selected d² exceeds margin², whose k-set the region does not
    certify (a nearer point may lie outside it)."""
    nz, ny, nx = grid_shape
    bz, by, bx = block
    nb = (_block_counts(nz, bz), _block_counts(ny, by),
          _block_counts(nx, bx))
    B = bz * by * bx
    C = mc[0] * mc[1] * row_len
    kk = min(k, C)
    dev = cells.device
    m32 = torch.tensor(np.float32(margin), device=dev)
    axes_t = _axes_tensors(axes, dev)
    ids = torch.arange(nb[0] * nb[1] * nb[2], device=dev)
    out = torch.empty((ids.shape[0] * B, out_dim), dtype=torch.float32,
                      device=dev)
    far = (torch.empty(ids.shape[0] * B, dtype=torch.bool, device=dev)
           if tracing() else None)
    starts, step = _block_chunks(ids.shape[0], B, C)
    for s in starts:
        q, cand, vals, valid, d2 = _block_panels(
            cells, values_sorted, axes_t, m32, ids[s:s + step], block, nb,
            mc, row_len)
        g = d2.shape[0]
        sq, args = _topk_slot_order(d2.reshape(g * B, C), kk)
        if far is not None:
            far[s * B:(s + g) * B] = sq[:, -1] > m32 * m32
        args = args.reshape(g, B * kk)
        n_val = torch.gather(vals, 1, args[..., None].expand(
            g, B * kk, vals.shape[-1])).reshape(g * B, kk, -1)
        n_ok = torch.gather(valid, 1, args).reshape(g * B, kk) & (sq < _BIG)
        n_pos = (torch.gather(cand, 1, args[..., None].expand(g, B * kk, 3))
                 .reshape(g * B, kk, 3) if needs_positions else None)
        out[s * B:(s + g) * B] = consume_fn(sq, n_pos, n_val, n_ok,
                                            q.reshape(g * B, 3))
    if far is not None:          # padded nodes beyond the grid left out
        count("knn.uncovered", _reassemble_blocks(
            far.reshape(-1, B, 1), block, grid_shape).sum())
    return _reassemble_blocks(out.reshape(-1, B, out_dim), block, grid_shape)


def grid_knn_apply(points, values, grid: Grid, k: int, consume_fn: Callable,
                   out_dim: int, cells: CellList | None = None,
                   cell_size: float | None = None,
                   block: Tuple[int, int, int] = (8, 8, 8),
                   margin_factor: float = 1.45, exact_topk: bool = False,
                   recall_target: float = 0.99, needs_positions: bool = True,
                   device="cuda") -> torch.Tensor:
    """Evaluate ``consume_fn`` on the k nearest ``points`` of every grid
    node on ``device``: ``consume_fn(sq_dists, neighbor_pos,
    neighbor_vals, valid, q)`` maps a (rows, k[, ·]) neighbourhood batch to
    (rows, out_dim); returns (nz, ny, nx, out_dim).

    The cell size makes each block's candidate region cover the expected
    k-th-neighbour radius times ``margin_factor``; nodes whose true k-set
    reaches beyond it get the k nearest of the region. Selection is
    exact: ``exact_topk=False`` (``approx_min_k`` at ``recall_target``) is
    served by the same top-k, ties in slot order."""
    del exact_topk, recall_target        # every selection here is exact
    cells, values_sorted, axes, margin, mc, row_len, _ = _host_setup(
        points, values, grid, k, block, margin_factor, device=device,
        cells=cells, cell_size=cell_size)
    return _grid_block_eval(cells, values_sorted, axes, margin, k,
                            tuple(block), grid.shape, mc, row_len, out_dim,
                            consume_fn, needs_positions)


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
        sq, args = _topk_slot_order(d2, kk)
        del d2
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
                      recall_target: float = 0.99,
                      device="cuda") -> np.ndarray:
    """Block-centric kNN over *arbitrary* query points on ``device``:
    queries are bucketed into margin-sized spatial blocks on the host,
    and each block shares one candidate fetch. This is the at-scale path
    for point-cloud self-queries (the kNN-MAD filter's exact re-decide).
    Returns (Q, out_dim) numpy in query order.

    Selection is always exact: ``exact_topk`` and ``recall_target`` (the
    JAX package's ``approx_min_k`` mode) are accepted for its signature."""
    del exact_topk, recall_target        # every selection here is exact
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
