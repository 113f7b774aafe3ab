"""SPMD execution of the interpolation paths over a mesh of ranks.

Counterpart of ``ptv_interpolation_tpu/parallel/sharding.py``. Every rank
of the mesh calls the same function with the same arguments; each
computes its share and every rank returns the whole result.

* **Query sharding** (:func:`sharded_interpolate_values`): the particle
  set (and a cell list, if given) is whole on every rank; each rank runs
  the neighbour-and-weights tile loop over its share of the query tiles,
  and an all-gather joins the shares along the query axis.

* **Z-slab sharding of the grid and of the candidate store**
  (:func:`sharded_grid_interpolate`): the grid is cut into one z-slab per
  rank and each rank keeps only the slab-plus-halo window of the
  cell-sorted particle store (``parallel/slab_store.py``), ≈ ``total/n +
  halo`` rows. Each rank runs the fused kernel (kernel 1,
  ``ops/csrc/fused_grid_knn.cu``) or the streaming path over its slab
  from its window, then repairs its own uncovered blocks at the widened
  margin from the same window; the slabs are all-gathered, and only
  far-field voids go to the global repair ladder.

* **The pipeline step** (:func:`make_pipeline_step`): query-sharded IDW
  onto the grid, mask zeroing and z-sharded projection cleaning
  (``physics.py``, ``parallel/halo.py``).

Host decisions that steer a collective are taken from gathered data, so
that every rank takes them alike: the repair's eligibility from every
rank's survey, and the count of nodes left for the global ladder from
every rank's repaired count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.grid import Grid
from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
    _idw_weights,
    _sibson_weights,
    _weighted_tile,
    idw_interpolate,
)
from ptv_interpolation_tpu_torch.ops.neighbors import (
    _PAD_ROWS,
    _SENTINEL,
    CellList,
    bruteforce_tile_fn,
    celllist_tile_fn,
    map_query_tiles,
)
from ptv_interpolation_tpu_torch.parallel.mesh import Mesh, all_gather_cat


def _bcount(n: int, b: int) -> int:
    return (n + b - 1) // b


def _gather_rows(mesh: Mesh, part: torch.Tensor, rows: int) -> torch.Tensor:
    """Every rank's ``part`` (≤ ``rows`` rows; padded with zero rows to
    ``rows`` for the collective), joined in rank order."""
    if part.shape[0] < rows:
        pad = part.new_zeros((rows - part.shape[0],) + tuple(part.shape[1:]))
        part = torch.cat([part, pad])
    return all_gather_cat(mesh, part)


def sharded_interpolate_values(points, values, queries, mesh: Mesh,
                               method: str = "idw", k: int = 50,
                               power: float = 2.0,
                               cells: Optional[CellList] = None,
                               rings: int = 1, query_tile: int = 1024,
                               point_chunk: int = 4096):
    """Interpolate with queries sharded over ``mesh`` (the kNN methods);
    returns (Q, C) on the mesh's device, on every rank.

    Points and values (and ``cells``, if given, on the mesh's device) are
    whole on every rank. The queries are cut into tiles of ``query_tile``
    and each rank takes a contiguous run of whole tiles, so every query
    sees the tile it sees in the single-device call with the same
    ``query_tile`` — the brute-force search centres each tile on its mean
    — and its result is that call's, bit for bit. Unlike the JAX package,
    which pads the queries to ``n·query_tile``, only the per-rank
    results are padded, for the all-gather."""
    if method == "idw":
        weight_fn = lambda d, ok: _idw_weights(d, power, ok)  # noqa: E731
    elif method == "sibson":
        weight_fn = _sibson_weights
    else:
        raise ValueError(f"sharded interpolation supports kNN methods, "
                         f"got {method!r}")
    dev = mesh.device
    pts = as_f32(points, dev)
    vals = as_f32(values, dev)
    qs = as_f32(queries, dev)
    n_q = qs.shape[0]
    n_tiles = _bcount(n_q, query_tile)
    rows = _bcount(n_tiles, mesh.size) * query_tile
    lo = min(mesh.rank * rows, n_q)
    q_shard = qs[lo:lo + rows]
    if cells is not None:
        neighbor = celllist_tile_fn(cells, k, rings)
    else:
        neighbor = bruteforce_tile_fn(pts, k, point_chunk)
    tile = _weighted_tile(neighbor, vals, weight_fn)
    if q_shard.shape[0]:
        part = map_query_tiles(tile, q_shard, query_tile)
    else:
        part = vals.new_zeros((0, vals.shape[1]))
    return _gather_rows(mesh, part, rows)[:n_q]


def sharded_interpolate_field(points, values, grid: Grid, mesh: Mesh,
                              **kwargs):
    """Grid-output variant (→ (U, V, W) like ``interpolate_field``)."""
    queries = grid.flat_coords(mesh.device)
    out = sharded_interpolate_values(points, values, queries, mesh, **kwargs)
    out = out.reshape(grid.shape + (out.shape[-1],))
    return out[..., 0], out[..., 1], out[..., 2]


def _slab_repair(mesh: Mesh, field, den, survey, skip_l, cells_g, cells_l,
                 values_l, grid: Grid, x_ax, y_ax, z_slab, z_pad,
                 margin: float, block, dims_slab, slab_shape, nz_pad: int,
                 k: int, V: int, method: str, power: float):
    """Per-slab repair of uncovered nodes — the sharded form of
    ``fused_grid_knn.fused_repair``, on its plan (``_repair_plan``, the
    void rule and the panel cap). Each eligible rank re-evaluates its own
    uncovered blocks at the widened margin from its local window (the
    halo is sized for that margin), certifies through the coverage
    sentinel and writes into its slab: kernel 1's second launch on that
    rank.

    Every rank gathers every rank's survey and takes the same decisions
    from them: eligibility per rank (the survey's ids fit, and the void
    rule does not hold), and one panel width C2 planned over the whole
    padded grid. Returns ``(field', den', n_uncovered per rank, n_repaired
    per rank, n_left)`` — ``n_left`` nodes (far-field voids and the slabs
    whose repair was ineligible) remain for the global ladder."""
    from ptv_interpolation_tpu_torch.ops import fused_grid_knn as fg

    surveys = all_gather_cat(mesh, survey[None]).cpu().numpy()
    nblk_cap = surveys.shape[1] - 2
    n_fix_d = surveys[:, 0].astype(np.int64)
    n_bad_d = surveys[:, 1].astype(np.int64)
    n_fix_total = int(n_fix_d.sum())
    n_rep_d = np.zeros(mesh.size, np.int64)
    if n_fix_total == 0:
        return field, den, n_fix_d, n_rep_d, 0
    B = block[0] * block[1] * block[2]
    eligible = ((n_bad_d > 0) & (n_bad_d <= nblk_cap)
                & ~fg._repair_void(n_bad_d, n_fix_d, B))
    if not eligible.any():
        return field, den, n_fix_d, n_rep_d, n_fix_total

    margin2, mc2, _ = fg._repair_plan(cells_g, grid, block, margin)
    # one panel width over the whole padded grid, as in the JAX package
    C2 = fg._panel_width(fg._block_total_capacity(
        cells_g, (x_ax, y_ax, z_pad), margin2, tuple(block),
        (nz_pad, grid.ny, grid.nx), mc2))
    if C2 > fg._REPAIR_PANEL_MAX:
        return field, den, n_fix_d, n_rep_d, n_fix_total

    if eligible[mesh.rank]:
        ids = surveys[mesh.rank, 2:2 + int(n_bad_d[mesh.rank])].astype(
            np.int64)
        field, den, n_rep = fg._fused_repair_apply(
            field, den, skip_l, cells_l, values_l, (x_ax, y_ax, z_slab),
            margin2, ids, tuple(block), dims_slab, int(k), V, C2, method,
            float(power), slab_shape, mc2)
    else:
        n_rep = 0
    n_rep_d = all_gather_cat(mesh, torch.tensor(
        [n_rep], dtype=torch.int64, device=den.device)).cpu().numpy()
    return field, den, n_fix_d, n_rep_d, n_fix_total - int(n_rep_d.sum())


def sharded_grid_interpolate(points, values, grid: Grid, mesh: Mesh,
                             method: str = "sibson", k: int = 50,
                             power: float = 2.0, block=(8, 8, 16),
                             recall_target: float = 0.9,
                             margin_factor: float = 1.45,
                             tau_mode: str = "bisect", skip_mask=None,
                             backend: str = "auto"):
    """The block-centric τ-threshold grid path sharded over ``mesh``, with
    the candidate store cut by z-slab ownership (not replicated); returns
    (nz, ny, nx, V) on the mesh's device, on every rank.

    The grid's z-axis is cut into one slab per rank, each a multiple of
    the block's z-extent (the last padded). Each rank keeps only its
    slab-plus-halo window of the cell-sorted store
    (``parallel/slab_store.py``), with the global ``starts`` rebased into
    it by one clip, so the index arithmetic is the single-device path's.
    The halo covers the repair stage's 1.6× widened margin, so uncovered
    nodes are repaired per slab from the same window; only far-field
    voids go to the global exact ladder after the slabs are gathered.
    This is the multi-GPU form of the headline 1M → 256³ path.

    ``backend``: 'auto' or 'fused' — per slab the fused two-phase path
    (kernel 1, its per-slab repair) with ``tau_mode='bisect'``, on every
    device (the JAX package takes it on a TPU only) — or 'xla', the
    streaming path per slab with the weight sums carried to the global
    ladder. The panel widths are planned once over the whole padded grid,
    so every rank's panels have one width. ``tau_mode='approx'`` takes the
    exact selection, which meets any ``recall_target``, as on one device.

    ``sharded_grid_interpolate.last_stats`` records this rank's last call:
    its store's bytes (``store_bytes``) against the whole store's
    (``whole_bytes``), every rank's window rows (``n_loc``), the halo
    width, and on the fused path every rank's uncovered and repaired
    node counts and the ``n_left`` nodes left for the global ladder."""
    from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
        _idw_panel_weights, _sibson_panel_weights)
    from ptv_interpolation_tpu_torch.ops.grid_knn import (
        _grid_block_weighted_sum, _host_setup, _sort_values, _tau_mode,
        repair_empty_nodes)
    from ptv_interpolation_tpu_torch.parallel.slab_store import (
        build_slab_store, rebase_cells)

    if method == "idw":
        weight_fn = _idw_panel_weights(float(power))
    elif method == "sibson":
        weight_fn = _sibson_panel_weights()
    else:
        raise ValueError(f"sharded grid kernel supports idw/sibson, got {method!r}")
    del recall_target                    # every selection here is exact
    tau_mode = _tau_mode(tau_mode, False)
    if backend not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "fused" and tau_mode != "bisect":
        raise ValueError("backend='fused' implements tau_mode='bisect' only")
    use_fused = backend == "fused" or (backend == "auto"
                                       and tau_mode == "bisect")

    dev = mesh.device
    n_dev = mesh.size
    block = tuple(block)
    bz = block[0]
    # z-slab size: equal slabs, each a multiple of the block z-extent
    slab = -(-grid.nz // n_dev)
    slab = -(-slab // bz) * bz
    nz_pad = slab * n_dev

    pts = as_f32(points, dev)
    vals = as_f32(values, dev)
    (cells, values_sorted, axes, margin, mc, row_len, vals) = _host_setup(
        pts, vals, grid, k, block, margin_factor,
        cell_divisor=3.0 if use_fused else 2.0, device=dev)
    x_ax, y_ax, _ = axes
    # padded z axis, one slab per rank (each slab keeps the real spacing)
    z_full = np.asarray(grid.z, np.float32)
    step = float(z_full[1] - z_full[0]) if len(z_full) > 1 else 1.0
    z_pad = np.concatenate([
        z_full, z_full[-1] + step * np.arange(1, nz_pad - grid.nz + 1,
                                              dtype=np.float32)])
    z_slab = z_pad[mesh.rank * slab:(mesh.rank + 1) * slab]
    slab_shape = (slab, grid.ny, grid.nx)
    dims_slab = (slab // bz, _bcount(grid.ny, block[1]),
                 _bcount(grid.nx, block[2]))

    # this rank's window of the sorted store; the whole store is freed,
    # and rebuilt from ``order`` only if the global ladder needs it
    store = build_slab_store(cells, values_sorted, z_pad.reshape(n_dev, slab),
                             bz, grid.spacing[2], margin, rank=mesh.rank)
    cells = dataclasses.replace(cells, points_sorted=cells.points_sorted[:0])
    del values_sorted, pts, vals
    cells_l = rebase_cells(cells, store.points_l, store.row0, store.n_loc,
                           store.capW)
    V = store.values_l.shape[1]
    stats = {"store_bytes": store.per_device_bytes(),
             "whole_bytes": (cells.n_points + _PAD_ROWS) * (3 + V) * 4,
             "n_loc": [int(n) for n in store.n_loc_np], "halo": store.halo}
    sharded_grid_interpolate.last_stats = stats

    def global_ladder(out, den, blk):
        """The global repair ladder on the whole grid, from the whole
        store rebuilt in cell order (bit for bit the one freed above)."""
        p = as_f32(points, dev)
        v = as_f32(values, dev)
        order = cells.order.long()
        sentinel = torch.full((_PAD_ROWS, 3), _SENTINEL, dtype=torch.float32,
                              device=dev)
        full = dataclasses.replace(
            cells, points_sorted=torch.cat([p[order], sentinel]))
        return repair_empty_nodes(out, den, p, v, grid, k, method, power,
                                  cells=full, margin=margin,
                                  skip_mask=skip_mask,
                                  values_sorted=_sort_values(v, order),
                                  block=blk)

    if use_fused:
        from ptv_interpolation_tpu_torch.ops import fused_grid_knn as fg

        # the panel width over the whole padded grid: every rank's C
        C = fg._panel_width(fg._block_total_capacity(
            cells, (x_ax, y_ax, z_pad), margin, block,
            (nz_pad, grid.ny, grid.nx), mc))
        nblk_cap = min(fg._NBLK_MAX, dims_slab[0] * dims_slab[1]
                       * dims_slab[2])
        # survey skip: the caller's skip mask and the padded z rows (they
        # are sliced away after the gather — repairing them would flood
        # the last rank's survey)
        skipfull = np.zeros((nz_pad, grid.ny, grid.nx), bool)
        skipfull[grid.nz:] = True
        if skip_mask is not None:
            skipfull[: grid.nz] = np.asarray(skip_mask, bool)
        skip_l = torch.as_tensor(
            skipfull[mesh.rank * slab:(mesh.rank + 1) * slab], device=dev)

        field, den = fg.fused_block_sums(
            cells_l, store.values_l, (x_ax, y_ax, z_slab), margin, block,
            slab_shape, mc, C, k, method, power)
        survey, _ = fg._repair_survey(den, skip_l, block, dims_slab,
                                      nblk_cap)
        field, den, n_fix, n_rep, n_left = _slab_repair(
            mesh, field, den, survey, skip_l, cells, cells_l, store.values_l,
            grid, x_ax, y_ax, z_slab, z_pad, margin, block, dims_slab,
            slab_shape, nz_pad, k, V, method, float(power))
        stats.update(uncovered=[int(n) for n in n_fix],
                     repaired=[int(n) for n in n_rep], n_left=n_left)
        out8 = torch.cat([field, den[..., None]], dim=-1)
        out8 = all_gather_cat(mesh, out8)[: grid.nz]
        out, den = out8[..., :V], out8[..., V]
        if n_left == 0:
            return out
        # far-field remainder (and any slab whose repair was ineligible):
        # the global exact ladder, per-query CSR panel then brute force;
        # no ``block``, so it cannot re-enter the fused repair
        return global_ladder(out, den, None)

    out, den = _grid_block_weighted_sum(
        cells_l, store.values_l, (x_ax, y_ax, z_slab), margin, k, block,
        slab_shape, mc, row_len, weight_fn, False, tau_mode)
    # the weight sums travel with the values, so that the far-field
    # fallback runs after the slabs are joined and the sharded result
    # matches the single-device one on clouds with void regions
    out = all_gather_cat(mesh, torch.cat([out, den[..., None]], dim=-1))
    out = out[: grid.nz]
    out, den = out[..., :-1], out[..., -1]
    # the ladder's own first check, here so that the store is rebuilt
    # only when a node is left
    uncovered = den == 0.0
    if skip_mask is not None:
        uncovered &= ~torch.as_tensor(skip_mask, dtype=torch.bool, device=dev)
    if not bool(uncovered.any()):
        return out
    return global_ladder(out, den, block)


sharded_grid_interpolate.last_stats = None


# ---------------------------------------------------------------------------
# The whole sharded pipeline step
# ---------------------------------------------------------------------------

def make_pipeline_step(grid: Grid, mesh: Optional[Mesh] = None, k: int = 16,
                       power: float = 2.0, iterations: int = 1,
                       query_tile: int = 512, device="cuda"):
    """An end-to-end step, scattered vectors and a fluid mask → a
    divergence-cleaned grid field: ``step(points, values, fluid_mask) →
    (u, v, w, mean_abs_div_final)``.

    The step interpolates by brute-force IDW onto ``grid.flat_coords`` in
    tiles of ``query_tile`` queries (sharded over ``mesh`` by
    :func:`sharded_interpolate_values`, which gives the one-device result
    bit for bit), zeroes the solid, and runs ``iterations`` of projection
    cleaning (``maxiter=50``; z-sharded over ``mesh``). With a mesh every
    rank calls it alike and gets the whole fields on ``mesh.device``;
    without one it runs on ``device``. The JAX counterpart is a jitted
    function whose outputs are z-sharded; this one is a plain callable."""
    from ptv_interpolation_tpu_torch.physics import (
        clean_divergence_projection)

    dev = resolve_device(device) if mesh is None else mesh.device
    dx, dy, dz = grid.spacing
    queries = grid.flat_coords(dev)

    def step(points, values, fluid_mask):
        if mesh is not None:
            out = sharded_interpolate_values(points, values, queries, mesh,
                                             method="idw", k=k, power=power,
                                             query_tile=query_tile)
        else:
            out = idw_interpolate(points, values, queries, k=k, power=power,
                                  query_tile=query_tile, device=dev)
        out = out.reshape(grid.shape + (out.shape[-1],))
        mask = torch.as_tensor(fluid_mask, device=dev).to(torch.bool)
        maskf = mask.float()
        res = clean_divergence_projection(
            out[..., 0] * maskf, out[..., 1] * maskf, out[..., 2] * maskf,
            mask, dx, dy, dz, iterations=iterations, maxiter=50, device=dev,
            mesh=mesh)
        return res.u, res.v, res.w, res.mean_abs_div_final

    return step
