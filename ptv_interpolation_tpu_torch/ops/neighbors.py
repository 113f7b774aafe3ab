"""k-nearest-neighbour primitives: exact brute force and the CSR cell list.

Counterpart of ``ptv_interpolation_tpu/ops/neighbors.py``:

* :func:`knn_bruteforce` — exact kNN by streaming point chunks through a
  running top-k merge, distances from one matmul per chunk and then
  recomputed exactly for the selected k. Right for small clouds and for
  the grid path's last repair stage.
* :class:`CellList` / :func:`build_cell_list` — particles bucketed into a
  uniform voxel grid in CSR form (``starts`` + ``order`` +
  ``points_sorted``), the layout the grid kernels gather from, and
  :func:`csr_candidate_panel`, the per-query cell-neighbourhood panel.
* :func:`celllist_tile_fn` / :func:`knn_celllist` — the generic cell-list
  search: the k nearest of each query's ``(2·rings+1)³`` cell
  neighbourhood, exact whenever the k-th neighbour lies within
  ``rings·cell_size``. The JAX package scores a dense per-cell ``table``;
  the port scores the CSR panel, which holds the same candidates in the
  same slot order. :func:`knn` chooses between the two searches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.utils import wait

_BIG = 3.4e38          # sentinel squared distance for missing neighbours
_PAD_ROWS = 1024       # far-sentinel rows after the sorted points
_SENTINEL = 1e19       # sentinel coordinate → d² ≈ 1e38, never selected
_MAX_CELLS = 2 ** 22   # bound on the cell count (degenerate cell sizes)
_MAX_PANEL = 16384     # bound on a query's (2r+1)³·cap candidate slots


def _sq_dist(d: torch.Tensor) -> torch.Tensor:
    """|d|² over the last axis (x, y, z) in f32, rounded as the JAX
    package's ``jnp.sum(d ** 2, axis=-1)`` is on the CPU, where XLA forms
    it as a chain of fused multiply-adds: fma(dz, dz, fma(dy, dy, dx·dx)),
    each step rounded once. Each step runs in f64 here (the product of two
    f32 values is exact there) and rounds to f32, which equals the fused
    step unless the f64 sum itself rounds onto an f32 midpoint."""
    x, y, z = d[..., 0], d[..., 1].double(), d[..., 2].double()
    acc = (y * y + (x * x).double()).float()
    return (z * z + acc.double()).float()


def _pairwise_sq_dists(queries: torch.Tensor,
                       points: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared distances via one matmul plus rank-1 corrections,
    centred on the query centroid first so the |q|²+|p|²−2q·p expansion
    does not cancel catastrophically. Callers recompute the selected
    distances exactly."""
    center = queries.mean(dim=0)
    q = queries - center
    p = points - center
    qq = (q * q).sum(dim=-1, keepdim=True)
    pp = (p * p).sum(dim=-1)
    qp = q @ p.T
    return torch.clamp_min(qq + pp[None, :] - 2.0 * qp, 0.0)


def map_query_tiles(tile_fn, queries: torch.Tensor, query_tile: int,
                    progress=None, batch_tiles: int = 64):
    """Apply ``tile_fn`` to (≤ query_tile, 3) slices of ``queries`` and
    concatenate each output of the result (a tensor or a tuple of them).

    ``progress``: optional ``fn(done_queries, total_queries)`` callback,
    called as the JAX package calls it: after every ``batch_tiles`` tiles
    (the device synchronised first, so a line means work done), and once
    more for a ragged tail; never when the queries fit in one batch."""
    n_q = queries.shape[0]
    starts = range(0, n_q, query_tile)
    outs = []
    for t, s in enumerate(starts):
        outs.append(tile_fn(queries[s:s + query_tile]))
        if progress is None or len(starts) <= batch_tiles:
            continue
        if (t + 1) % batch_tiles == 0 or t + 1 == len(starts):
            if queries.device.type == "cuda":
                torch.cuda.synchronize(queries.device)
            progress(min((t + 1) * query_tile, n_q), n_q)
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
    return torch.cat(outs, dim=0)


def bruteforce_tile_fn(points: torch.Tensor, k: int, point_chunk: int = 4096):
    """Per-tile exact kNN closure: ``fn(q_tile) -> (sq_dists, idx)``, both
    (T, k), ascending; missing neighbours (k > n_points) carry index -1
    and distance ``_BIG``. Points stream in chunks of ``point_chunk``
    through a running top-k, so peak memory is O(tile × chunk)."""
    n_points = points.shape[0]

    def per_tile(q_tile):
        t = q_tile.shape[0]
        best_d = torch.full((t, k), _BIG, dtype=torch.float32,
                            device=q_tile.device)
        best_i = torch.full((t, k), -1, dtype=torch.int64,
                            device=q_tile.device)
        for s in range(0, n_points, point_chunk):
            chunk = points[s:s + point_chunk]
            d2 = _pairwise_sq_dists(q_tile, chunk)
            cand_i = torch.arange(s, s + chunk.shape[0],
                                  device=q_tile.device).expand(t, -1)
            all_d = torch.cat([best_d, d2], dim=1)
            all_i = torch.cat([best_i, cand_i], dim=1)
            best_d, args = torch.topk(all_d, k, dim=1, largest=False)
            best_i = torch.gather(all_i, 1, args)
        # the matmul expansion carries O(eps·|x|²) noise: recompute the
        # selected k distances directly, then re-sort ascending
        neigh = points[best_i.clamp_min(0)]                        # (T, k, 3)
        exact = _sq_dist(q_tile[:, None, :] - neigh)
        best_d = torch.where(best_i >= 0, exact, best_d)
        best_d, order = torch.sort(best_d, dim=1, stable=True)
        return best_d, torch.gather(best_i, 1, order)

    return per_tile


def knn_bruteforce(points, queries, k: int, query_tile: int = 1024,
                   point_chunk: int = 4096, device="cuda"):
    """Exact kNN: for each query, the ``k`` nearest of ``points``. Returns
    ``(dists, idx)`` of shape (Q, k), distances ascending; missing
    neighbours are inf-distance with index -1 (``KDTree.query``
    semantics)."""
    dev = resolve_device(device)
    pts = as_f32(points, dev)
    qs = as_f32(queries, dev)
    d2, idx = map_query_tiles(bruteforce_tile_fn(pts, k, point_chunk), qs,
                              query_tile)
    dist = torch.where(idx < 0, torch.inf, torch.sqrt(d2))
    return dist, idx


# ---------------------------------------------------------------------------
# CSR cell list
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellList:
    """Particles bucketed into a uniform voxel grid, CSR layout: cell ids
    are ``(cz·ncy + cy)·ncx + cx``, ``order`` lists the particle ids sorted
    by cell (stably), ``starts[c]`` is the first sorted index of cell c, and
    ``points_sorted`` is padded with 1024 far-sentinel rows so that reads
    past the end stay harmless."""

    starts: torch.Tensor         # (n_cells + 1,) int32 CSR offsets
    order: torch.Tensor          # (n_points,) int32 cell-sorted particle ids
    points_sorted: torch.Tensor  # (n_points + 1024, 3) f32, sentinel padded
    origin: torch.Tensor         # (3,) f32
    inv_cell: torch.Tensor       # (3,) f32 — 1 / cell_size
    dims: Tuple[int, int, int]   # (ncx, ncy, ncz)
    cap: int                     # maximum cell occupancy
    n_pts: int                   # point count = index of the first sentinel
    origin_host: np.ndarray      # host copies read by the capacity planners
    inv_host: float              # unrounded 1 / cell_size

    @property
    def n_points(self) -> int:
        return self.n_pts

    @property
    def device(self) -> torch.device:
        return self.points_sorted.device


def auto_cell_size(n_points: int, bounds_lo, bounds_hi, k: int,
                   safety: float = 1.45) -> float:
    """Cell edge such that a ball of radius ``cell_size`` is expected to
    hold ≥ k points at mean density."""
    extent = np.maximum(np.asarray(bounds_hi, float)
                        - np.asarray(bounds_lo, float), 1e-12)
    volume = float(np.prod(extent))
    density = max(n_points, 1) / volume
    r_k = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    return float(r_k * safety)


def build_cell_list(points, cell_size: float | None = None, k_hint: int = 32,
                    bounds=None, device="cuda") -> CellList:
    """Bucket ``points`` (numpy array or tensor) into a CSR cell list on
    ``device``.

    The build is permutation-identical to the JAX package's: cell indices
    are quantized with the same f32 ops in the same order
    (``((pts - lo) * inv)`` truncated to int32, ``inv`` an f32), and the
    sort is stable on the same int32 keys. ``bounds``: optional
    precomputed ``(lo, hi)`` f32 bounds of the cloud."""
    dev = resolve_device(device)
    pts = as_f32(points, dev)
    n = pts.shape[0]
    if bounds is not None:
        lo = np.asarray(bounds[0], np.float32)
        hi = np.asarray(bounds[1], np.float32)
    else:
        with wait("bounds"):
            lo = pts.amin(dim=0).cpu().numpy()
        with wait("bounds"):
            hi = pts.amax(dim=0).cpu().numpy()
    if cell_size is None:
        cell_size = auto_cell_size(n, lo, hi, k_hint)
    extent = np.maximum(hi - lo, 1e-12)
    dims = np.maximum(np.ceil(extent / cell_size).astype(int), 1)
    while int(np.prod(dims)) > _MAX_CELLS:  # degenerate tiny cell_size
        cell_size *= 1.26
        dims = np.maximum(np.ceil(extent / cell_size).astype(int), 1)
    ncx, ncy, ncz = int(dims[0]), int(dims[1]), int(dims[2])
    n_cells = ncx * ncy * ncz
    inv = 1.0 / cell_size

    lo_t = torch.as_tensor(lo, device=dev)
    inv_t = torch.full((3,), np.float32(inv), dtype=torch.float32, device=dev)
    dmax = torch.tensor([ncx - 1, ncy - 1, ncz - 1], dtype=torch.int32,
                        device=dev)
    cidx = torch.minimum(((pts - lo_t) * inv_t).to(torch.int32).clamp_min(0),
                         dmax)
    cell_id = (cidx[:, 2] * ncy + cidx[:, 1]) * ncx + cidx[:, 0]
    sorted_cells, order = torch.sort(cell_id, stable=True)
    starts = torch.searchsorted(
        sorted_cells, torch.arange(n_cells + 1, dtype=torch.int32, device=dev),
        right=False).to(torch.int32)
    points_sorted = torch.cat(
        [pts[order], torch.full((_PAD_ROWS, 3), _SENTINEL, dtype=torch.float32,
                                device=dev)])
    cap = 1
    if n:
        with wait("cell_cap"):
            cap = int(torch.diff(starts).max().item())
    return CellList(
        starts=starts,
        order=order.to(torch.int32),
        points_sorted=points_sorted,
        origin=lo_t,
        inv_cell=inv_t,
        dims=(ncx, ncy, ncz),
        cap=cap,
        n_pts=int(n),
        origin_host=np.asarray(lo, np.float32),
        inv_host=float(inv),
    )


def bounded_cell_list(points, k_hint: int, rings: int = 1,
                      device="cuda") -> CellList | None:
    """:func:`build_cell_list` for the generic search, or None when a
    query's ``(2·rings+1)³·cap`` candidate slots would exceed 16 384: on
    clustered clouds the auto cell size can hold thousands of points per
    cell, and ``cap`` is a global maximum that refining the cells cannot
    bound. The caller then takes the streamed brute force, exact and
    memory-bounded, as the JAX package does."""
    cells = build_cell_list(points, k_hint=k_hint, device=device)
    if (2 * rings + 1) ** 3 * cells.cap > _MAX_PANEL:
        return None
    return cells


def cell_meta_np(cells: CellList):
    """(origin, inv) as host values."""
    return np.asarray(cells.origin_host, np.float32), float(cells.inv_host)


def csr_candidate_panel(cells: CellList, q_tile: torch.Tensor, rings: int):
    """For each query of ``q_tile`` (T, 3), the ``(2·rings+1)³·cap``
    candidate rows of its cell neighbourhood as indices into the
    cell-sorted arrays (``starts[cell] + lane``), and their squared
    distances. Empty slots and cells outside the grid point at the
    sentinel row ``cells.n_points`` and carry d² = ``_BIG``.

    Returns ``(cand, d2)``, both (T, n_offsets·cap), slots ordered by
    neighbour cell (z slowest, x fastest) and lane, as the JAX package
    orders them; d² rounded as :func:`_sq_dist` rounds it."""
    ncx, ncy, ncz = cells.dims
    cap = cells.cap
    n_sent = cells.n_points
    dev = q_tile.device
    r = torch.arange(-rings, rings + 1, dtype=torch.int32, device=dev)
    oz, oy, ox = torch.meshgrid(r, r, r, indexing="ij")
    offs = torch.stack([ox, oy, oz], dim=-1).reshape(-1, 3)       # (n_off, 3)
    dims = torch.tensor([ncx, ncy, ncz], dtype=torch.int32, device=dev)

    T = q_tile.shape[0]
    cidx = torch.floor((q_tile - cells.origin) * cells.inv_cell).to(
        torch.int32)
    cidx = torch.minimum(cidx.clamp_min(0), dims - 1)
    neigh = cidx[:, None, :] + offs[None, :, :]
    in_range = ((neigh >= 0) & (neigh < dims)).all(dim=-1)
    cell_ids = (neigh[..., 2] * ncy + neigh[..., 1]) * ncx + neigh[..., 0]
    cell_ids = torch.where(in_range, cell_ids, 0).long()
    s = cells.starts[cell_ids].long()                              # (T, n_off)
    e = cells.starts[cell_ids + 1].long()
    lane = torch.arange(cap, device=dev)
    cand = s[..., None] + lane                                     # (T, n_off, cap)
    ok = in_range[..., None] & (cand < e[..., None])
    cand = torch.where(ok, cand, n_sent).reshape(T, -1)
    d2 = _sq_dist(q_tile[:, None, :] - cells.points_sorted[cand])
    return cand, torch.where(cand == n_sent, _BIG, d2)


def _select_slot_order(d2: torch.Tensor, kk: int):
    """The kk smallest of each row of ``d2``, ascending, ties in slot order
    — what ``lax.top_k`` gives, and ``approx_min_k`` off the TPU, where it
    is an exact sort: ``(sq, args)``. A stable sort of the whole row, so
    that the slots chosen among ties at the kk-th value are the first."""
    sq, args = torch.sort(d2, dim=-1, stable=True)
    return sq[:, :kk], args[:, :kk]


def celllist_csr_tile_fn(cells: CellList, k: int, rings: int = 1,
                         exact_topk: bool = True,
                         recall_target: float = 0.99):
    """Per-tile cell-list kNN through the CSR layout: ``fn(q_tile) ->
    (sq_dists, idx_sorted)``, both (T, k), ascending, where
    ``idx_sorted`` indexes the cell-sorted arrays (``points_sorted``, or
    values sorted by ``cells.order``). Candidates are the
    ``(2·rings+1)³·cap`` slots of :func:`csr_candidate_panel`; slots
    beyond a cell's occupancy or outside the grid, and padding when the
    panel holds fewer than k slots, point at the sentinel row
    ``cells.n_points`` with d² = ``_BIG``. Exact whenever the k-th
    neighbour lies within ``rings·cell_size`` of the query; beyond it, the
    k nearest of the neighbourhood. Selection is exact: ``exact_topk=False``
    (``approx_min_k`` at ``recall_target``) is served by the same sort."""
    del exact_topk, recall_target        # every selection here is exact
    n_offsets = (2 * rings + 1) ** 3
    kk = min(k, n_offsets * cells.cap)
    n_sent = cells.n_points

    def per_tile(q_tile):
        cand, d2 = csr_candidate_panel(cells, q_tile, rings)
        sq, args = _select_slot_order(d2, kk)
        idx = torch.gather(cand, 1, args)
        if kk < k:
            T = q_tile.shape[0]
            sq = torch.cat([sq, sq.new_full((T, k - kk), _BIG)], dim=1)
            idx = torch.cat([idx, idx.new_full((T, k - kk), n_sent)], dim=1)
        return sq, idx

    return per_tile


def celllist_tile_fn(cells: CellList, k: int, rings: int = 1,
                     exact_topk: bool = False,
                     recall_target: float = 0.99):
    """Per-tile cell-list kNN closure: ``fn(q_tile) -> (sq_dists, idx)``
    with original point ids, the JAX package's search over its dense
    per-cell ``table``. That table holds, cell by cell, the same
    candidates in the same slot order as the CSR panel (a cell's rank
    follows the stable sort), so the search runs on
    :func:`celllist_csr_tile_fn` and maps through ``cells.order``.

    As in the JAX package, a slot with no point (an empty lane, a cell
    outside the grid) carries id ``n_points`` and d² = ``_BIG`` when it is
    selected, which happens when the neighbourhood holds fewer than k
    points; when the panel itself has fewer than k slots, the missing ones
    carry id -1. Callers clamp these ids into range as the JAX package's
    gathers do. Selection is exact, as for :func:`celllist_csr_tile_fn`:
    off the TPU the JAX package's ``approx_min_k`` gives the same
    distances, with its own order among ties."""
    del exact_topk, recall_target        # every selection here is exact
    n = cells.n_points
    kk = min(k, (2 * rings + 1) ** 3 * cells.cap)
    sorted_fn = celllist_csr_tile_fn(cells, kk, rings)
    order = torch.cat([cells.order.long(),
                       torch.full((1,), n, dtype=torch.int64,
                                  device=cells.device)])

    def per_tile(q_tile):
        sq, idx_sorted = sorted_fn(q_tile)
        idx = order[idx_sorted]                  # the sentinel row → n
        if kk < k:
            T = q_tile.shape[0]
            sq = torch.cat([sq, sq.new_full((T, k - kk), _BIG)], dim=1)
            idx = torch.cat([idx, idx.new_full((T, k - kk), -1)], dim=1)
        return sq, idx

    return per_tile


def knn_celllist(cells: CellList, queries, k: int, rings: int = 1,
                 query_tile: int = 512):
    """kNN against a prebuilt :class:`CellList` (see
    :func:`celllist_tile_fn`), on the cell list's device. Returns
    ``(dists, idx)``, (Q, k); padding slots (id -1) are inf-distance."""
    qs = as_f32(queries, cells.device)
    sq, idx = map_query_tiles(celllist_tile_fn(cells, k, rings), qs,
                              query_tile)
    return torch.where(idx < 0, torch.inf, torch.sqrt(sq)), idx


def knn(points, queries, k: int, method: str = "auto", device="cuda",
        **kwargs):
    """One neighbour primitive on ``device``: 'bruteforce' (exact),
    'celllist' (scalable), or 'auto' (brute force when Q·N ≤ 2³¹, else
    the cell list). ``kwargs`` go to the chosen search; for 'celllist',
    ``cells`` (prebuilt), ``cell_size``, and ``rings``."""
    dev = resolve_device(device)
    n_pts, n_q = int(points.shape[0]), int(queries.shape[0])
    if method == "auto":
        method = "bruteforce" if n_pts * n_q <= 2 ** 31 else "celllist"
    if method == "bruteforce":
        return knn_bruteforce(points, queries, k, device=dev, **kwargs)
    if method == "celllist":
        cells = kwargs.pop("cells", None)
        if cells is None:
            cells = build_cell_list(points, cell_size=kwargs.get("cell_size"),
                                    k_hint=k, device=dev)
        return knn_celllist(cells, queries, k, rings=kwargs.get("rings", 1))
    raise ValueError(f"unknown knn method {method!r}")
