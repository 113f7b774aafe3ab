"""Memory-level sharding of the CSR candidate store by z-slab ownership.

Counterpart of ``ptv_interpolation_tpu/parallel/slab_store.py``. The grid's
z-axis is cut into one slab per rank; rank ``r`` owns the cell-list cells
whose z-range meets its slab, plus a halo of ``1.6 × margin`` — the
widened margin of the repair stage — so the main kernel and the per-slab
repair are both served from the rank's own memory. The halo is built once
instead of exchanged: the point store does not change during an
interpolation.

Cell ids are z-major (``(cz·ncy + cy)·ncx + cx``), so a slab-plus-halo
cell window is one contiguous range of the cell-sorted rows. A rank keeps
(a) the global ``starts`` offsets, rebased into its window by one clip,
``clip(starts − row0, 0, n_loc)`` — out-of-window cells read as empty,
in-window cells keep their exact counts, and the f32 cell-index
arithmetic of the kernels is the single-device path's — and (b) its
contiguous slice of the sorted point and value stores, padded with
sentinel rows to the uniform window capacity ``capW`` (row ``capW`` is a
far-sentinel row, the local invalid-slot index).

Each rank builds the global CSR store once, as the JAX package's
single-process build does, cuts its window out of it and frees the rest:
the store held during evaluation is ≈ ``total/n + halo`` rows per rank;
the O(#cells) ``starts`` vector and the O(N) ``order`` stay whole.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ptv_interpolation_tpu_torch.ops.fused_grid_knn import REPAIR_MARGIN_FACTOR
from ptv_interpolation_tpu_torch.ops.neighbors import CellList, cell_meta_np


@dataclasses.dataclass
class SlabStore:
    """One rank's slab-plus-halo slice of the cell-sorted candidate store,
    with every rank's window offsets and occupancies (host)."""

    points_l: torch.Tensor   # (capW + pad, 3) f32, sentinel-padded
    values_l: torch.Tensor   # (capW + pad, V) f32, zero-padded
    row0: int                # this rank's global row offset
    n_loc: int               # this rank's real rows
    capW: int                # uniform window capacity = sentinel row index
    row0_np: np.ndarray      # (n,) every rank's offset
    n_loc_np: np.ndarray     # (n,) every rank's real row count
    halo: float              # physical halo width (1.6 × margin)

    def per_device_bytes(self) -> int:
        """Candidate-store bytes this rank holds during evaluation (the
        O(N) arrays only; ``starts`` adds a bounded O(#cells))."""
        W = self.points_l.shape[0]
        V = self.values_l.shape[1]
        return W * (3 + V) * 4


def _slab_windows(cells: CellList, z_slabs_np: np.ndarray, bz: int,
                  dz: float, margin: float):
    """Every rank's window of cell-sorted rows: ``(row0, n_loc)`` int64
    arrays, (n,) each. ``z_slabs_np``: (n, slab) grid z-coordinates per
    rank (the padded slabs the sharded kernel evaluates); ``bz``/``dz``:
    block z-extent and grid z-spacing. The arithmetic is the JAX
    package's, in its f32 op order, with one cell of slack on each side
    and a halo that covers the repair stage's widened margin."""
    n_dev, slab = z_slabs_np.shape
    origin, inv = cell_meta_np(cells)
    cell_size = 1.0 / inv
    ncx, ncy, ncz = cells.dims
    R = ncy * ncx

    margin2 = np.float32(REPAIR_MARGIN_FACTOR * float(margin))
    mc2z = int(math.ceil((bz * dz + 2.0 * float(margin2)) / cell_size)) + 1
    inv32 = np.float32(inv)
    oz = np.float32(origin[2])

    cz0 = np.empty(n_dev, np.int64)
    cz1 = np.empty(n_dev, np.int64)
    for d in range(n_dev):
        z_first = np.float32(z_slabs_np[d, 0])
        z_last = np.float32(z_slabs_np[d, slab - bz]) if slab >= bz else z_first
        b0 = int(np.floor(((z_first - margin2) - oz) * inv32))
        b1 = int(np.floor(((z_last - margin2) - oz) * inv32))
        cz0[d] = np.clip(b0 - 1, 0, ncz)
        cz1[d] = np.clip(b1 + mc2z + 1, 0, ncz)
        cz1[d] = max(cz1[d], cz0[d])

    idx = torch.as_tensor(np.concatenate([cz0 * R, cz1 * R]),
                          dtype=torch.int64, device=cells.device)
    vals = cells.starts[idx].cpu().numpy().astype(np.int64)
    row0_np, row1_np = vals[:n_dev], vals[n_dev:]
    return row0_np, row1_np - row0_np, float(margin2)


def build_slab_store(cells: CellList, values_sorted: torch.Tensor,
                     z_slabs_np: np.ndarray, bz: int, dz: float,
                     margin: float, pad: int = 1024,
                     rank: int = 0) -> SlabStore:
    """Cut rank ``rank``'s z-slab window plus halo out of the cell-sorted
    store (:func:`_slab_windows`): ``points_l``/``values_l`` hold its
    ``n_loc`` rows, then sentinel rows (1e19 coordinates, zero values) up
    to ``capW + pad``, ``capW`` being the largest window over all ranks
    (at least 8), so every rank's arrays have one shape."""
    row0_np, n_loc_np, halo = _slab_windows(cells, z_slabs_np, bz, dz, margin)
    capW = int(max(int(n_loc_np.max()) if len(n_loc_np) else 0, 8))
    W = capW + pad
    row0, n_loc = int(row0_np[rank]), int(n_loc_np[rank])
    lane = torch.arange(W, dtype=torch.int64, device=cells.device)
    idx = torch.where(lane < n_loc, row0 + lane, cells.n_points)
    return SlabStore(points_l=cells.points_sorted[idx],
                     values_l=values_sorted[idx], row0=row0, n_loc=n_loc,
                     capW=capW, row0_np=row0_np, n_loc_np=n_loc_np,
                     halo=halo)


def rebase_cells(cells: CellList, points_local: torch.Tensor, row0: int,
                 n_loc: int, capW: int) -> CellList:
    """This rank's local :class:`CellList`: the global ``starts`` rebased
    into its window by one clip — cells before the window floor at 0,
    cells after it saturate at ``n_loc`` (both read as empty), in-window
    cells keep their exact global counts, pointing into ``points_local``
    — with ``capW`` (≥ every rank's ``n_loc``) as the sentinel row index.
    The grid, origin, cell size and ``cap`` are the global list's."""
    starts = torch.clamp(cells.starts.to(torch.int64) - row0, 0,
                         n_loc).to(torch.int32)
    return dataclasses.replace(
        cells, starts=starts,
        order=torch.zeros((0,), dtype=torch.int32, device=cells.device),
        points_sorted=points_local, n_pts=capW)
