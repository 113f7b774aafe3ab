"""Fused two-phase grid kNN: a τ-bisection weighted-sum kernel (CUDA)
over each grid block's candidates, gathered (plain version) or staged by
the kernel itself from the cell list.

Counterpart of ``ptv_interpolation_tpu/ops/fused_grid_knn.py``, with the
same stages and the same intermediate layouts, so each one compares like
with like against the JAX package:

* **Phase 1** gathers each grid block's candidate rows once into a
  compacted panel ``(8, n_blocks·C)`` — rows x, y, z, u, v, w, 0, 0;
  empty slots hold 1e19 sentinel coordinates and zero values — and the
  nodes' query rows (:func:`_compact_gather`, :func:`_build_queries`).
* **Phase 2** computes, for every grid node of a sub-tile of Bt nodes,
  its k-th-distance threshold τ² by 24 halvings of [0, margin²], the IDW
  or sibson weights of the selected candidates, and the normalised
  per-channel sums: :func:`_fused_eval_plain`, a dense transcription of
  the math over phase 1's panel.
* :func:`_fused_eval_cells` runs both over the blocks of a grid. On a
  CUDA device it launches the hand-written kernel
  ``csrc/fused_grid_knn.cu``, which stages each block's candidates from
  the cell list and forms its nodes' coordinates itself (no panel, no
  query rows); on the CPU it runs phase 1 and :func:`_fused_eval`, the
  plain version.
* **Repair** (:func:`fused_repair`) reruns the same kernel at 1.6× the
  margin over only the blocks that hold uncovered nodes (the streaming
  subset evaluator where that panel is too wide); its plan
  (:func:`_repair_plan`) also serves the sharded path's per-slab repair.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.grid import Grid
from ptv_interpolation_tpu_torch.ops.grid_knn import (
    _ROW_PAD, _block_counts, _block_rows, _grid_block_weighted_sum_subset,
    _host_setup, _pad_axis, _row_capacity, repair_empty_nodes)
from ptv_interpolation_tpu_torch.ops.neighbors import CellList, cell_meta_np
from ptv_interpolation_tpu_torch.utils import count, span, wait

_EPS = 1e-10              # weight epsilon of the reference formulas
_BISECT_ITERS = 24
_CHUNK_ELEMS = 1 << 24    # bound on (blocks × C) index intermediates
_PLAIN_ELEMS = 1 << 26    # bound on (rows × Bt × C) panels of the plain eval
_MODES = {"idw": 0, "sibson": 1}
_NBLK_MAX = 4096          # block ids a slab's repair survey carries
_SMEM_BYTES = 232448      # dynamic shared memory one CTA may use on sm_90
_SMEM_SM = 233472         # shared memory of one sm_90 SM, of which the
_SMEM_CTA = 1024          # runtime keeps this much per resident CTA
_LIST_SLACK = 32          # shortlist entries planned beyond the count target
_WARP = 32
_WARP_LIST_MIN = 32       # fewest entries a warp list is planned with


# ---------------------------------------------------------------------------
# Phase 1: compacted candidate gather
# ---------------------------------------------------------------------------

def _block_ids(ids, n_total: int, device) -> torch.Tensor:
    if ids is None:
        return torch.arange(n_total, device=device)
    return torch.as_tensor(ids, dtype=torch.int64, device=device)


def _compact_chunk(cells: CellList, lo: torch.Tensor, m32: torch.Tensor,
                   mc: Tuple[int, int, int], C: int) -> torch.Tensor:
    """:func:`_compact_rows` for one chunk of blocks; ``m32`` is the
    margin as an f32 scalar tensor."""
    dev = cells.device
    R = mc[0] * mc[1]
    g = lo.shape[0]
    start, cnt = _block_rows(cells, lo, m32, mc)                   # (g, R)
    incl = torch.cumsum(cnt, dim=1)                                # (g, R)
    sl = torch.arange(C, dtype=torch.int64, device=dev).expand(g, C)
    sl = sl.contiguous()
    # slot → row: #(inclusive offsets ≤ slot)
    row = torch.searchsorted(incl, sl, right=True).clamp_max(R - 1)
    valid = sl < incl[:, -1:]
    gidx = (torch.gather(start, 1, row)
            + (sl - torch.gather(incl - cnt, 1, row)))
    return torch.where(valid, gidx, cells.n_points).to(torch.int32)


def _compact_rows(cells: CellList, lo: torch.Tensor, margin: float,
                  mc: Tuple[int, int, int], C: int) -> torch.Tensor:
    """For blocks whose low corners are ``lo`` ((n_blocks, 3) f32 x, y, z
    on the cells' device), the (n_blocks, C) int32 compacted candidate
    rows of the cell-sorted arrays; slots past a block's candidate count
    point at the sentinel row ``cells.n_points``.

    A block's candidate region is ``mcz × mcy`` CSR rows of ``mcx`` cells
    each, starting ``margin`` below its low corner; slot → row is a batched
    ``searchsorted`` over the rows' inclusive offsets, run in chunks of
    blocks so that the (blocks, C) intermediates stay bounded."""
    m32 = torch.tensor(np.float32(margin), device=cells.device)
    n_blocks = lo.shape[0]
    out = torch.empty((n_blocks, C), dtype=torch.int32, device=cells.device)
    group = max(1, _CHUNK_ELEMS // max(C, mc[0] * mc[1]))
    for s in range(0, n_blocks, group):
        out[s:s + group] = _compact_chunk(cells, lo[s:s + group], m32, mc, C)
    return out


def _compact_indices(cells: CellList, axes, margin: float,
                     block: Tuple[int, int, int],
                     grid_shape: Tuple[int, int, int],
                     mc: Tuple[int, int, int], C: int,
                     ids=None) -> torch.Tensor:
    """Per grid block, the (C,) compacted candidate rows of
    :func:`_compact_rows`; returns (n_blocks, C) int32. ``ids``
    (optional): evaluate only these flat block indices, in this order."""
    bz, by, bx = block
    nz, ny, nx = grid_shape
    nby, nbx = _block_counts(ny, by), _block_counts(nx, bx)
    nbz = _block_counts(nz, bz)
    dev = cells.device
    x_ax, y_ax, z_ax = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                        for a in axes)
    ids = _block_ids(ids, nbz * nby * nbx, dev)
    ibz = ids // (nby * nbx)
    iby = (ids // nbx) % nby
    ibx = ids % nbx
    lo = torch.stack([x_ax[ibx * bx], y_ax[iby * by], z_ax[ibz * bz]], dim=1)
    return _compact_rows(cells, lo, margin, mc, C)


def _build_pts8_t(points_sorted: torch.Tensor,
                  values_sorted: torch.Tensor) -> torch.Tensor:
    """(8, N+pad) candidate store [x, y, z, u, v, w, 0, 0]: sentinel rows
    carry 1e19 coordinates and zero values."""
    V = values_sorted.shape[1]
    n = points_sorted.shape[0]
    z = points_sorted.new_zeros((8 - 3 - V, n))
    return torch.cat([points_sorted.T, values_sorted.T, z], dim=0).contiguous()


def _panel_take(pts8_t: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """(8, N) taken at the (n_blocks·C,) flat indices → (8, n_blocks·C)."""
    return pts8_t.index_select(1, G.reshape(-1))


def _compact_gather(cells: CellList, values_sorted, axes, margin: float,
                    block: Tuple[int, int, int],
                    grid_shape: Tuple[int, int, int],
                    mc: Tuple[int, int, int], C: int,
                    ids=None) -> torch.Tensor:
    """The fused kernel's candidate panel, (8, n_blocks·C) f32."""
    pts8_t = _build_pts8_t(cells.points_sorted, values_sorted)
    G = _compact_indices(cells, axes, margin, block, grid_shape, mc, C,
                         ids=ids)
    return _panel_take(pts8_t, G)


def _build_queries(axes, block: Tuple[int, int, int],
                   dims: Tuple[int, int, int], sz: int, ids=None,
                   device="cpu"):
    """Query coordinates per (block, sub-tile) row: three (n_rows, 1, Bt)
    f32 tensors for x, y, z, rows in (block, sub-tile) order and each row
    in (tz, ty, tx) order. ``ids``: only these flat block indices."""
    bz, by, bx = block
    nbz, nby, nbx = dims
    n_sub = bz // sz
    Bt = sz * by * bx
    dev = torch.device(device)
    x_ax, y_ax, z_ax = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                        for a in axes)
    ids = _block_ids(ids, nbz * nby * nbx, dev)
    n = ids.shape[0]
    ibz = ids // (nby * nbx)
    iby = (ids // nbx) % nby
    ibx = ids % nbx
    shape = (n, n_sub, sz, by, bx)

    def rows(ax, ib, b, view):
        local = torch.arange(b, device=dev)
        return ax[ib[:, None] * b + local[None, :]].reshape(view).expand(shape)

    qx = rows(x_ax, ibx, bx, (n, 1, 1, 1, bx))
    qy = rows(y_ax, iby, by, (n, 1, 1, by, 1))
    qz = rows(z_ax, ibz, bz, (n, n_sub, sz, 1, 1))
    # contiguous rows: at sz = 1 the reshape of an expanded view is a view
    return tuple(q.reshape(n * n_sub, 1, Bt).contiguous()
                 for q in (qx, qy, qz))


# ---------------------------------------------------------------------------
# Phase 2: the τ-bisection weighted-sum kernel and its plain version
# ---------------------------------------------------------------------------

class _Inputs(ctypes.Structure):
    """``Inputs`` of ``csrc/fused_grid_knn.cu``: device pointers."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "starts", "points", "values", "x_ax", "y_ax", "z_ax", "origin",
        "inv_cell", "ids")]


class _Geometry(ctypes.Structure):
    """``Geometry`` of ``csrc/fused_grid_knn.cu``."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n_blocks", "nby", "nbx", "n_sub", "sz", "sy", "sx", "ncx", "ncy",
        "ncz", "mcz", "mcy", "mcx", "C", "k", "V", "mode", "S", "L")] + [
        (name, ctypes.c_float) for name in ("power", "margin", "m2")]


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from ptv_interpolation_tpu_torch.ops.cuda_build import load_library
    lib = load_library("fused_grid_knn")
    lib.fused_grid_knn_launch.argtypes = (
        [ctypes.POINTER(_Inputs), ctypes.POINTER(_Geometry)]
        + [ctypes.c_void_p] * 4)
    lib.fused_grid_knn_launch.restype = ctypes.c_int
    lib.fused_grid_knn_ctas_per_sm.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])
    lib.fused_grid_knn_ctas_per_sm.restype = ctypes.c_int
    lib.fused_grid_knn_error_string.argtypes = [ctypes.c_int]
    lib.fused_grid_knn_error_string.restype = ctypes.c_char_p
    return lib


def _shortlist_plan(C: int, threads: int, need: int,
                    panel: int | None = None) -> Tuple[int, int]:
    """Shared-memory plan of one CTA of the grid or MAD kernel: ``threads``
    threads over a panel of C slots (``panel`` bytes, by default the MAD
    kernel's 16·C), whose τ bisection targets a count of ``need`` (k for
    the grid kernel, k+1 for the MAD kernel). Returns ``(S, bytes)``: S
    u16 shortlist entries per thread (need + 32), or S = 0 where the lists
    do not fit beside the panel (every thread then runs over the whole
    panel), and the dynamic shared memory the launch asks for."""
    panel = 16 * C if panel is None else panel
    S = need + _LIST_SLACK
    if panel + 2 * S * threads > _SMEM_BYTES:
        S = 0
    return S, panel + 2 * S * threads


def _kernel1_ctas(threads: int) -> int:
    """CTAs of ``threads`` threads that one SM holds by registers: the
    launch bounds give ``fused_kernel<256, 3>`` (``threads`` ≤ 256) 768
    threads' worth per SM, ``fused_kernel<1024, 1>`` 1 024."""
    return max(1, (768 if threads <= 256 else 1024) // threads)


def _kernel1_plan(C: int, threads: int, k: int,
                  rows: int) -> Tuple[int, int, int]:
    """Shared-memory plan of one CTA of kernel 1: ``threads`` threads
    over a panel of C slots staged from ``rows`` = mcz·mcy CSR rows (12·C
    bytes of x, y, z, a 32-byte bounding box and 6 bytes of the runs'
    table for each 32 slots, and 4 bytes a row), a
    shortlist of S entries per thread as :func:`_shortlist_plan` plans it
    for a count of k, then, in what is left of an SM's shared memory at
    the CTAs per SM that the rest and the registers allow, a u16 list of
    L ≤ C entries per warp. L = 0 (no warp lists: every warp passes over
    the panel) where fewer than ``_WARP_LIST_MIN`` entries fit or the
    threads do not fill whole warps. Returns ``(S, L, bytes)``, bytes
    being the dynamic shared memory the launch asks for."""
    S, base = _shortlist_plan(C, threads, k,
                              panel=12 * C + 38 * -(-C // 32) + 4 * rows)
    if threads % _WARP:
        return S, 0, base
    warps = threads // _WARP
    ctas = min(_kernel1_ctas(threads), _SMEM_SM // (base + _SMEM_CTA))
    room = min(_SMEM_SM // max(ctas, 1) - _SMEM_CTA, _SMEM_BYTES) - base
    L = min(room // (2 * warps), C)
    if L < _WARP_LIST_MIN:
        L = 0
    return S, L, base + 2 * L * warps


def _check_eval(mode: str, V: int, k: int):
    if mode not in _MODES:
        raise ValueError(f"mode must be 'idw' or 'sibson', got {mode!r}")
    if not 1 <= V <= 5:
        raise ValueError(f"V={V} channels: the panel holds 1 to 5")
    if k < 1:
        raise ValueError(f"k={k}: need at least one neighbour")


def _fused_eval(m2: float, cand: torch.Tensor, qx_all: torch.Tensor,
                qy_all: torch.Tensor, qz_all: torch.Tensor,
                block: Tuple[int, int, int], sz: int, k: int, V: int, C: int,
                mode: str, power: float,
                tau2: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 2 over every (block, sub-tile) row of phase 1's panel, on
    the CPU: returns (n_blocks, n_sub, 8, Bt) f32 with rows ``out[c] =
    Σw·v_c / max(Σw, 1e-37)`` for the V channels, ``out[V] = Σw`` where
    the node is covered (≥ k candidates within the margin, ``m2`` =
    margin² as an f32 value) and 0 where it is not, and zeros after.

    ``cand`` is the (8, n_blocks·C) panel of :func:`_compact_gather`,
    ``q*_all`` the (n_blocks·n_sub, 1, Bt) rows of :func:`_build_queries`.
    It runs :func:`_fused_eval_plain` in the span ``ptv.grid.kernel1``;
    the kernel is reached through :func:`_fused_eval_cells`, which needs
    no panel. ``tau2`` (optional, (n_blocks·n_sub, Bt) f32, contiguous,
    on cand's device) receives every node's τ²."""
    bz, by, bx = block
    n_sub = bz // sz
    Bt = sz * by * bx
    _check_eval(mode, V, k)
    if cand.dtype != torch.float32 or cand.dim() != 2 or cand.shape[0] != 8 \
            or C <= 0 or cand.shape[1] % C:
        raise ValueError(f"cand must be (8, n_blocks*{C}) float32, got "
                         f"{tuple(cand.shape)} {cand.dtype}")
    n_blocks = cand.shape[1] // C
    for q in (qx_all, qy_all, qz_all):
        if q.dtype != torch.float32 or tuple(q.shape) != (n_blocks * n_sub,
                                                          1, Bt):
            raise ValueError(f"queries must be ({n_blocks * n_sub}, 1, {Bt}) "
                             f"float32, got {tuple(q.shape)} {q.dtype}")
        if q.device != cand.device:
            raise ValueError("cand and queries must be on one device")
    _check_tau2(tau2, n_blocks * n_sub, Bt, cand.device)
    if cand.device.type != "cpu":
        raise ValueError(f"unsupported device {cand.device}: the panel's "
                         f"evaluation is the CPU's plain version")
    with span("ptv.grid.kernel1", n_blocks=n_blocks, C=C):
        if tau2 is not None:
            tau2.copy_(_fused_tau2_plain(m2, cand, qx_all, qy_all, qz_all,
                                         block, sz, k, C))
        return _fused_eval_plain(m2, cand, qx_all, qy_all, qz_all, block,
                                 sz, k, V, C, mode, power)


def _check_tau2(tau2, n_rows: int, Bt: int, device):
    if tau2 is not None and (
            tau2.dtype != torch.float32 or tuple(tau2.shape) != (n_rows, Bt)
            or tau2.device != device or not tau2.is_contiguous()):
        raise ValueError(f"tau2 must be a contiguous ({n_rows}, {Bt}) "
                         f"float32 tensor on {device}")


def _fused_eval_cells(cells: CellList, values_sorted: torch.Tensor, axes,
                      margin: float, m2: float, block: Tuple[int, int, int],
                      grid_shape: Tuple[int, int, int],
                      mc: Tuple[int, int, int], C: int, k: int, mode: str,
                      power: float, ids=None,
                      tau2: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 1 over the blocks ``ids`` (flat block indices, a host array
    or a device tensor, in this order; every block where None) of the
    ``grid_shape`` grid whose axes, padded to whole blocks, are ``axes``:
    returns (n_blocks, n_sub, 8, Bt) f32, the rows :func:`_fused_eval`
    gives on phase 1's panel of width ``C`` at ``margin`` (an f32 region
    of ``mc`` cells) and on its query rows. ``m2`` is the f32 margin² of
    the coverage and the halvings.

    On a CUDA device it launches ``csrc/fused_grid_knn.cu``, which stages
    each block's candidates from ``cells`` and ``values_sorted`` and forms
    its nodes' coordinates from the axes: the same slots in the same
    order, so the same d², τ² and sums, with no panel in device memory.
    Counters: ``kernel1.launches``; and five device counts:
    ``kernel1.overflow``, the nodes whose shortlist did not fit;
    ``kernel1.list_slots``, the slots on the warps' lists;
    ``kernel1.list_overflow``, the warps whose list did not fit and which
    passed over the panel; ``kernel1.edge_spill``, the nodes whose τ² lay
    past the last bucket of their shortlist, which summed over their
    warp's list instead; ``kernel1.staged_slots``, the real candidates
    staged, once per block. On the CPU it runs phase 1 (the span
    ``ptv.grid.panel``) and :func:`_fused_eval`. Either runs in the span
    ``ptv.grid.kernel1``. ``tau2`` (optional, (n_blocks·n_sub, Bt) f32,
    contiguous, on the cells' device) receives every node's τ²."""
    bz, by, bx = block
    nz, ny, nx = grid_shape
    dims = (_block_counts(nz, bz), _block_counts(ny, by),
            _block_counts(nx, bx))
    sz = _pick_sz(bz, by, bx)
    V = values_sorted.shape[1]
    dev = cells.device
    if dev.type == "cpu":
        with span("ptv.grid.panel"):
            cand = _compact_gather(cells, values_sorted, axes, margin, block,
                                   grid_shape, mc, C, ids=ids)
            q = _build_queries(axes, block, dims, sz, ids=ids, device=dev)
        return _fused_eval(m2, cand, *q, block, sz, k, V, C, mode, power,
                           tau2=tau2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_eval(mode, V, k)
    n_sub = bz // sz
    Bt = sz * by * bx
    if Bt > 1024:
        raise ValueError(f"sub-tile of {Bt} nodes exceeds 1024 threads")
    if C <= 0 or C % 32:
        raise ValueError(f"panel width C={C} must be a positive multiple "
                         f"of 32")
    if ids is not None:
        ids = torch.as_tensor(ids, dtype=torch.int64, device=dev).contiguous()
    n_blocks = dims[0] * dims[1] * dims[2] if ids is None else ids.shape[0]
    _check_tau2(tau2, n_blocks * n_sub, Bt, dev)
    store = (cells.points_sorted, values_sorted, cells.origin,
             cells.inv_cell)
    if (cells.starts.dtype != torch.int32 or cells.starts.device != dev
            or not cells.starts.is_contiguous()
            or any(t.dtype != torch.float32 or t.device != dev
                   or not t.is_contiguous() for t in store)):
        raise ValueError("the cell list's starts (int32), points, values, "
                         "origin and inverse cell size (float32) must be "
                         "contiguous, on one device")
    rows = mc[0] * mc[1]
    S, L, smem = _kernel1_plan(C, Bt, int(k), rows)
    if smem > _SMEM_BYTES:
        raise ValueError(f"panel width C={C} over {rows} rows exceeds the "
                         f"kernel's shared memory (227 KB)")
    with span("ptv.grid.kernel1", n_blocks=n_blocks, C=C):
        out = torch.empty((n_blocks, n_sub, 8, Bt), dtype=torch.float32,
                          device=dev)
        if n_blocks == 0:
            return out
        lib = _kernel_lib()
        # the three padded axes in one upload, from pinned memory so that
        # the host does not wait for the stream
        ax = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.float32) for a in axes])).pin_memory().to(
                dev, non_blocking=True)
        at = np.cumsum([0] + [len(a) for a in axes[:2]]) * 4
        counts = torch.zeros(5, dtype=torch.int64, device=dev)
        inputs = _Inputs(
            cells.starts.data_ptr(), cells.points_sorted.data_ptr(),
            values_sorted.data_ptr(), ax.data_ptr() + int(at[0]),
            ax.data_ptr() + int(at[1]), ax.data_ptr() + int(at[2]),
            cells.origin.data_ptr(), cells.inv_cell.data_ptr(),
            None if ids is None else ids.data_ptr())
        ncx, ncy, ncz = cells.dims
        geometry = _Geometry(
            n_blocks, dims[1], dims[2], n_sub, sz, by, bx, ncx, ncy, ncz,
            *mc, C, int(k), V, _MODES[mode], S, L, float(power),
            float(np.float32(margin)), float(m2))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fused_grid_knn_launch(
                ctypes.byref(inputs), ctypes.byref(geometry), out.data_ptr(),
                None if tau2 is None else tau2.data_ptr(), counts.data_ptr(),
                stream)
        if err != 0:
            msg = lib.fused_grid_knn_error_string(err).decode()
            raise RuntimeError(f"fused_grid_knn kernel launch failed: {msg} "
                               f"(cudaError {err})")
        count("kernel1.launches")
        count("kernel1.overflow", counts[0:1])
        count("kernel1.list_slots", counts[1:2])
        count("kernel1.list_overflow", counts[2:3])
        count("kernel1.edge_spill", counts[3:4])
        count("kernel1.staged_slots", counts[4:5])
        return out


def _fused_tau2_plain(m2: float, cand: torch.Tensor, qx_all: torch.Tensor,
                      qy_all: torch.Tensor, qz_all: torch.Tensor,
                      block: Tuple[int, int, int], sz: int, k: int,
                      C: int) -> torch.Tensor:
    """Every node's τ² as :func:`_fused_eval_plain` forms it (the same d²
    and halvings, in the same f32 op order): (n_blocks·n_sub, Bt) f32. The
    kernel's τ² output is held bit-equal to it."""
    bz, by, bx = block
    n_sub = bz // sz
    Bt = sz * by * bx
    n_blocks = cand.shape[1] // C
    n_rows = n_blocks * n_sub
    panel = cand.view(8, n_blocks, C)
    m2 = torch.tensor(np.float32(m2), device=cand.device)
    out = cand.new_zeros((n_rows, Bt))
    step = max(1, _PLAIN_ELEMS // (Bt * C))
    for r0 in range(0, n_rows, step):
        r1 = min(r0 + step, n_rows)
        blk = torch.arange(r0, r1, device=cand.device) // n_sub
        c = panel[:3, blk]                                  # (3, r, C)
        q = [a[r0:r1].transpose(1, 2) for a in (qx_all, qy_all, qz_all)]
        d = q[0] - c[0][:, None, :]
        d2 = d * d
        d = q[1] - c[1][:, None, :]
        d2 = d2 + d * d
        d = q[2] - c[2][:, None, :]
        d2 = d2 + d * d                                     # (r, Bt, C)
        lo = torch.zeros_like(d2[..., :1])
        hi = torch.full_like(lo, float(m2))
        for _ in range(_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            short = (d2 <= mid).sum(dim=-1, keepdim=True) < k
            lo = torch.where(short, mid, lo)
            hi = torch.where(short, hi, mid)
        out[r0:r1] = hi[..., 0]
    return out


def _fused_eval_plain(m2: float, cand: torch.Tensor, qx_all: torch.Tensor,
                      qy_all: torch.Tensor, qz_all: torch.Tensor,
                      block: Tuple[int, int, int], sz: int, k: int, V: int,
                      C: int, mode: str, power: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same math as dense
    (rows, Bt, C) panels, chunked over rows. d² is summed as
    ``((dx·dx + dy·dy) + dz·dz)`` in separate ops, the order the kernel
    uses, so both see bit-equal d² and make the same τ choices."""
    bz, by, bx = block
    n_sub = bz // sz
    Bt = sz * by * bx
    n_blocks = cand.shape[1] // C
    n_rows = n_blocks * n_sub
    panel = cand.view(8, n_blocks, C)
    m2 = torch.tensor(np.float32(m2), device=cand.device)
    out = cand.new_zeros((n_rows, 8, Bt))
    step = max(1, _PLAIN_ELEMS // (Bt * C))
    for r0 in range(0, n_rows, step):
        r1 = min(r0 + step, n_rows)
        blk = torch.arange(r0, r1, device=cand.device) // n_sub
        c = panel[:, blk]                                   # (8, r, C)
        q = [a[r0:r1].transpose(1, 2) for a in (qx_all, qy_all, qz_all)]
        d = q[0] - c[0][:, None, :]
        d2 = d * d
        d = q[1] - c[1][:, None, :]
        d2 = d2 + d * d
        d = q[2] - c[2][:, None, :]
        d2 = d2 + d * d                                     # (r, Bt, C)
        del d
        covered = (d2 <= m2).sum(dim=-1) >= k               # (r, Bt)
        lo = torch.zeros_like(d2[..., :1])
        hi = torch.full_like(lo, float(m2))
        for _ in range(_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            short = (d2 <= mid).sum(dim=-1, keepdim=True) < k
            lo = torch.where(short, mid, lo)
            hi = torch.where(short, hi, mid)
        sel = d2 <= hi                  # the τ mask, in the squared domain
        dd = torch.sqrt(torch.clamp_min(d2, 0.0))
        del d2
        zero = torch.zeros((), device=cand.device)
        if mode == "idw":
            p = dd * dd if power == 2.0 else dd ** power
            w = torch.where(sel, 1.0 / (p + _EPS), zero)
        else:
            n_ok = torch.clamp_min(sel.sum(dim=-1, keepdim=True).float(), 1.0)
            mean = torch.where(sel, dd, zero).sum(dim=-1, keepdim=True) / n_ok
            e = dd - mean
            var = torch.where(sel, e * e, zero).sum(dim=-1, keepdim=True) / n_ok
            std = torch.sqrt(var)
            dmin = torch.where(sel, dd, 3.4e38).amin(dim=-1, keepdim=True)
            dmin = torch.where(dmin > 1e18, zero, dmin)
            w = torch.where(sel, (1.0 / (dd + _EPS))
                            * torch.exp(-(dd - dmin) / (std + _EPS)), zero)
        den = w.sum(dim=-1)                                 # (r, Bt)
        inv_den = 1.0 / torch.clamp_min(den, 1e-37)
        for ch in range(V):
            out[r0:r1, ch] = (w * c[3 + ch][:, None, :]).sum(dim=-1) * inv_den
        out[r0:r1, V] = torch.where(covered, den, zero)
    return out.view(n_blocks, n_sub, 8, Bt)


# ---------------------------------------------------------------------------
# Host side: capacity planning and the entry point
# ---------------------------------------------------------------------------

def _block_total_capacity(cells: CellList, axes_np, margin: float,
                          block: Tuple[int, int, int],
                          grid_shape: Tuple[int, int, int],
                          mc: Tuple[int, int, int], ids=None,
                          site: str = "block_capacity") -> int:
    """Maximum candidate count over the blocks (or over ``ids`` only):
    the panel width C before rounding. Per-block totals come from an
    integral image of the CSR row counts, computed where ``starts``
    lives; one scalar crosses to the host (the wait ``site``)."""
    bz, by, bx = block
    nz, ny, nx = grid_shape
    nbz, nby, nbx = (_block_counts(nz, bz), _block_counts(ny, by),
                     _block_counts(nx, bx))
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    x_ax, y_ax, z_ax = axes_np
    origin, inv = cell_meta_np(cells)
    inv = np.float32(inv)
    # the window base MUST be computed in f32 in the phase-1 op order
    # ((lo - margin) - origin) * inv: in f64 the floor can land one cell
    # off when the product sits within an f32 ulp of an integer,
    # under-sizing C and silently truncating candidates that the coverage
    # sentinel would never flag
    m32 = np.float32(margin)

    def base(ax, n_b, b, o):
        lo = np.asarray(ax)[np.arange(n_b) * b].astype(np.float32)
        return np.floor(((lo - m32) - o) * inv).astype(np.int64)

    base_x = base(x_ax, nbx, bx, origin[0])
    base_y = base(y_ax, nby, by, origin[1])
    base_z = base(z_ax, nbz, bz, origin[2])
    dev = cells.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    x0 = t(np.clip(base_x, 0, ncx))
    x1 = t(np.clip(base_x + mcx, 0, ncx))
    counts = torch.diff(cells.starts).reshape(ncz * ncy, ncx).to(torch.int64)
    csum = torch.cat([counts.new_zeros((ncz * ncy, 1)),
                      torch.cumsum(counts, dim=1)], dim=1)
    W = (csum[:, x1] - csum[:, x0]).reshape(ncz, ncy, nbx)
    Wp = W.new_zeros((ncz + 2 * mcz, ncy + 2 * mcy, nbx))
    Wp[mcz:mcz + ncz, mcy:mcy + ncy] = W
    cz_idx = t(np.clip(base_z[:, None] + np.arange(mcz)[None, :] + mcz,
                       0, ncz + 2 * mcz - 1))
    cy_idx = t(np.clip(base_y[:, None] + np.arange(mcy)[None, :] + mcy,
                       0, ncy + 2 * mcy - 1))
    T1 = Wp[cz_idx].sum(dim=1)                      # (nbz, ncy+2mcy, nbx)
    tot = T1[:, cy_idx, :].sum(dim=2)               # (nbz, nby, nbx)
    if ids is not None:
        tot = tot.reshape(-1)[t(ids)]
    if not tot.numel():
        return 1
    with wait(site):
        return int(tot.max().item())


def _pick_sz(bz: int, by: int, bx: int, target: int = 256) -> int:
    """Largest divisor of bz with a sub-tile of sz·by·bx ≤ target nodes —
    the kernel's threads per CTA."""
    best = 1
    for sz in range(1, bz + 1):
        if bz % sz == 0 and sz * by * bx <= target:
            best = sz
    return best


def _panel_width(C_raw: int) -> int:
    return max((C_raw + 127) // 128 * 128, 128)


class FusedCapacityError(ValueError):
    """The compacted candidate panel would exceed ``max_panel``."""


def fused_block_sums(cells: CellList, values_sorted, axes, margin: float,
                     block: Tuple[int, int, int],
                     grid_shape: Tuple[int, int, int],
                     mc: Tuple[int, int, int], C: int, k: int, mode: str,
                     power: float):
    """The fused kernel over every block of the ``grid_shape`` grid whose
    (padded) axes are ``axes``: the candidate panel of width ``C``, the
    query rows, one launch, and the rows put back in node order. Returns
    ``(field, den)``, (nz, ny, nx, V) and (nz, ny, nx); ``den`` is 0 on
    uncovered nodes. The one-device path runs it on the whole grid, the
    z-slab-sharded path on each rank's slab and store window."""
    out = _fused_main_pass(cells, values_sorted, axes, margin, block,
                           grid_shape, mc, C, k, mode, power)
    return _fused_reassemble(out, block, grid_shape, values_sorted.shape[1])


def _fused_main_pass(cells: CellList, values_sorted, axes, margin: float,
                     block, grid_shape, mc, C: int, k: int, mode: str,
                     power: float) -> torch.Tensor:
    """Kernel 1 over every block (:func:`_fused_eval_cells`, m2 the f32
    rounding of margin²): the kernel's (n_blocks, n_sub, 8, Bt) rows."""
    return _fused_eval_cells(cells, values_sorted, axes, margin,
                             np.float32(margin * margin), block, grid_shape,
                             mc, C, int(k), mode, float(power))


def _fused_reassemble(out: torch.Tensor, block, grid_shape, V: int):
    """The main pass's rows in node order, in the span
    ``ptv.grid.reassemble``: ``(field, den)``."""
    bz, by, bx = block
    nz, ny, nx = grid_shape
    dims = (_block_counts(nz, bz), _block_counts(ny, by),
            _block_counts(nx, bx))
    with span("ptv.grid.reassemble"):
        out = _reassemble(out, block, dims, _pick_sz(bz, by, bx), grid_shape)
    return out[..., :V], out[..., V]


def fused_grid_weighted_interpolate(points, values, grid: Grid, k: int,
                                    mode: str = "sibson", power: float = 2.0,
                                    block: Tuple[int, int, int] | None = None,
                                    margin_factor: float = 1.45,
                                    skip_mask=None, max_panel: int = 8192,
                                    device="cuda") -> torch.Tensor:
    """IDW/sibson onto ``grid`` via the fused two-phase kernel on
    ``device``. Returns an (nz, ny, nx, V) tensor with uncovered nodes
    repaired exactly.

    Spans: ``ptv.grid.prepare`` (the host's path up to kernel 1's main
    launch: ``.upload``, ``.cells``, ``.capacity``, ``.panel``,
    ``.kernel1``), ``ptv.grid.reassemble``, ``ptv.grid.repair``."""
    dev = resolve_device(device)
    with span("ptv.grid.prepare"):
        with span("ptv.grid.upload"):
            pts = as_f32(points, dev)
            vals = as_f32(values, dev)
        if block is None:
            block = (4, 8, 16) if skip_mask is not None else (8, 8, 16)
        block = tuple(block)

        with span("ptv.grid.cells"):
            cells, values_sorted, axes, margin, mc, _row_len, vals = \
                _host_setup(pts, vals, grid, k, block, margin_factor,
                            cell_divisor=3.0, device=dev)
        with span("ptv.grid.capacity") as sp:
            C = _panel_width(_block_total_capacity(cells, axes, margin, block,
                                                   grid.shape, mc))
            sp.set(C=C)
        if C > max_panel:
            raise FusedCapacityError(
                f"compacted candidate panel {C} exceeds max_panel={max_panel}")
        out = _fused_main_pass(cells, values_sorted, axes, margin, block,
                               grid.shape, mc, C, k, mode, power)
    field, den = _fused_reassemble(out, block, grid.shape,
                                   values_sorted.shape[1])
    del out                       # the kernel's rows, before the repair
    return repair_empty_nodes(field, den, pts, vals, grid, k, mode, power,
                              cells=cells, margin=margin,
                              skip_mask=skip_mask,
                              values_sorted=values_sorted, block=block)


# ---------------------------------------------------------------------------
# Repair: the same kernel at a widened margin over the uncovered blocks
# ---------------------------------------------------------------------------

REPAIR_MARGIN_FACTOR = 1.6   # the repair's margin, in kNN margins
_REPAIR_PANEL_MAX = 8192     # widest panel the repair runs kernel 1 on


def _repair_plan(cells: CellList, grid: Grid, block, margin: float):
    """The widened-margin repair's geometry, one for the one-device and
    the sharded repair: ``(margin2, mc2, axes2)``, the margin times
    :data:`REPAIR_MARGIN_FACTOR`, a block's candidate region at that
    margin in cells (z, y, x), and the grid's axes padded to the block.
    A domain corner's k-th neighbour sits at ~2× the bulk k-th radius
    (only an octant of its neighbourhood exists); 1.6 × the margin of
    1.45·r_k is ~2.3·r_k."""
    cell_size = 1.0 / cell_meta_np(cells)[1]
    margin2 = REPAIR_MARGIN_FACTOR * float(margin)
    bz, by, bx = block
    dx, dy, dz = grid.spacing
    mc2 = tuple(int(math.ceil((ext + 2.0 * margin2) / cell_size)) + 1
                for ext in (bx * dx, by * dy, bz * dz))[::-1]
    axes2 = (_pad_axis(grid.x, bx), _pad_axis(grid.y, by),
             _pad_axis(grid.z, bz))
    return margin2, mc2, axes2


def _repair_void(n_bad, n_fix, B: int):
    """The void rule, on ints or arrays of them: ``n_fix`` uncovered nodes
    scattered over ``n_bad`` blocks of ``B`` nodes dwarf the repair
    population (void-dominated clouds), where certification would fail
    anyway and the later stages do the work."""
    return n_bad * B > np.maximum(32 * n_fix, 64 * B)


def _repair_survey(den: torch.Tensor, skip, block, dims,
                   nblk_max: int):
    """``[n_fix, n_bad, bad_block_ids...]`` as one (2+nblk_max,) int32
    tensor (ids past ``nblk_max`` cut, the rest padded with -1):
    everything the repair must know before it can launch, pulled to the
    host in one copy; and, as a device tensor, the ids of every block
    that holds an uncovered node, ascending."""
    den_eff = den if skip is None else torch.where(skip, 1.0, den)
    bad = den_eff == 0.0
    bz, by, bx = block
    nbz, nby, nbx = dims
    nz, ny, nx = den.shape
    badp = torch.zeros((nbz * bz, nby * by, nbx * bx), dtype=torch.bool,
                       device=den.device)
    badp[:nz, :ny, :nx] = bad
    blk_bad = badp.reshape(nbz, bz, nby, by, nbx, bx).any(dim=5).any(
        dim=3).any(dim=1)
    with wait("repair.blocks"):
        ids = torch.nonzero(blk_bad.reshape(-1)).squeeze(1)
    out = torch.full((2 + nblk_max,), -1, dtype=torch.int32,
                     device=den.device)
    out[0] = bad.sum()
    out[1] = blk_bad.sum()
    out[2:2 + min(ids.shape[0], nblk_max)] = ids[:nblk_max].to(torch.int32)
    return out, ids


def _fused_repair_apply(field, den, skip, cells: CellList, values_sorted,
                        axes2, margin2: float, ids, block, dims, k: int,
                        V: int, C: int, mode: str, power: float, grid_shape,
                        mc):
    """The repair's evaluation over the blocks ``ids`` (a host array or a
    device tensor) at the widened margin: kernel 1 on their panel of
    width ``C`` when it fits :data:`_REPAIR_PANEL_MAX`, else the streaming
    subset evaluator; then certification (the node was uncovered and is
    covered at the widened margin, ``den2 > 0``) and the scatter of the
    certified nodes. Returns (field', den', n_repaired), ``den'`` 1 where
    a node was repaired or skipped — or None when the panel is too wide
    and no candidate row fits the sorted arrays' padding."""
    bz, by, bx = block
    nz, ny, nx = grid_shape
    nbz, nby, nbx = dims
    B = bz * by * bx
    dev = den.device
    ids = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    n_sel = ids.shape[0]
    den_eff = den if skip is None else torch.where(skip, 1.0, den)

    if C <= _REPAIR_PANEL_MAX:
        # f32 product, as the JAX package forms margin2² on the device
        m2 = np.float32(margin2) * np.float32(margin2)
        sub = _fused_eval_cells(cells, values_sorted, axes2, margin2, m2,
                                block, grid_shape, mc, C, k, mode, power,
                                ids=ids)
        sz = _pick_sz(bz, by, bx)
        # (n_sel, n_sub, 8, Bt) → (n_sel, B, 8) rows in (tz, ty, tx) order
        rows = sub.reshape(n_sel, bz // sz, 8, sz, by * bx)
        rows = rows.permute(0, 1, 3, 4, 2).reshape(n_sel, B, 8)
    else:
        from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
            _idw_panel_weights, _sibson_panel_weights)
        row_len2 = _row_capacity(cells, mc[2])
        if row_len2 > _ROW_PAD:
            return None
        weight_fn = (_idw_panel_weights(power) if mode == "idw"
                     else _sibson_panel_weights())
        rows = _grid_block_weighted_sum_subset(
            cells, values_sorted, axes2, margin2, ids, k, block, grid_shape,
            mc, row_len2, weight_fn)
    vals_new = rows[..., :V]
    den2 = rows[..., V]

    ibz = ids // (nby * nbx)
    iby = (ids // nbx) % nby
    ibx = ids % nbx
    ar = functools.partial(torch.arange, device=dev)
    iz = ibz[:, None, None, None] * bz + ar(bz)[None, :, None, None]
    iy = iby[:, None, None, None] * by + ar(by)[None, None, :, None]
    ix = ibx[:, None, None, None] * bx + ar(bx)[None, None, None, :]
    in_grid = ((iz < nz) & (iy < ny) & (ix < nx)).reshape(n_sel, B)
    flat = ((iz * ny + iy) * nx + ix).reshape(n_sel, B)
    den_at = den_eff.reshape(-1)[flat.clamp(0, nz * ny * nx - 1)]
    valid = in_grid & (den_at == 0.0) & (den2 > 0.0)
    with wait("repair.select"):
        idx = flat[valid]                # unique nodes: one row per node
    field2 = field.reshape(-1, V).clone()
    with wait("repair.select"):
        field2[idx] = vals_new[valid]
    den_out = den_eff.reshape(-1).clone()
    den_out[idx] = 1.0
    with wait("repair.certified"):
        n_rep = int(valid.sum().item())
    return (field2.reshape(grid_shape + (V,)), den_out.reshape(grid_shape),
            n_rep)


def fused_repair(field, den, skip_mask, cells: CellList, values_sorted,
                 grid: Grid, k: int, mode: str, power: float,
                 block: Tuple[int, int, int], margin: float):
    """The widened-margin stage of the repair ladder, over every block
    that holds an uncovered node (:func:`_repair_plan`,
    :func:`_fused_repair_apply`). Returns ``(field', den', n_left)`` —
    ``n_left`` nodes stay uncovered at the widened margin (``den'`` marks
    the repaired ones nonzero so the caller can brute-force only the
    rest) — or ``None`` when this stage does not apply: the void rule
    holds (:func:`_repair_void`), or no evaluator fits the panel. Only
    the survey's counts reach the host; the block ids stay on the
    device."""
    nz, ny, nx = grid.shape
    bz, by, bx = block
    dims = (_block_counts(nz, bz), _block_counts(ny, by),
            _block_counts(nx, bx))
    skip = (None if skip_mask is None else
            torch.as_tensor(skip_mask, dtype=torch.bool, device=den.device))
    survey, ids = _repair_survey(den, skip, block, dims, 0)
    with wait("repair.survey"):
        survey = survey.cpu().numpy()
    n_fix, n_bad = int(survey[0]), int(survey[1])
    if n_fix == 0:
        return field, den, 0
    if _repair_void(n_bad, n_fix, bz * by * bx):
        return None
    margin2, mc2, axes2 = _repair_plan(cells, grid, block, margin)
    C = _panel_width(_block_total_capacity(cells, axes2, margin2, block,
                                           grid.shape, mc2, ids=ids,
                                           site="repair.capacity"))
    res = _fused_repair_apply(
        field, den, skip, cells, values_sorted, axes2, margin2, ids,
        block, dims, int(k), field.shape[-1], C, mode, float(power),
        grid.shape, mc2)
    if res is None:
        return None
    field2, den_out, n_rep = res
    return field2, den_out, n_fix - n_rep


def _reassemble(out: torch.Tensor, block, dims, sz: int,
                grid_shape) -> torch.Tensor:
    """(n_blocks, n_sub, 8, Bt) → (nz, ny, nx, 8) node order."""
    bz, by, bx = block
    nbz, nby, nbx = dims
    nz, ny, nx = grid_shape
    n_sub = bz // sz
    o = out.reshape(nbz, nby, nbx, n_sub, 8, sz, by, bx)
    o = o.permute(0, 3, 5, 1, 6, 2, 7, 4)
    o = o.reshape(nbz * bz, nby * by, nbx * bx, 8)
    return o[:nz, :ny, :nx]
