"""One-phase τ-threshold weighted grid interpolation (``backend='pallas'``).

Counterpart of ``ptv_interpolation_tpu/ops/pallas_grid_knn.py``. One grid
block of ``bz·by·bx`` nodes reads R = mcz·mcy fixed-length windows of L
columns straight from a *gapped* candidate store — the cell-sorted cloud
as (8, store_w) rows x, y, z, u, v, w, 0, 0 with L sentinel columns
(1e19) between consecutive CSR (z, y) rows, so a window never crosses
into another row and needs no validity mask. Each window starts at its
row's first candidate rounded down to a multiple of 128 (the TPU kernel's
DMA alignment): it is a superset of the candidate region, and the
bisection's upper bound depends on it, so the port keeps it exactly.

Per node: hi = max valid d²·(1+1e-6) + 1e-30, τ² by ``bisect_iters``
halvings of [0, hi] (``#{d² ≤ mid} ≥ k`` → hi), IDW weights (1/(d²+ε) at
p = 2, 1/(d^p+ε) otherwise) or sibson weights with a one-pass variance
over the selected set, and Σw·v / max(Σw, 1e-37). There is no coverage
sentinel and no repair: nodes whose k-th neighbour lies outside the
windows get the weighting of what the windows hold.

On a CUDA tensor :func:`_pallas_eval` launches the hand-written kernel
``csrc/pallas_grid_knn.cu``; on a CPU tensor it runs
:func:`_pallas_eval_plain`, the same math in plain PyTorch.
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
from ptv_interpolation_tpu_torch.ops.grid_knn import (_block_counts,
                                                      _block_queries,
                                                      _reassemble_blocks)
from ptv_interpolation_tpu_torch.ops.neighbors import build_cell_list
from ptv_interpolation_tpu_torch.utils import count, span

_BIG = 1e19               # sentinel coordinate of the store's gap columns
_EPS = 1e-10
_MODES = {"idw": 0, "sibson": 1}
_MAX_ROWS = 128           # window starts a block may hold (the TPU's limit)
_PLAIN_ELEMS = 1 << 24    # bound on (blocks × B × C) panels of the plain eval
_SMEM_BYTES = 232448      # shared memory one CTA may use on sm_90
# staged slots per pass: x, y, z (12 bytes) each, within a CTA's 227 KB of
# shared memory beside the window starts; wider panels are staged chunk by
# chunk (and so stay below the 65 536 slots a u16 list entry indexes)
_MAX_CHUNK = (_SMEM_BYTES - 4 * _MAX_ROWS) // 12
# The kernel resolves the first _LIST_AFTER halvings on the staged panel and
# then lists each node's slots with d² ≤ hi. On 128 headline blocks (1M
# points → 256³, k = 50, block (2, 8, 8); tools/measure_pallas_list_counts.py)
# that count reached 3 996 after 4 halvings, 505 after 8 and 79 after 12
# (median 51): after 12, a list of k + _LIST_SLACK entries held every node
# sampled.
_LIST_AFTER = 12
_LIST_SLACK = 48


def _pad_block_axis(ax, b: int, nb: int) -> np.ndarray:
    """Axis coordinates padded to ``nb·b`` entries (f32); the tail
    continues the spacing, computed in the axis' own precision and then
    rounded, as the JAX module pads its axes."""
    out = np.zeros(nb * b, np.float32)
    out[:len(ax)] = ax
    if nb * b > len(ax) > 1:
        step = ax[1] - ax[0]
        out[len(ax):] = ax[-1] + step * np.arange(1, nb * b - len(ax) + 1)
    return out


def pallas_grid_weighted_interpolate(points, values, grid: Grid, k: int,
                                     mode: str = "sibson",
                                     power: float = 2.0,
                                     block: Tuple[int, int, int] = (2, 8, 8),
                                     margin_factor: float = 1.45,
                                     bisect_iters: int = 14,
                                     device="cuda") -> torch.Tensor:
    """IDW/sibson onto ``grid`` through the one-phase kernel on ``device``;
    returns an (nz, ny, nx, 3) tensor there. Raises ``ValueError`` for
    other than 3 value columns, or when a block's region spans more than
    128 rows."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'idw' or 'sibson', got {mode!r}")
    starts, axes, store, dims, L = _pallas_setup(points, values, grid, k,
                                                 block, margin_factor,
                                                 device)
    ids = torch.arange(starts.shape[0], dtype=torch.int32,
                       device=store.device)
    out = _pallas_eval(starts, ids, axes, store, block, dims, L, int(k),
                       mode, float(power), int(bisect_iters))
    return _reassemble_blocks(out[..., :3], block, grid.shape)


def _pallas_setup(points, values, grid: Grid, k: int,
                  block: Tuple[int, int, int], margin_factor: float,
                  device="cuda"):
    """The kernel's inputs, as the JAX package's host side makes them: a
    cell list at cell size = margin (few, fat rows), the static region
    dims ``mc``, the window length L (the widest ``mcx``-cell run of a row
    plus 127 columns of alignment slack, rounded up to 128), the gapped
    store (built on ``device``) and every block's R window starts, with
    out-of-range rows pointing at the store's trailing sentinel columns.
    Node coordinates are not materialised: the kernel derives them from
    the padded axes and the block index.

    Returns ``(starts, axes, store, dims, L)``: (n_blocks, R) int32, the
    padded (x, y, z) f32 axes, (8, store_w) f32, (nbz, nby, nbx)."""
    dev = resolve_device(device)
    pts = as_f32(points, dev)
    vals = as_f32(values, dev)
    if vals.dim() != 2 or vals.shape[1] != 3:
        raise ValueError(f"values must be (N, 3), got {tuple(vals.shape)}")
    n = pts.shape[0]

    lo = pts.amin(dim=0).cpu().numpy()
    hi = pts.amax(dim=0).cpu().numpy()
    extent = np.maximum(hi - lo, 1e-12)
    density = n / float(np.prod(extent))
    r_k = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    cell_size = max(r_k * margin_factor, 1e-6)   # coarse: few, fat rows
    cells = build_cell_list(pts, cell_size=cell_size, device=dev)
    margin = r_k * margin_factor

    bz, by, bx = block
    dx, dy, dz = grid.spacing
    mcz, mcy, mcx = (int(math.ceil((ext + 2.0 * margin) / cell_size)) + 1
                     for ext in (bz * dz, by * dy, bx * dx))
    R = mcz * mcy
    if R > _MAX_ROWS:
        raise ValueError(f"candidate region has {R} rows (>128); use a "
                         f"coarser cell size or smaller blocks")
    ncx, ncy, ncz = cells.dims
    starts_np = cells.starts.cpu().numpy().astype(np.int64)

    # static window length: the widest mcx-cell run of any row, plus the
    # alignment slack of a start rounded down to 128, in whole 128s
    row_counts = np.diff(starts_np).reshape(ncz * ncy, ncx)
    w_win = min(mcx, ncx)
    csum = np.concatenate([np.zeros((row_counts.shape[0], 1), np.int64),
                           np.cumsum(row_counts, axis=1)], axis=1)
    windows = csum[:, w_win:] - csum[:, :-w_win] if ncx > w_win \
        else csum[:, -1:]
    content_max = int(windows.max()) if windows.size else 1
    L = ((content_max + 127 + 127) // 128) * 128

    nz, ny, nx = grid.shape
    nbz, nby, nbx = (_block_counts(nz, bz), _block_counts(ny, by),
                     _block_counts(nx, bx))
    x_blk = _pad_block_axis(grid.x, bx, nbx)
    y_blk = _pad_block_axis(grid.y, by, nby)
    z_blk = _pad_block_axis(grid.z, bz, nbz)

    # host f32 in the JAX module's op order: ((lo - margin) - origin) * inv
    origin = cells.origin_host
    inv = float(np.float32(cells.inv_host))
    base_x = np.floor((x_blk[::bx] - margin - origin[0]) * inv).astype(
        np.int64)
    base_y = np.floor((y_blk[::by] - margin - origin[1]) * inv).astype(
        np.int64)
    base_z = np.floor((z_blk[::bz] - margin - origin[2]) * inv).astype(
        np.int64)

    roz, roy = np.meshgrid(np.arange(mcz), np.arange(mcy), indexing="ij")
    cz = base_z[:, None, None, None] + roz.ravel()[None, None, None, :]
    cy = base_y[None, :, None, None] + roy.ravel()[None, None, None, :]
    cz = np.broadcast_to(cz, (nbz, nby, nbx, R))
    cy = np.broadcast_to(cy, (nbz, nby, nbx, R))
    row_ok = (cz >= 0) & (cz < ncz) & (cy >= 0) & (cy < ncy)
    x0 = np.clip(base_x, 0, ncx)[None, None, :, None]

    # the gapped store: L sentinel columns between consecutive CSR rows
    n_cells = ncx * ncy * ncz
    store_w = ((n + ncz * ncy * L + 2 * L + 127) // 128) * 128
    counts = torch.diff(cells.starts).long()
    row_of_sorted = torch.repeat_interleave(
        torch.arange(n_cells, device=dev), counts, output_size=n) // ncx
    new_pos = torch.arange(n, device=dev) + row_of_sorted * L
    store = torch.full((8, store_w), _BIG, dtype=torch.float32, device=dev)
    store[0:3, new_pos] = cells.points_sorted[:n].T
    store[3:6, new_pos] = vals[cells.order.long()].T
    store[6:8, new_pos] = 0.0

    # window starts in gapped columns; out-of-range rows read the trailing
    # all-sentinel columns
    rid = (cz * ncy + cy) * ncx
    s_idx = np.where(row_ok, rid + x0, 0)
    gap_shift = np.where(row_ok, (rid // ncx) * L, 0)
    starts = np.where(row_ok, starts_np[s_idx] + gap_shift, store_w - L)
    starts = torch.as_tensor(starts.reshape(-1, R).astype(np.int32),
                             device=dev)

    axes = tuple(torch.as_tensor(a, device=dev)
                 for a in (x_blk, y_blk, z_blk))
    return starts, axes, store, (nbz, nby, nbx), L


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from ptv_interpolation_tpu_torch.ops.cuda_build import load_library
    lib = load_library("pallas_grid_knn")
    lib.pallas_grid_knn_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15
        + [ctypes.c_float, ctypes.c_void_p])
    lib.pallas_grid_knn_launch.restype = ctypes.c_int
    lib.pallas_grid_knn_error_string.argtypes = [ctypes.c_int]
    lib.pallas_grid_knn_error_string.restype = ctypes.c_char_p
    return lib


def _list_plan(C: int, B: int, k: int) -> Tuple[int, int, int]:
    """Shared-memory plan of one CTA of the kernel: B threads over a panel
    of C slots. Returns ``(S, chunk, bytes)``: the slots staged at once (C,
    or ``_MAX_CHUNK`` for a wider panel, staged chunk by chunk on every
    pass), S u16 shortlist entries per thread (k + ``_LIST_SLACK``), or
    S = 0 where the panel is chunked or the lists do not fit beside it
    (every thread then runs over the whole panel), and the dynamic shared
    memory the launch asks for: 12 bytes per staged slot, padded to a
    multiple of 4 slots, and 2·S per thread."""
    chunk = min(C, _MAX_CHUNK)
    panel = 12 * (-(-chunk // 4) * 4)
    budget = _SMEM_BYTES - 4 * _MAX_ROWS      # the window starts are static
    S = k + _LIST_SLACK
    if chunk < C or panel + 2 * S * B > budget:
        S = 0
    return S, chunk, panel + 2 * S * B


def _check_inputs(starts, ids, axes, store, block, dims, L: int, mode: str):
    bz, by, bx = block
    if mode not in _MODES:
        raise ValueError(f"mode must be 'idw' or 'sibson', got {mode!r}")
    if starts.dtype != torch.int32 or starts.dim() != 2 \
            or not 1 <= starts.shape[1] <= _MAX_ROWS:
        raise ValueError(f"starts must be (n, R ≤ {_MAX_ROWS}) int32, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    n = starts.shape[0]
    if ids.dtype != torch.int32 or tuple(ids.shape) != (n,):
        raise ValueError(f"ids must be ({n},) int32, got {tuple(ids.shape)} "
                         f"{ids.dtype}")
    if store.dtype != torch.float32 or store.dim() != 2 \
            or store.shape[0] != 8 or store.shape[1] < L or L <= 0:
        raise ValueError(f"store must be (8, W ≥ L={L}) float32, got "
                         f"{tuple(store.shape)} {store.dtype}")
    for a, nb, b in zip(axes, dims[::-1], (bx, by, bz)):
        if a.dtype != torch.float32 or tuple(a.shape) != (nb * b,):
            raise ValueError(f"padded axes must be ({nb * b},) float32, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for t in (ids, *axes):
        if t.device != store.device or starts.device != store.device:
            raise ValueError("starts, ids, axes and store must be on one "
                             "device")


def _pallas_eval(starts: torch.Tensor, ids: torch.Tensor, axes,
                 store: torch.Tensor, block: Tuple[int, int, int],
                 dims: Tuple[int, int, int], L: int, k: int, mode: str,
                 power: float, bisect_iters: int) -> torch.Tensor:
    """The one-phase kernel over the blocks ``ids`` ((n,) int32 flat block
    indices into the (nbz, nby, nbx) lattice ``dims``): ``starts`` (n, R)
    int32 are their window starts into ``store`` (8, store_w) f32, and
    ``axes`` the padded (x, y, z) f32 axes. Returns (n, B, 4) f32, nodes in
    local (z, y, x) order: Σw·v_c / max(Σw, 1e-37) for the three channels
    and τ² in column 3.

    On CUDA tensors this launches ``csrc/pallas_grid_knn.cu`` (counters
    ``kernel3.launches`` and ``kernel3.overflow``, a device count of the
    nodes whose shortlist did not fit and which ran over the whole panel);
    on CPU tensors it runs :func:`_pallas_eval_plain`. Either runs in the
    span ``ptv.grid.kernel3``."""
    _check_inputs(starts, ids, axes, store, block, dims, L, mode)
    with span("ptv.grid.kernel3", n_blocks=ids.shape[0]):
        if store.device.type == "cpu":
            return _pallas_eval_plain(starts, ids, axes, store, block, dims, L,
                                      k, mode, power, bisect_iters)
        if store.device.type != "cuda":
            raise ValueError(f"unsupported device {store.device}")
        bz, by, bx = block
        B = bz * by * bx
        n, R = starts.shape
        if B > 1024:
            raise ValueError(f"block of {B} nodes exceeds 1024 threads")
        if store.shape[1] >= 2 ** 31:
            raise ValueError(f"store of {store.shape[1]} columns exceeds "
                             f"int32")
        if not all(t.is_contiguous() for t in (starts, ids, store, *axes)):
            raise ValueError("starts, ids, axes and store must be contiguous")
        S, chunk, _ = _list_plan(R * L, B, int(k))
        lib = _kernel_lib()
        out = torch.empty((n, B, 4), dtype=torch.float32, device=store.device)
        if n == 0:
            return out
        overflow = torch.zeros(1, dtype=torch.int32, device=store.device)
        with torch.cuda.device(store.device):
            stream = torch.cuda.current_stream(store.device).cuda_stream
            err = lib.pallas_grid_knn_launch(
                starts.data_ptr(), ids.data_ptr(), axes[0].data_ptr(),
                axes[1].data_ptr(), axes[2].data_ptr(), store.data_ptr(),
                out.data_ptr(), overflow.data_ptr(), store.shape[1], n, R, L,
                chunk, S, B, by, bx, dims[1], dims[2], int(k), _MODES[mode],
                max(int(bisect_iters), 0), _LIST_AFTER, float(power), stream)
        if err != 0:
            msg = lib.pallas_grid_knn_error_string(err).decode()
            raise RuntimeError(f"pallas_grid_knn kernel launch failed: {msg} "
                               f"(cudaError {err})")
        count("kernel3.launches")
        count("kernel3.overflow", overflow)
        return out


def _sum_f32(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis accumulated in f64, rounded once to f32 (as
    the kernel accumulates): the one-pass variance s2 − s1² cancels, and
    f32 sums in two orders would differ by more than its tolerance."""
    return x.sum(dim=-1, keepdim=True, dtype=torch.float64).float()


def _pallas_eval_plain(starts: torch.Tensor, ids: torch.Tensor, axes,
                       store: torch.Tensor, block: Tuple[int, int, int],
                       dims: Tuple[int, int, int], L: int, k: int, mode: str,
                       power: float, bisect_iters: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same math as dense
    (blocks, B, C) panels, C = R·L less the sentinel columns, chunked over
    blocks. Every f32 step
    follows the JAX kernel's op order — d² = (dx² + dy²) + dz², hi, mid =
    0.5·(lo + hi), ``n_in ≥ k`` with k not clamped to C, sel = d² ≤ τ² —
    so d² and τ² are bit-equal to the CUDA kernel's."""
    _, nby, nbx = dims
    n, R = starts.shape
    C = R * L
    dev = store.device
    qx, qy, qz, _ = _block_queries(axes, block, nby, nbx, ids.long())
    B = qx.shape[1]
    out = store.new_empty((n, B, 4))
    lane = torch.arange(L, device=dev)
    zero = torch.zeros((), device=dev)
    step = max(1, _PLAIN_ELEMS // (B * C))
    for s in range(0, n, step):
        st = starts[s:s + step].long()
        g = st.shape[0]
        cols = ((st // 128) * 128)[:, :, None] + lane        # (g, R, L)
        c = store[:, cols.reshape(g, C)]                      # (8, g, C)
        # gap columns hold 1e19 in every row: they never bound hi, never
        # count and are never selected, so only the real ones are kept
        real = c[0] < _BIG * 0.5
        width = max(int(real.sum(dim=1).max()), 1)
        keep = torch.argsort((~real).to(torch.int8), dim=1,
                             stable=True)[:, :width]
        c = torch.gather(c, 2, keep[None].expand(8, g, width))
        d = qx[s:s + g, :, None] - c[0][:, None, :]
        d2 = d * d
        d = qy[s:s + g, :, None] - c[1][:, None, :]
        d2 = d2 + d * d
        d = qz[s:s + g, :, None] - c[2][:, None, :]
        d2 = d2 + d * d                                       # (g, B, C)
        del d
        lo = torch.zeros_like(d2[..., :1])
        hi = (torch.where(d2 < _BIG * 0.5, d2, zero).amax(dim=-1,
                                                          keepdim=True)
              * (1.0 + 1e-6) + 1e-30)
        for _ in range(bisect_iters):
            mid = 0.5 * (lo + hi)
            ge = (d2 <= mid).sum(dim=-1, keepdim=True) >= k
            hi = torch.where(ge, mid, hi)
            lo = torch.where(ge, lo, mid)
        sel = d2 <= hi
        if mode == "idw":
            p = d2 if power == 2.0 else d2 ** (power * 0.5)
            w = 1.0 / (p + _EPS)
        else:
            dd = torch.sqrt(torch.clamp_min(d2, 0.0))
            d_sel = torch.where(sel, dd, zero)
            n_sel = torch.clamp_min(sel.sum(dim=-1, keepdim=True).float(),
                                    1.0)
            s1 = _sum_f32(d_sel) / n_sel
            s2 = _sum_f32(d_sel * d_sel) / n_sel
            std = torch.sqrt(torch.clamp_min(s2 - s1 * s1, 0.0))
            dmin = torch.where(sel, dd, _BIG).amin(dim=-1, keepdim=True)
            w = (1.0 / (dd + _EPS)) * torch.exp(-(dd - dmin) / (std + _EPS))
        w = torch.where(sel, w, zero)      # select: unselected w may be inf
        den = torch.clamp_min(_sum_f32(w)[..., 0], 1e-37)
        for ch in range(3):
            out[s:s + g, :, ch] = _sum_f32(w * c[3 + ch][:, None, :])[..., 0] / den
        out[s:s + g, :, 3] = hi[..., 0]
    return out
