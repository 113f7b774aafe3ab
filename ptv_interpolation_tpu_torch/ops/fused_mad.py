"""Fused panel kNN-MAD outlier filter: order statistics by counting
bisection, no sort, no per-query gathers.

Counterpart of ``ptv_interpolation_tpu/ops/fused_mad.py``. The reference
filter takes, for each point, its k+1 nearest (self included), then the
median and the MAD of the k neighbour *speeds*. Every statistic it needs
is an order statistic, so each is a monotone counting problem over a
panel of nearby candidates:

* the (k+1)-th distance τ      = bisect t: #{d² ≤ t} ≥ k+1
* the j-th smallest speed      = bisect t: #{s ≤ t, d² ≤ τ²} − [s₀ ≤ t] ≥ j
* the j-th smallest |s − med|  = the same, on the shifted speeds

(``s₀`` is the query's own speed: subtracting its indicator drops exactly
one self-copy, which also handles coincident points the way the
reference's ``idx[:, 1:]`` does.) The median follows ``np.median`` on k
values: the mean of the ⌈k/2⌉-th and (⌊k/2⌋+1)-th order statistics (one
bisection when k is odd), each pinned to ``range · 2⁻²⁴`` by 24 halvings.

Queries are the points themselves, bucketed on the host into spatial
blocks of edge 2·margin; each occupied block shares one compacted
candidate gather (``fused_grid_knn._compact_rows``). :func:`_mad_eval`
runs the statistics: on a CUDA tensor it launches the hand-written kernel
``csrc/fused_mad.cu``; on a CPU tensor it runs :func:`_mad_eval_plain`, a
dense transcription of the same math in the same f32 op order.

The candidate panel holds the four rows the statistics read, x, y, z and
speed, where the JAX package carries eight (four of them zero).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.utils import count, span
from ptv_interpolation_tpu_torch.ops.fused_grid_knn import (_SMEM_BYTES,
                                                          _compact_rows,
                                                          _shortlist_plan)
from ptv_interpolation_tpu_torch.ops.neighbors import (CellList,
                                                       build_cell_list,
                                                       cell_meta_np)

_BISECT = 24
_PAD_ROWS = 1024           # sentinel rows after the cell-sorted arrays
_PLAIN_ELEMS = 1 << 26     # bound on (blocks × Bt × C) panels of the plain eval
_SUB_TILE = 256            # queries per CTA of the kernel


# ---------------------------------------------------------------------------
# Candidate panel and query rows
# ---------------------------------------------------------------------------

def _compact_indices_scatter(cells: CellList, lo_blocks, margin: float,
                             mc: Tuple[int, int, int], C: int) -> torch.Tensor:
    """Scatter-block analogue of ``fused_grid_knn._compact_indices``: the
    block lows come from an (n_blocks, 3) f32 array instead of grid axes.
    Returns (n_blocks, C) int32 source rows (sentinel row for empty
    slots)."""
    lo = torch.as_tensor(lo_blocks, dtype=torch.float32, device=cells.device)
    return _compact_rows(cells, lo, margin, mc, C)


def _build_store_t(points_sorted: torch.Tensor,
                   speed_sorted: torch.Tensor) -> torch.Tensor:
    """(4, N+pad) transposed candidate store [x, y, z, speed]."""
    return torch.cat([points_sorted.T, speed_sorted[None, :]],
                     dim=0).contiguous()


def _gather_queries(qrs_pad: torch.Tensor, speed_pad: torch.Tensor,
                    q_table: torch.Tensor):
    """Per-block padded query rows: (n_blocks, 1, Bt) × {x, y, z, s}."""
    nb, Bt = q_table.shape
    q = qrs_pad[q_table]                                  # (nb, Bt, 3)
    s = speed_pad[q_table]                                # (nb, Bt)
    return (q[:, :, 0].reshape(nb, 1, Bt).contiguous(),
            q[:, :, 1].reshape(nb, 1, Bt).contiguous(),
            q[:, :, 2].reshape(nb, 1, Bt).contiguous(),
            s.reshape(nb, 1, Bt).contiguous())


def _lattice_capacity(cells: CellList, q_lo, edge, dims, uniq, margin,
                      mc) -> int:
    """Max compacted candidate count over the occupied scatter blocks —
    host numpy, from the CSR ``starts`` pulled once (the scatter analogue
    of ``fused_grid_knn._block_total_capacity``)."""
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    origin, inv = cell_meta_np(cells)
    inv = np.float32(inv)
    m32 = np.float32(margin)
    starts_np = cells.starts.cpu().numpy().astype(np.int64)
    counts = np.diff(starts_np).reshape(ncz * ncy, ncx)
    csum = np.concatenate([np.zeros((ncz * ncy, 1), np.int64),
                           np.cumsum(counts, axis=1)], axis=1)

    # f32 in the compaction's op order ((lo - margin) - origin) * inv, on
    # the same f32 lows fused_mad_filter hands it (q_lo + idx·edge): in
    # f64 the floor can land one cell off, under-sizing C and dropping
    # candidates that the coverage count would never flag
    lows = [np.float32(q_lo[d])
            + np.arange(dims[d], dtype=np.float32) * np.float32(edge)
            for d in range(3)]
    base = [np.floor(((lows[d] - m32) - origin[d]) * inv).astype(np.int64)
            for d in range(3)]
    x0 = np.clip(base[0], 0, ncx)
    x1 = np.clip(base[0] + mcx, 0, ncx)
    W = (csum[:, x1] - csum[:, x0]).reshape(ncz, ncy, dims[0])
    Wp = np.zeros((ncz + 2 * mcz, ncy + 2 * mcy, dims[0]), np.int64)
    Wp[mcz:mcz + ncz, mcy:mcy + ncy] = W
    cz_idx = np.clip(base[2][:, None] + np.arange(mcz)[None, :] + mcz,
                     0, ncz + 2 * mcz - 1)
    cy_idx = np.clip(base[1][:, None] + np.arange(mcy)[None, :] + mcy,
                     0, ncy + 2 * mcy - 1)
    T1 = Wp[cz_idx].sum(axis=1)                  # (nbz, ncy+2mcy, nbx)
    tot = T1[:, cy_idx, :].sum(axis=2)           # (nbz, nby, nbx)
    # occupied blocks: uniq are flat ids (iz*dims1 + iy)*dims0 + ix
    uz = uniq // (dims[1] * dims[0])
    uy = (uniq // dims[0]) % dims[1]
    ux = uniq % dims[0]
    sel = tot[uz, uy, ux]
    return int(sel.max()) if sel.size else 1


# ---------------------------------------------------------------------------
# The statistics kernel and its plain version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from ptv_interpolation_tpu_torch.ops.cuda_build import load_library
    lib = load_library("fused_mad")
    lib.fused_mad_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.fused_mad_launch.restype = ctypes.c_int
    lib.fused_mad_error_string.argtypes = [ctypes.c_int]
    lib.fused_mad_error_string.restype = ctypes.c_char_p
    return lib


def _mad_eval(m2: float, cand: torch.Tensor, qx: torch.Tensor,
              qy: torch.Tensor, qz: torch.Tensor, qs: torch.Tensor, k: int,
              threshold: float, Bt: int, C: int) -> torch.Tensor:
    """The filter statistics of every query slot: returns (n_blocks, 8,
    Bt) f32 with rows

    0. keep + 2·covered — keep: ``|s₀ − med| ≤ thr·(mad + 1e-6)``;
       covered: ≥ k+1 candidates within the margin (``m2`` = margin² as
       an f32 value) and a decision outside the bisection's error bound;
    1. the (k+1)-th distance √τ² (self included), +inf on padding slots
       (qx ≥ 1e18);
    2. med; 3. mad; 4–7. zero.

    ``cand`` is the (4, n_blocks·C) panel [x, y, z, speed]; ``q*`` the
    (n_blocks, 1, Bt) query rows. On CUDA tensors this launches the
    kernel (counters ``kernel2.launches`` and ``kernel2.overflow``, a
    device count of the real (not padding) queries whose shortlist did not
    fit and which ran over the whole panel); on CPU tensors it runs
    :func:`_mad_eval_plain`. Either runs in the span
    ``ptv.filter.kernel2``."""
    if cand.dtype != torch.float32 or cand.dim() != 2 or cand.shape[0] != 4 \
            or C <= 0 or cand.shape[1] % C:
        raise ValueError(f"cand must be (4, n_blocks*{C}) float32, got "
                         f"{tuple(cand.shape)} {cand.dtype}")
    n_blocks = cand.shape[1] // C
    for q in (qx, qy, qz, qs):
        if q.dtype != torch.float32 or tuple(q.shape) != (n_blocks, 1, Bt):
            raise ValueError(f"queries must be ({n_blocks}, 1, {Bt}) "
                             f"float32, got {tuple(q.shape)} {q.dtype}")
        if q.device != cand.device:
            raise ValueError("cand and queries must be on one device")
    if k < 1:
        raise ValueError(f"k={k}: need at least one neighbour")
    with span("ptv.filter.kernel2", n_blocks=n_blocks, C=C):
        if cand.device.type == "cpu":
            return _mad_eval_plain(m2, cand, qx, qy, qz, qs, k, threshold,
                                   Bt, C)
        if cand.device.type != "cuda":
            raise ValueError(f"unsupported device {cand.device}")
        if not all(t.is_contiguous() for t in (cand, qx, qy, qz, qs)):
            raise ValueError("cand and queries must be contiguous")
        sub = min(Bt, _SUB_TILE)
        S, smem = _shortlist_plan(C, sub, int(k) + 1)
        if smem > _SMEM_BYTES:
            raise ValueError(f"panel width C={C} exceeds the kernel's shared "
                             f"memory (16·C bytes ≤ 227 KB)")
        lib = _kernel_lib()
        out = torch.empty((n_blocks, 8, Bt), dtype=torch.float32,
                          device=cand.device)
        if n_blocks == 0:
            return out
        overflow = torch.zeros(1, dtype=torch.int32, device=cand.device)
        with torch.cuda.device(cand.device):
            stream = torch.cuda.current_stream(cand.device).cuda_stream
            err = lib.fused_mad_launch(
                cand.data_ptr(), qx.data_ptr(), qy.data_ptr(), qz.data_ptr(),
                qs.data_ptr(), out.data_ptr(), overflow.data_ptr(), n_blocks,
                C, Bt, sub, int(k), float(threshold), float(m2), S, stream)
        if err != 0:
            msg = lib.fused_mad_error_string(err).decode()
            raise RuntimeError(f"fused_mad kernel launch failed: {msg} "
                               f"(cudaError {err})")
        count("kernel2.launches")
        count("kernel2.overflow", overflow)
        return out


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded √x, as the kernel's ``sqrtf``. On the CPU through
    numpy: PyTorch's CPU ``sqrt`` is off by an ulp on some inputs, and at
    several intra-op threads one worker's share of a process's first call
    came out up to 3.1e-4 off while the same call at one thread did not."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _count(mask: torch.Tensor) -> torch.Tensor:
    """#True along the last axis, kept as a size-1 axis (int32)."""
    return mask.sum(dim=-1, keepdim=True, dtype=torch.int32)


def _mad_eval_plain(m2: float, cand: torch.Tensor, qx: torch.Tensor,
                    qy: torch.Tensor, qz: torch.Tensor, qs: torch.Tensor,
                    k: int, threshold: float, Bt: int,
                    C: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same math on dense
    (blocks, Bt, C) panels, chunked over blocks. Every f32 operation is a
    separate op in the kernel's order — d² as ``((dx·dx + dy·dy) +
    dz·dz)``, the bisection midpoint as ``0.5·(lo + hi)``, the bound as
    ``thr·(mad + 1e-6)`` — so both make the same choices."""
    n_blocks = cand.shape[1] // C
    dev = cand.device
    panel = cand.view(4, n_blocks, C)
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    m2 = f32(np.float32(m2))
    thr = np.float32(threshold)
    bound_eps = f32(np.float32(1e-6))
    # 4·(1 + thr) as the kernel forms it, in f32
    delta_coef = f32(np.float32(4.0) * (np.float32(1.0) + thr))
    res = f32(np.float32(2.0 ** -_BISECT))
    thr = f32(thr)
    k1 = k + 1                                  # the selection holds self
    jlo, jhi = (k + 1) // 2, k // 2 + 1
    out = cand.new_zeros((n_blocks, 8, Bt))
    step = max(1, _PLAIN_ELEMS // (Bt * C))
    for b0 in range(0, n_blocks, step):
        b1 = min(b0 + step, n_blocks)
        c = panel[:, b0:b1]                                 # (4, r, C)
        qxb, qyb, qzb, own = (a[b0:b1].transpose(1, 2)      # (r, Bt, 1)
                              for a in (qx, qy, qz, qs))
        d = qxb - c[0][:, None, :]
        d2 = d * d
        d = qyb - c[1][:, None, :]
        d2 = d2 + d * d
        d = qzb - c[2][:, None, :]
        d2 = d2 + d * d                                     # (r, Bt, C)
        del d
        covered = _count(d2 <= m2) >= k1

        lo = torch.zeros_like(d2[..., :1])
        hi = torch.full_like(lo, float(m2))
        for _ in range(_BISECT):
            mid = 0.5 * (lo + hi)
            short = _count(d2 <= mid) < k1
            lo = torch.where(short, mid, lo)
            hi = torch.where(short, hi, mid)
        tau2 = hi
        sel = d2 <= tau2                      # the k+1 set, self included
        del d2
        cs = c[3][:, None, :]                                # (r, 1, C)
        smax = torch.where(sel, cs, 0.0).amax(dim=-1, keepdim=True)

        def order_stat(own_val, j, v_sel):
            lo = torch.zeros_like(smax)
            hi = smax
            for _ in range(_BISECT):
                mid = 0.5 * (lo + hi)
                cnt = _count(v_sel <= mid) - (own_val <= mid).int()
                short = cnt < j
                lo = torch.where(short, mid, lo)
                hi = torch.where(short, hi, mid)
            return hi

        def middle_pair(own_val, vals):
            # unselected slots at +inf: mid ≤ smax is finite, so
            # (v_sel ≤ mid) is exactly sel ∧ (v ≤ mid)
            v_sel = torch.where(sel, vals, torch.inf)
            t_lo = order_stat(own_val, jlo, v_sel)
            if jlo == jhi:
                return t_lo
            return 0.5 * (t_lo + order_stat(own_val, jhi, v_sel))

        med = middle_pair(own, cs)
        own_dev = (own - med).abs()
        mad = middle_pair(own_dev, (cs - med).abs())
        del sel

        bound = thr * (mad + bound_eps)
        keep = own_dev <= bound
        delta = delta_coef * (smax * res)
        covered = covered & ((own_dev - bound).abs() > delta)
        is_pad = qxb >= 1e18
        o = out[b0:b1]
        o[:, 0] = (keep.float() + 2.0 * covered.float())[..., 0]
        o[:, 1] = torch.where(is_pad, torch.inf, _sqrt_rn(tau2))[..., 0]
        o[:, 2] = med[..., 0]
        o[:, 3] = mad[..., 0]
    return out


# ---------------------------------------------------------------------------
# Post-pass and the entry point
# ---------------------------------------------------------------------------

def _post(out: torch.Tensor, n: int):
    """Device post-pass: pack the pull to one uint8 plane and reduce the
    k-th-distance diagnostic to its median on device (``np.median``
    semantics: the mean of the two middle order statistics; padding slots
    are +inf, so the first ``n`` sorted entries are the real points)."""
    packed = out[:, 0, :].reshape(-1).to(torch.uint8)
    kth = out[:, 1, :].reshape(-1)
    ks = torch.sort(kth).values
    radius = 0.5 * (ks[(n - 1) // 2] + ks[n // 2])
    return packed, radius, kth


def fused_mad_filter(points, speeds, k: int, threshold: float,
                     margin_factor: float = 1.9, max_panel: int = 8192,
                     max_bt: int = 4096, want_kth: bool = False,
                     device="cuda"):
    """Keep/radius decisions of the kNN-MAD filter via the fused panel
    kernel on ``device``. Returns ``(keep, covered, radius, kth)`` — keep
    and covered numpy bool arrays in point order, ``radius`` the median
    k-th-neighbour distance, ``kth`` the per-point k-th distances (numpy,
    only when ``want_kth``; ``None`` otherwise). Returns ``None`` when the
    cloud's density pushes the block population past ``max_bt`` or the
    panel past ``max_panel`` or 80 MB of (Bt, C) f32 — the bounds the JAX
    package sets, kept so that callers route the same way.

    ``margin_factor`` = 1.9 covers domain-edge neighbourhoods (a corner
    octant's k-th radius is ~2× the bulk's); what stays uncovered
    (extreme corners, density holes, decisions within the bisection's
    error bound) is flagged in ``covered`` for the caller to re-decide
    exactly."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    s = np.asarray(speeds, np.float32).ravel()
    n = pts.shape[0]

    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    density = n / float(np.prod(extent))
    r_k = (3.0 * (k + 1) / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    margin = r_k * margin_factor
    cell_size = max(margin / 3.0, 1e-6)

    edge = 2.0 * margin
    dims = np.maximum(np.ceil(extent / edge).astype(int), 1)
    bidx = np.clip(((pts - lo) / edge).astype(np.int64), 0, dims - 1)
    bid = (bidx[:, 2] * dims[1] + bidx[:, 1]) * dims[0] + bidx[:, 0]
    order = np.argsort(bid, kind="stable")
    sorted_bid = bid[order]
    uniq, inv_start = np.unique(sorted_bid, return_index=True)
    counts = np.diff(np.append(inv_start, len(sorted_bid)))
    b_cap = int(counts.max())
    Bt = max((b_cap + 127) // 128 * 128, 128)
    if Bt > max_bt:
        return None
    n_blocks = len(uniq)
    q_table = np.full((n_blocks, Bt), n, np.int64)
    rank = np.arange(len(sorted_bid)) - np.repeat(inv_start, counts)
    q_table[np.repeat(np.arange(n_blocks), counts), rank] = order

    pts_dev = torch.as_tensor(pts, device=dev)
    cells = build_cell_list(pts_dev, cell_size=cell_size, device=dev)
    mc = tuple(int(math.ceil((edge + 2.0 * margin) / cell_size)) + 1
               for _ in range(3))
    C_raw = _lattice_capacity(cells, lo, edge, dims, uniq, margin, mc)
    C = max((C_raw + 127) // 128 * 128, 128)
    # bound the product, not each factor: (Bt, C) f32 is the JAX
    # package's scratch, and the same bound keeps the routing identical
    if C > max_panel or Bt * C * 4 > 80 * 1024 * 1024:
        return None

    uz = uniq // (dims[1] * dims[0])
    uy = (uniq // dims[0]) % dims[1]
    ux = uniq % dims[0]
    # f32 arithmetic, matching _lattice_capacity's lattice lows bit-wise
    lo_blocks = (lo[None, :].astype(np.float32)
                 + np.stack([ux, uy, uz], axis=-1).astype(np.float32)
                 * np.float32(edge))

    s_dev = torch.as_tensor(s, device=dev)
    speed_sorted = torch.cat([s_dev[cells.order.long()],
                              s_dev.new_zeros(_PAD_ROWS)])
    store = _build_store_t(cells.points_sorted, speed_sorted)
    G = _compact_indices_scatter(cells, lo_blocks, margin, mc, C)
    cand = store.index_select(1, G.reshape(-1))               # (4, nb·C)
    del G

    qrs_pad = torch.cat([pts_dev, pts_dev.new_full((1, 3), 1e19)])
    speed_pad = torch.cat([s_dev, s_dev.new_zeros(1)])
    qx, qy, qz, qs = _gather_queries(
        qrs_pad, speed_pad, torch.as_tensor(q_table, device=dev))

    out = _mad_eval(np.float32(margin * margin), cand, qx, qy, qz, qs,
                    int(k), float(threshold), Bt, C)
    packed_dev, radius_dev, kth_dev = _post(out, n)
    packed = packed_dev.cpu().numpy()      # 1 byte/slot: keep | covered<<1

    keep = np.ones(n, bool)
    covered = np.zeros(n, bool)
    flat_idx = q_table.reshape(-1)
    valid = flat_idx < n
    keep[flat_idx[valid]] = (packed & 1)[valid] > 0
    covered[flat_idx[valid]] = (packed & 2)[valid] > 0
    kth = None
    if want_kth:
        kth = np.zeros(n, np.float32)
        kth[flat_idx[valid]] = kth_dev.cpu().numpy()[valid]
    return keep, covered, float(radius_dev), kth
