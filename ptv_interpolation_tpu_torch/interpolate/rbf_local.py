"""Local (k-nearest-neighbour) RBF interpolation.

Counterpart of ``ptv_interpolation_tpu/interpolate/rbf_local.py``, the
equivalent of ``scipy.interpolate.RBFInterpolator(..., neighbors=k)``: for
every evaluation point, an RBF plus polynomial model is fitted through its
``k`` nearest particles and evaluated there. Every query gets its own
``(k+m)×(k+m)`` saddle system, centred on the query and scaled by its k-th
neighbour distance, and the systems are solved as one batch.

Two routes, as in the JAX package:

* :func:`rbf_local_interpolate` — scattered queries, in tiles: a kNN tile
  (brute force or the cell list) feeds :func:`_local_rbf_solve_tile`,
  which solves the tile's systems with batched LU (``torch.linalg.solve_ex``:
  a singular system gives non-finite values for its own query and does not
  fail the batch);
* :func:`rbf_local_grid_interpolate` — grid targets, in two stages: the
  block-centric exact top-k gather path (``grid_knn_apply``) selects each
  node's k-set, point ids riding in an f32 value channel; then
  :func:`_rbf_solve_flat` fits and evaluates every local model in
  batch-minor layout with :func:`_gauss_solve_t`, Gauss–Jordan with partial
  pivoting.
"""

from __future__ import annotations

import torch

from ptv_interpolation_tpu_torch.device import (as_f32, flush_subnormal,
                                                resolve_device)
from ptv_interpolation_tpu_torch.ops.neighbors import (CellList,
                                                       bruteforce_tile_fn,
                                                       celllist_tile_fn,
                                                       map_query_tiles)
from ptv_interpolation_tpu_torch.ops.rbf_kernels import (MIN_DEGREE,
                                                         kernel_value,
                                                         n_poly_terms,
                                                         polynomial_basis)
from ptv_interpolation_tpu_torch.utils import count, span, tracing

_SOLVE_CHUNK = 131072   # systems per batch-minor chunk of _rbf_solve_flat
_MAX_F32_ID = 1 << 24   # ids ride in an f32 channel: exact below 2²⁴


def _local_rbf_solve_tile(q_tile, sq, xi, fi, valid, k: int, kernel: str,
                          smoothing: float, epsilon: float, degree: int,
                          m: int, n_ch: int) -> torch.Tensor:
    """Fit and evaluate one tile's local models: centre on the query,
    scale by the k-th valid distance, solve the (k+m)² saddle systems
    batched, evaluate at the query. ``q_tile`` (T, 3), ``sq``/``valid``
    (T, k), ``xi`` (T, k, 3), ``fi`` (T, k, C); returns (T, C)."""
    T = q_tile.shape[0]
    # k-th *valid* distance: a missing slot's 3.4e38 sentinel would collapse
    # every valid offset to ~0 and wreck the conditioning
    sq_valid = torch.where(valid, sq, 0.0)
    scale = torch.sqrt(torch.clamp_min(sq_valid.amax(dim=-1), 1e-30))
    scale = scale[:, None, None]
    xl = (xi - q_tile[:, None, :]) / scale                  # (T, k, 3)

    d = xl[:, :, None, 0] - xl[:, None, :, 0]
    r2 = d * d
    d = xl[:, :, None, 1] - xl[:, None, :, 1]
    r2 = r2 + d * d
    d = xl[:, :, None, 2] - xl[:, None, :, 2]
    r2 = r2 + d * d
    # subnormals flushed as XLA flushes them: with a cell list's empty slot
    # in the k-set every entry is tiny, and whether the system is singular
    # (JAX: non-finite) depends on it
    K = flush_subnormal(kernel_value(
        kernel, epsilon * torch.sqrt(torch.clamp_min(r2, 0.0))))
    eye = torch.eye(k, dtype=K.dtype, device=K.device)
    lam = flush_subnormal(smoothing + 1e-6 * K.abs().amax(dim=(1, 2),
                                                          keepdim=True))
    K = flush_subnormal(K + lam * eye)
    vmat = valid[:, :, None] & valid[:, None, :]
    K = torch.where(vmat, K, eye)

    P = torch.where(valid[:, :, None], polynomial_basis(xl, degree), 0.0)
    A = torch.cat([torch.cat([K, P], dim=2),
                   torch.cat([P.transpose(1, 2), K.new_zeros((T, m, m))],
                             dim=2)], dim=1)                 # (T, k+m, k+m)
    rhs = torch.cat([torch.where(valid[:, :, None], fi, 0.0),
                     fi.new_zeros((T, m, n_ch))], dim=1)      # (T, k+m, C)
    sol = torch.linalg.solve_ex(A, rhs)[0]                   # batched LU
    c = sol[:, :k, :]

    rq = torch.sqrt(torch.clamp_min(sq_valid, 0.0)) / scale[:, :, 0]
    Kq = torch.where(valid, kernel_value(kernel, epsilon * rq), 0.0)
    out = (Kq[..., None] * c).sum(dim=1)
    if m > 0:
        Pq = polynomial_basis(torch.zeros_like(q_tile), degree)   # (T, m)
        out = out + (Pq[..., None] * sol[:, k:, :]).sum(dim=1)
    return out


def _index_consume(k: int, id_ch: int):
    """Selection-only consumer: per query, the squared distances and the
    original point ids of its k-set (ids ride in value channel ``id_ch``;
    invalid slots → -1). Output (B, 2k)."""
    def consume(sq, n_pos, n_val, ok, q):
        ids = torch.where(ok, n_val[:, :, id_ch], -1.0)
        return torch.cat([sq, ids], dim=1)
    return consume


def _poly_rows_t(xl, yl, zl, degree: int) -> torch.Tensor:
    """Monomial rows (m, k, T) on transposed (k, T) coordinates, in
    :func:`polynomial_basis`'s term order ([1, x, y, z, x², xy, xz, y², yz,
    z²])."""
    rows = [torch.ones_like(xl)]
    if degree >= 1:
        rows += [xl, yl, zl]
    if degree >= 2:
        rows += [xl * xl, xl * yl, xl * zl, yl * yl, yl * zl, zl * zl]
    return torch.stack(rows)


def _gauss_solve_t(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched dense solve in batch-minor layout: ``A`` (m, m, B), ``rhs``
    (m, C, B) → (m, C, B). Gauss–Jordan with partial pivoting over the
    batch axis, step for step as the JAX package does it: the pivot is the
    first row of largest |value| in the column (rows above the step
    excluded), rows are swapped, the pivot row is divided by its pivot and
    its multiple is subtracted from every other row. Partial pivoting is
    what keeps the saddle systems stable: their polynomial block has a
    zero diagonal. A zero pivot (a singular system) spreads non-finite
    values through that system alone. Updates ``M = [A | rhs]`` in place,
    copies and gathers exact."""
    m = A.shape[0]
    M = torch.cat([A, rhs], dim=1)                   # (m, m+C, B)
    rows = torch.arange(m, device=A.device)
    width, B = M.shape[1], M.shape[2]
    for i in range(m):
        col = torch.where(rows[:, None] < i, -1.0, M[:, i, :].abs())
        p = torch.argmax(col, dim=0)                 # first max, as jnp
        at_p = p[None, None, :].expand(1, width, B)
        pivot_row = torch.gather(M, 0, at_p)[0]      # (m+C, B)
        M.scatter_(0, at_p, M[i:i + 1].clone())      # row i → row p
        row_norm = pivot_row / pivot_row[i][None, :]
        # every row but i: M[r] − M[r, i]·row_norm (row p now holds the old
        # row i); row i's result is discarded, it becomes row_norm
        M -= M[:, i, None, :] * row_norm[None, :, :]
        M[i] = row_norm
    return M[:, m:, :]


def _rbf_solve_flat(points: torch.Tensor, values: torch.Tensor,
                    queries: torch.Tensor, sq: torch.Tensor,
                    idx: torch.Tensor, k: int, kernel: str, smoothing: float,
                    epsilon: float, degree: int, n_ch: int,
                    chunk: int = _SOLVE_CHUNK) -> torch.Tensor:
    """Stage 2 of the two-stage local RBF: given every query's k-set
    (``sq`` (Q, k) f32, ``idx`` (Q, k) int, -1 = missing), fit and
    evaluate the local models in chunks of ``chunk`` queries laid out
    batch-minor ((k, T), (k, k, T), (m, k, T)), solved by
    :func:`_gauss_solve_t`. Returns (Q, C). While tracing, counts
    ``rbf.systems`` (the systems solved) and ``rbf.nonfinite`` (those
    whose solution has a non-finite entry)."""
    m = n_poly_terms(degree)
    Q = queries.shape[0]
    dev = queries.device
    eye_kk = torch.eye(k, dtype=torch.float32, device=dev)[:, :, None]
    out = torch.empty((Q, n_ch), dtype=torch.float32, device=dev)
    for s in range(0, Q, chunk):
        q_c, sq_c, idx_c = (a[s:s + chunk] for a in (queries, sq, idx))
        T = q_c.shape[0]
        validT = (idx_c >= 0).T                       # (k, T)
        safeT = idx_c.clamp_min(0).T.long()           # (k, T)
        sqT = torch.where(validT, sq_c.T, 0.0)        # valid sq only
        scale = torch.sqrt(torch.clamp_min(sqT.amax(dim=0), 1e-30))  # (T,)
        xl, yl, zl = ((points[safeT, a] - q_c[:, a][None, :]) / scale[None, :]
                      for a in range(3))              # (k, T) each

        dx = xl[:, None, :] - xl[None, :, :]          # (k, k, T)
        r2 = dx * dx
        dx = yl[:, None, :] - yl[None, :, :]
        r2 += dx * dx
        dx = zl[:, None, :] - zl[None, :, :]
        r2 += dx * dx
        del dx
        K = kernel_value(kernel, epsilon * torch.sqrt(torch.clamp_min(r2,
                                                                      0.0)))
        del r2
        lam = smoothing + 1e-6 * K.abs().amax(dim=(0, 1))           # (T,)
        K = K + lam[None, None, :] * eye_kk
        vmat = validT[:, None, :] & validT[None, :, :]
        K = torch.where(vmat, K, eye_kk)
        if m:
            P = torch.where(validT[None, :, :],
                            _poly_rows_t(xl, yl, zl, degree), 0.0)  # (m,k,T)
            A = torch.cat([torch.cat([K, P.permute(1, 0, 2)], dim=1),
                           torch.cat([P, P.new_zeros((m, m, T))], dim=1)],
                          dim=0)                      # (k+m, k+m, T)
        else:
            A = K
        del K
        fT = torch.where(validT[:, None, :], values[safeT].permute(0, 2, 1),
                         0.0)                         # (k, C, T)
        rhs = torch.cat([fT, fT.new_zeros((m, n_ch, T))], dim=0)
        sol = _gauss_solve_t(A, rhs)                  # (k+m, C, T)
        del A, rhs
        if tracing():
            count("rbf.systems", T)
            count("rbf.nonfinite",
                  (~torch.isfinite(sol).all(dim=1).all(dim=0)).sum())

        rqT = torch.sqrt(torch.clamp_min(sqT, 0.0)) / scale[None, :]
        KqT = torch.where(validT, kernel_value(kernel, epsilon * rqT), 0.0)
        res = (KqT[:, None, :] * sol[:k]).sum(dim=0)  # (C, T)
        if m:
            res = res + sol[k]       # the polynomial at the centred query
        out[s:s + T] = res.T
    return out


def rbf_local_grid_interpolate(points, values, grid, k: int = 20,
                               kernel: str = "thin_plate_spline",
                               smoothing: float = 0.0, epsilon: float = 1.0,
                               degree: int | None = None, device="cuda",
                               **kwargs) -> torch.Tensor:
    """Local kNN-RBF onto a :class:`Grid` on ``device``, in two stages:

    1. the block-centric exact top-k gather path selects each node's k-set
       (squared distances, and original point ids riding in an extra f32
       value channel, so fewer than 2²⁴ points);
    2. :func:`_rbf_solve_flat` fits and evaluates every local model.

    Returns (nz, ny, nx, C). ``kwargs`` go to ``grid_knn_apply``
    (``block``, default (4, 8, 16); ``cells``, ``cell_size``,
    ``margin_factor``). Selection is exact; the JAX package's default
    there is ``approx_min_k``, which is exact off the TPU."""
    from ptv_interpolation_tpu_torch.ops.grid_knn import grid_knn_apply
    dev = resolve_device(device)
    if degree is None:
        degree = max(MIN_DEGREE[kernel], 0)
    vals = as_f32(values, dev)
    pts = as_f32(points, dev)
    n, n_ch = vals.shape
    if n >= _MAX_F32_ID:
        raise ValueError("two-stage local RBF carries point ids in an f32 "
                         "channel; point counts ≥ 2^24 are not supported")
    vals_aug = torch.cat([vals, torch.arange(n, dtype=torch.float32,
                                             device=dev)[:, None]], dim=1)
    kwargs.setdefault("block", (4, 8, 16))
    kwargs.setdefault("exact_topk", True)
    with span("ptv.grid.rbf.select", k=int(k), block=tuple(kwargs["block"]),
              nodes=grid.n_points):
        out = grid_knn_apply(pts, vals_aug, grid, k,
                             _index_consume(int(k), n_ch), out_dim=2 * k,
                             needs_positions=False, device=dev, **kwargs)
    flat = out.reshape(-1, 2 * k)
    with span("ptv.grid.rbf.solve", m=n_poly_terms(int(degree)),
              chunks=-(-flat.shape[0] // _SOLVE_CHUNK)):
        res = _rbf_solve_flat(pts, vals, grid.flat_coords(dev), flat[:, :k],
                              flat[:, k:].to(torch.int64), int(k), kernel,
                              float(smoothing), float(epsilon), int(degree),
                              n_ch)
    return res.reshape(grid.shape + (n_ch,))


def rbf_local_interpolate(points, values, queries, k: int = 20,
                          kernel: str = "thin_plate_spline",
                          smoothing: float = 0.0, epsilon: float = 1.0,
                          degree: int | None = None,
                          cells: CellList | None = None, rings: int = 1,
                          query_tile: int = 256, point_chunk: int = 4096,
                          progress=None, device="cuda") -> torch.Tensor:
    """Evaluate a k-neighbour local RBF model of ``values`` (N, C) at
    ``queries`` (Q, 3) on ``device``; returns (Q, C). ``k`` is
    --rbf-neighbors, ``kernel`` --rbf-kernel, ``smoothing`` --smoothing;
    ``degree`` defaults to the kernel's minimum (0 when unrestricted), as
    scipy's does. ``cells`` selects the cell-list search; ``progress`` is
    a host callback ``fn(done, total)``.

    As in the JAX package, a cell-list slot with no point (id
    ``n_points``, d² = 3.4e38) counts as a valid neighbour: it reads the
    last point and its sentinel distance sets the query's scale."""
    dev = resolve_device(device)
    if degree is None:
        degree = max(MIN_DEGREE[kernel], 0)
    pts = as_f32(points, dev)
    vals = as_f32(values, dev)
    m = n_poly_terms(degree)
    n, n_ch = vals.shape
    if cells is not None:
        if cells.device != pts.device:
            raise ValueError(f"cells live on {cells.device}, not on "
                             f"{pts.device}")
        neighbor = celllist_tile_fn(cells, k, rings)
    else:
        neighbor = bruteforce_tile_fn(pts, k, point_chunk)

    def tile(q_tile):
        sq, idx = neighbor(q_tile)                    # (T, k)
        safe = idx.clamp(0, n - 1)
        return _local_rbf_solve_tile(q_tile, sq, pts[safe], vals[safe],
                                     idx >= 0, k, kernel, smoothing, epsilon,
                                     degree, m, n_ch)

    return map_query_tiles(tile, as_f32(queries, dev), query_tile,
                           progress=progress)
