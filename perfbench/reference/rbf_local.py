"""The upstream's local RBF (``interpolator.py:157-195``,
``scipy.interpolate.RBFInterpolator(neighbors=k)``) in plain PyTorch.

For each query: its k nearest points, exact (:mod:`knn`); the kernel
``φ(ε·|yᵢ − yⱼ|)`` between them in the points' own units, plus
``smoothing`` on the diagonal; the polynomial of the given degree on the
neighbours shifted by the midpoint of their bounding box and divided by
its half-width (a zero half-width taken as 1); the saddle system
``[[K, P], [Pᵀ, 0]] [c; b] = [d; 0]`` solved by LU;
and the model evaluated at the query, as scipy's
``_build_and_solve_system`` and ``_build_evaluation_coefficients`` do.
Computed in the dtype of its inputs; a dtype that ``torch.linalg.solve``
does not take (bfloat16, float16) solves in float32 and rounds back.

The program under test departs from this in three ways, which the
cell's checks measure:

* it evaluates the kernel on coordinates centred at the node and divided
  by the node's k-th neighbour distance (at ``smoothing = 0`` the fit is
  the same, since the ``r²`` term that the scaling adds to the
  thin-plate kernel is cancelled by ``Pᵀc = 0``; at ``smoothing > 0`` it
  is another fit);
* it adds ``1e-6·max|K|`` to the kernel block's diagonal;
* it takes each node's k nearest among its block's candidate region, so
  a node whose true k-set reaches past that region gets another set.

This file is part of the benchmark's yardstick: it imports nothing of
the program under test.
"""

from __future__ import annotations

import itertools

import torch

from perfbench.reference.knn import knn

CHUNK = 1 << 17          # queries per solve, so that (T, k+m, k+m) stays small
_SOLVE_DTYPES = (torch.float32, torch.float64)


def thin_plate_spline(r2):
    """``r² log r`` from ``r²``, 0 at ``r = 0``."""
    return 0.5 * torch.xlogy(r2, r2)


KERNELS = {"thin_plate_spline": thin_plate_spline}


def monomial_powers(degree, ndim=3):
    """The exponents of every monomial of total degree ≤ ``degree``."""
    return [p for d in range(degree + 1)
            for p in itertools.product(range(d + 1), repeat=ndim)
            if sum(p) == d]


def _monomials(xhat, powers, dtype):
    """(…, 3) → (…, m): each monomial of ``powers`` at ``xhat``."""
    if not powers:
        return xhat.new_zeros(xhat.shape[:-1] + (0,))
    cols = []
    for p in powers:
        col = torch.ones(xhat.shape[:-1], dtype=dtype, device=xhat.device)
        for a, e in enumerate(p):
            if e:
                col = col * xhat[..., a] ** e
        cols.append(col)
    return torch.stack(cols, dim=-1)


def _sq_dist(a, b):
    """Squared distances (…, i, j) between (…, i, 3) and (…, j, 3)."""
    d2 = (a[..., :, None, 0] - b[..., None, :, 0]).square()
    for ax in (1, 2):
        d2 = d2 + (a[..., :, None, ax] - b[..., None, :, ax]).square()
    return d2


def rbf_local(points, values, queries, k, cell, kernel="thin_plate_spline",
              epsilon=1.0, smoothing=0.0, degree=1):
    """Values (Q, C) at ``queries`` (Q, 3) of the local RBF of ``values``
    (N, C) at ``points`` (N, 3), all of one dtype and device; ``cell``
    sets only the cost of the kNN search."""
    phi = KERNELS[kernel]
    dt, dev = values.dtype, values.device
    solve_dt = dt if dt in _SOLVE_DTYPES else torch.float32
    powers = monomial_powers(degree)
    m = len(powers)
    _, idx, _ = knn(points, queries, k, cell)
    out = torch.empty((queries.shape[0], values.shape[1]), dtype=dt,
                      device=dev)
    eye = torch.eye(k, dtype=dt, device=dev)
    for q0 in range(0, queries.shape[0], CHUNK):
        x = queries[q0:q0 + CHUNK]
        y = points[idx[q0:q0 + CHUNK]]                     # (T, k, 3)
        d = values[idx[q0:q0 + CHUNK]]                     # (T, k, C)
        T, C = x.shape[0], d.shape[2]
        lo, hi = y.amin(dim=1), y.amax(dim=1)
        shift = (hi + lo) / 2
        scale = (hi - lo) / 2
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        yeps = y * epsilon
        K = phi(_sq_dist(yeps, yeps)) + smoothing * eye
        P = _monomials((y - shift[:, None]) / scale[:, None], powers, dt)
        A = torch.cat([torch.cat([K, P], dim=2),
                       torch.cat([P.transpose(1, 2), K.new_zeros((T, m, m))],
                                 dim=2)], dim=1)           # (T, k+m, k+m)
        rhs = torch.cat([d, d.new_zeros((T, m, C))], dim=1)
        # solve_ex: a system made singular (points rounded together in a
        # low precision) gives non-finite values for its own query only
        coef = torch.linalg.solve_ex(A.to(solve_dt),
                                     rhs.to(solve_dt))[0].to(dt)
        kx = phi(_sq_dist((x * epsilon)[:, None], yeps))[:, 0]   # (T, k)
        px = _monomials((x - shift) / scale, powers, dt)           # (T, m)
        out[q0:q0 + CHUNK] = (torch.einsum("tk,tkc->tc", kx, coef[:, :k])
                              + torch.einsum("tm,tmc->tc", px, coef[:, k:]))
    return out
