"""Global (all-points) RBF interpolation with a dense solve.

Counterpart of ``ptv_interpolation_tpu/interpolate/rbf_global.py``, the
equivalent of ``scipy.interpolate.RBFInterpolator`` without ``neighbors``:
one system through every particle,

    [K + λI  P] [c]   [f]
    [Pᵀ      0] [d] = [0]

* positive-definite kernels (gaussian, inverse multiquadric, inverse
  quadratic) at ``degree=-1``: dense Cholesky of ``K + λI`` plus a jitter
  of 1e-6·max|K|;
* the others: LU on the saddle system.

Evaluation is a tiled (T, N) kernel matrix times the coefficients, in
full f32 (the matmuls need ``torch.backends.cuda.matmul.allow_tf32`` off,
PyTorch's default: TF32 loses about 1e-3 over N = 5 000 terms).
Coordinates are shifted and scaled as scipy does for conditioning.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.ops.neighbors import map_query_tiles
from ptv_interpolation_tpu_torch.ops.rbf_kernels import (MIN_DEGREE,
                                                         PD_KERNELS,
                                                         kernel_value,
                                                         n_poly_terms,
                                                         polynomial_basis)

#: above this point count the dense O(N²)-memory fit is replaced by the
#: matrix-free projected PCG (rbf_global_pcg.py)
DENSE_FIT_MAX = 20_000


@dataclasses.dataclass
class GlobalRBF:
    """A fitted global RBF model (coefficients and conditioning transform),
    its tensors on one device."""

    points_scaled: torch.Tensor   # (N, 3)
    coeffs: torch.Tensor          # (N, C) kernel coefficients
    poly_coeffs: torch.Tensor     # (m, C)
    shift: torch.Tensor           # (3,)
    scale: torch.Tensor           # ()
    kernel: str
    epsilon: float
    degree: int


def _kernel_matrix(kernel: str, epsilon: float, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """φ(ε·|a_i − b_j|), (…, A, B) for ``a`` (…, A, 3) and ``b`` (…, B,
    3), with d² formed per coordinate as ``(dx² + dy²) + dz²``: no
    (A, B, 3) intermediate."""
    d = a[..., :, None, 0] - b[..., None, :, 0]
    d2 = d * d
    for c in (1, 2):
        torch.sub(a[..., :, None, c], b[..., None, :, c], out=d)
        d2 += d * d
    del d
    return kernel_value(kernel, epsilon * torch.sqrt(torch.clamp_min(d2, 0.0)))


def rbf_global_fit(points, values, kernel: str = "thin_plate_spline",
                   smoothing: float = 0.0, epsilon: float = 1.0,
                   degree: int | None = None, device="cuda") -> GlobalRBF:
    """Fit the global system on ``device``: O(N²) memory, O(N³)
    operations, meant for N ≲ 2·10⁴ (beyond it, :mod:`rbf_global_pcg`).
    A positive-definite kernel whose Cholesky fails gives NaN
    coefficients, as the JAX package's does; a singular saddle system
    gives non-finite ones."""
    dev = resolve_device(device)
    x = as_f32(points, dev)
    f = as_f32(values, dev)
    if degree is None:
        degree = max(MIN_DEGREE[kernel], 0)
    m = n_poly_terms(degree)
    n = x.shape[0]

    shift = x.mean(dim=0)
    scale = torch.clamp_min((x - shift).abs().amax(), 1e-12)
    xs = (x - shift) / scale
    K = _kernel_matrix(kernel, epsilon, xs, xs)
    K.diagonal().add_(smoothing)

    if m == 0 and kernel in PD_KERNELS:
        K.diagonal().add_(1e-6 * K.abs().amax())
        L, info = torch.linalg.cholesky_ex(K)
        c = torch.cholesky_solve(f, L)
        c = torch.where(info == 0, c, torch.nan)
        d = f.new_zeros((0, f.shape[1]))
    else:
        P = polynomial_basis(xs, degree)                    # (N, m)
        A = torch.cat([torch.cat([K, P], dim=1),
                       torch.cat([P.T, P.new_zeros((m, m))], dim=1)])
        del K
        rhs = torch.cat([f, f.new_zeros((m, f.shape[1]))])
        sol = torch.linalg.solve_ex(A, rhs)[0]
        c, d = sol[:n], sol[n:]

    return GlobalRBF(points_scaled=xs, coeffs=c, poly_coeffs=d, shift=shift,
                     scale=scale, kernel=kernel, epsilon=float(epsilon),
                     degree=int(degree))


def rbf_global_evaluate(model: GlobalRBF, queries, query_tile: int = 1024,
                        progress=None) -> torch.Tensor:
    """Evaluate a fitted model at (Q, 3) ``queries`` on the model's device;
    returns (Q, C). Tiled (T, N) kernel blocks bound the memory;
    ``progress`` (a host callback ``fn(done, total)``) reports between
    batches of tiles."""
    qs = as_f32(queries, model.coeffs.device)

    def tile(q_tile):
        q = (q_tile - model.shift) / model.scale
        out = _kernel_matrix(model.kernel, model.epsilon, q,
                             model.points_scaled) @ model.coeffs
        if model.poly_coeffs.shape[0] > 0:
            out = out + polynomial_basis(q, model.degree) @ model.poly_coeffs
        return out

    return map_query_tiles(tile, qs, query_tile, progress=progress)


def rbf_global_interpolate(points, values, queries, solver: str = "auto",
                           device="cuda", **kwargs) -> torch.Tensor:
    """Fit and evaluate in one call on ``device``. ``solver``: 'dense'
    (Cholesky or LU, fastest for small N), 'pcg' (matrix-free projected
    PCG), or 'auto' (dense up to ``DENSE_FIT_MAX`` points, pcg above).
    ``kwargs``: the fit's (``kernel``, ``smoothing``, ``epsilon``,
    ``degree``, and the PCG's options), ``query_tile`` and ``progress``."""
    query_tile = kwargs.pop("query_tile", 1024)
    progress = kwargs.pop("progress", None)
    if solver == "auto":
        solver = "dense" if np.shape(points)[0] <= DENSE_FIT_MAX else "pcg"
    if solver == "pcg":
        from ptv_interpolation_tpu_torch.interpolate.rbf_global_pcg import (
            rbf_global_fit_pcg)
        model = rbf_global_fit_pcg(points, values, device=device, **kwargs)
    else:
        model = rbf_global_fit(points, values, device=device, **kwargs)
    return rbf_global_evaluate(model, queries, query_tile=query_tile,
                               progress=progress)
