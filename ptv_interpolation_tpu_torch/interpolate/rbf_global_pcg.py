"""Global RBF at scale: matrix-free projected PCG (no O(N²) storage).

Counterpart of ``ptv_interpolation_tpu/interpolate/rbf_global_pcg.py``:
``RBFInterpolator`` with ``neighbors=None`` beyond the dense fit's
capacity. The kernel matrix is never formed: each CG matvec streams
(T, N) kernel panels, so memory is O(N·T).

The saddle system

    [K + λI  P] [c]   [f]
    [Pᵀ      0] [d] = [0]

is solved by projected PCG on {c : Pᵀc = 0}: with P = QR, the projector
Π = I − QQᵀ makes Π(K + λI)Π SPD on the subspace, CG converges to c, and
R d = Qᵀ(f − (K + λI)c) gives the polynomial part (on the host, in f64).
Pure-PD kernels at ``degree=-1`` skip the projection.

Preconditioner: block-Jacobi over Morton-ordered points. The points are
sorted along a Z-order curve, each (B, B) diagonal block of K + λI is
Cholesky-factored in one batch, and the preconditioner solve is a batched
triangular solve. A block whose factor fails (conditionally PD kernels can
be indefinite on a block) falls back to the identity.

The CG loop is a Python loop with one host read per iteration (the
residuals that decide whether to go on), as ``ops/solvers.py::pcg`` is.
"""

from __future__ import annotations

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.interpolate.rbf_global import (
    GlobalRBF, _kernel_matrix)
from ptv_interpolation_tpu_torch.ops.rbf_kernels import (MIN_DEGREE,
                                                         n_poly_terms,
                                                         polynomial_basis)


def _morton_order(pts: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order (Morton) sort permutation of (N, 3) points — host-side."""
    lo = pts.min(axis=0)
    extent = np.maximum(pts.max(axis=0) - lo, 1e-12)
    q = ((pts - lo) / extent * (2 ** bits - 1)).astype(np.uint64)
    code = np.zeros(len(pts), np.uint64)
    for b in range(bits):
        for axis in range(3):
            code |= ((q[:, axis] >> np.uint64(b)) & np.uint64(1)) \
                << np.uint64(3 * b + axis)
    return np.argsort(code, kind="stable")


def _pcg_solve(xs, f, valid, Q, pre_chol, kernel: str, epsilon: float,
               smoothing: float, row_tile: int, maxiter: int, tol: float):
    """Projected PCG on Π(K+λI)Π c = Πf, with the JAX package's step
    sequence. Shapes are padded to multiples of ``row_tile`` and of the
    preconditioner's block; ``valid`` masks the pad rows, kept at 0.

    Best-iterate safeguard: on near-singular systems (a flat gaussian at a
    small epsilon) f32 roundoff breaks conjugacy and the residual can grow
    without bound, so the lowest-residual iterate is kept and the loop
    stops once the residual exceeds 10× the best. Returns ``(c, (K+λI)c,
    iterations, best relative residual)``."""
    n_pad, C = f.shape
    nb, block = pre_chol.shape[:2]
    m = Q.shape[1]
    vcol = valid[:, None]

    def matvec(c):
        y = torch.empty_like(c)
        for s in range(0, n_pad, row_tile):
            y[s:s + row_tile] = _kernel_matrix(kernel, epsilon,
                                               xs[s:s + row_tile], xs) @ c
        return torch.where(vcol, y + smoothing * c, 0.0)

    def project(v):
        if m == 0:
            return torch.where(vcol, v, 0.0)
        return torch.where(vcol, v - Q @ (Q.T @ v), 0.0)

    def precond(r):
        return torch.cholesky_solve(r.reshape(nb, block, C),
                                    pre_chol).reshape(n_pad, C)

    def rel_res(r):
        return (torch.linalg.vector_norm(r, dim=0) / bnorm).amax()

    b = project(f)
    bnorm = torch.clamp_min(torch.linalg.vector_norm(b, dim=0), 1e-30)
    c = torch.zeros_like(f)
    r = b
    z = project(precond(r))
    p = z
    rz = (r * z).sum(dim=0)
    res = res_best = rel_res(r)
    c_best = c
    it = 0
    while True:
        res_h, best_h = torch.stack([res, res_best]).tolist()  # one read
        if not (it < maxiter and best_h > tol and res_h < 10.0 * best_h):
            break
        Ap = project(matvec(p))
        pAp = (p * Ap).sum(dim=0)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, 1e-30), 0.0)
        c = c + alpha * p
        r = r - alpha * Ap
        z = project(precond(r))
        rz_new = (r * z).sum(dim=0)
        beta = rz_new / torch.where(rz != 0, rz, 1e-30)
        p = z + beta * p
        rz = rz_new
        res = rel_res(r)
        better = res < res_best
        c_best = torch.where(better, c, c_best)
        res_best = torch.where(better, res, res_best)
        it += 1
    return c_best, matvec(c_best), it, float(res_best)


def _block_factors(xb: torch.Tensor, vb: torch.Tensor, kernel: str,
                   epsilon: float, lam: float) -> torch.Tensor:
    """Cholesky factors of the (B, B) diagonal blocks of K + λI, (nb, B,
    B): pad rows masked to 0 and a diagonal of 1e-5·max|K| + λ per block.
    A block whose factorisation fails (``info ≠ 0``: the JAX package's
    NaN factor) gets the identity, i.e. no preconditioning there. A scaled
    diagonal is not safe as the fallback: a tiny diagonal turns the
    preconditioner into a ~1e20 scalar and the CG inner products overflow
    f32."""
    nb, block = vb.shape
    eye = torch.eye(block, dtype=torch.float32, device=xb.device)
    K = _kernel_matrix(kernel, epsilon, xb, xb)
    K = torch.where(vb[:, :, None] & vb[:, None, :], K, 0.0)
    dj = 1e-5 * K.abs().amax(dim=(1, 2), keepdim=True) + lam
    L, info = torch.linalg.cholesky_ex(K + dj * eye)
    return torch.where((info != 0)[:, None, None], eye, L)


def rbf_global_fit_pcg(points, values, kernel: str = "thin_plate_spline",
                       smoothing: float = 0.0, epsilon: float = 1.0,
                       degree: int | None = None, row_tile: int = 2048,
                       block: int = 256, maxiter: int = 600,
                       tol: float = 1e-6, verbose: bool = False,
                       device="cuda") -> GlobalRBF:
    """Fit the global RBF system matrix-free on ``device``. Returns a
    :class:`GlobalRBF` for ``rbf_global_evaluate``, the dense path's
    contract without its N² memory. ``smoothing`` regularises the CG
    system; 0 is replaced by 1e-6 on the scaled system for stability.
    ``rbf_global_fit_pcg.last_solve`` keeps the last call's ``(iterations,
    relative residual)``."""
    dev = resolve_device(device)
    if torch.is_tensor(points):
        points = points.cpu().numpy()
    if torch.is_tensor(values):
        values = values.cpu().numpy()
    pts = np.asarray(points, np.float32)
    f_in = np.asarray(values, np.float32)
    if f_in.ndim == 1:
        f_in = f_in[:, None]
    n = pts.shape[0]
    if degree is None:
        degree = max(MIN_DEGREE[kernel], 0)
    m = n_poly_terms(degree)

    # conditioning transform (the dense path's and scipy's), on the host
    shift = pts.mean(axis=0)
    scale = max(float(np.max(np.abs(pts - shift))), 1e-12)
    xs_np = ((pts - shift) / scale).astype(np.float32)

    # Morton sort for spatially coherent preconditioner blocks
    order = _morton_order(xs_np)
    xs_np = xs_np[order]
    f_np = f_in[order]

    # pad to a multiple of lcm(row_tile, block); pad coordinates repeat the
    # first point (finite kernel values), pad rows are masked and their
    # coefficients pinned at zero
    mult = int(np.lcm(row_tile, block))
    n_pad = ((n + mult - 1) // mult) * mult
    pad = n_pad - n
    xs_pad = np.concatenate([xs_np, np.repeat(xs_np[:1], pad, axis=0)])
    f_pad = np.concatenate([f_np, np.zeros((pad, f_np.shape[1]), np.float32)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])

    lam = float(smoothing)
    if lam == 0.0:
        lam = 1e-6   # stability floor on the scaled system

    xs_t = torch.as_tensor(xs_pad, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    pre_chol = _block_factors(xs_t.reshape(-1, block, 3),
                              valid_t.reshape(-1, block), kernel,
                              float(epsilon), lam)

    # polynomial constraint basis: zero rows at pads, reduced QR in f64
    if m > 0:
        P = polynomial_basis(torch.as_tensor(xs_pad), degree).numpy()
        P[~valid] = 0.0
        Qm, Rm = np.linalg.qr(P.astype(np.float64), mode="reduced")
        Q = torch.as_tensor(Qm.astype(np.float32), device=dev)
    else:
        Q = torch.zeros((n_pad, 0), dtype=torch.float32, device=dev)

    f_t = torch.as_tensor(f_pad, device=dev)
    c, Kc, iters, res = _pcg_solve(xs_t, f_t, valid_t, Q, pre_chol, kernel,
                                   float(epsilon), lam, row_tile, maxiter,
                                   tol)
    rbf_global_fit_pcg.last_solve = (iters, res)
    if verbose:
        print(f"  [rbf-pcg] N={n} iters={int(iters)} relres={float(res):.2e}")

    if m > 0:
        # R d = Qᵀ(f − (K+λI)c), solved in f64 on the host (m ≤ 10)
        rhs = (Q.T @ (f_t - Kc)).cpu().numpy().astype(np.float64)
        d = np.linalg.solve(Rm, rhs).astype(np.float32)
    else:
        d = np.zeros((0, f_np.shape[1]), np.float32)

    return GlobalRBF(points_scaled=torch.as_tensor(xs_np, device=dev),
                     coeffs=c[:n], poly_coeffs=torch.as_tensor(d, device=dev),
                     shift=torch.as_tensor(shift, device=dev),
                     scale=torch.tensor(scale, dtype=torch.float32,
                                        device=dev),
                     kernel=kernel, epsilon=float(epsilon),
                     degree=int(degree))


rbf_global_fit_pcg.last_solve = None
