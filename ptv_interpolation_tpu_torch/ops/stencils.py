"""Finite-volume stencil operators on the (…, nz, ny, nx) grid, matrix-free.

Counterpart of ``ptv_interpolation_tpu/ops/stencils.py``: the same
operators, coefficient for coefficient, as PyTorch ops. The spatial axes
are the last three (z, y, x), so every operator also takes a leading batch
axis (the parity-decomposed multigrid runs its 8 sublattices as one batch).
A neighbour shift is a slice of the array, never a roll: the values are
the JAX package's, with fewer launches.

Conventions: mask True = fluid; velocities are zero in solid cells; all
operators return zero on solid rows. Inputs are tensors; every operator
runs where its inputs are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (spatial axis, index of its spacing in (dx, dy, dz)), in the order the
# JAX package sums the axes: x, then y, then z
_XYZ = ((-1, 0), (-2, 1), (-3, 2))


def _lo(a, axis):
    """``a[..., :-1, ...]`` along ``axis``: the lower cell of each face."""
    return a.narrow(axis, 0, a.shape[axis] - 1)


def _hi(a, axis):
    """``a[..., 1:, ...]`` along ``axis``: the upper cell of each face."""
    return a.narrow(axis, 1, a.shape[axis] - 1)


def _pad_spec(axis, before, after):
    return (0, 0) * (-axis - 1) + (before, after)


def _faces_to_next(f, axis):
    """Face values (n−1 along ``axis``) as each cell's upper face, the last
    cell's set to 0."""
    return F.pad(f, _pad_spec(axis, 0, 1))


def _faces_to_prev(f, axis):
    """Face values as each cell's lower face, the first cell's set to 0."""
    return F.pad(f, _pad_spec(axis, 1, 0))


def _axis_index(a, axis):
    """The index along ``axis``, shaped to broadcast against ``a``."""
    n = a.shape[axis]
    return torch.arange(n, device=a.device).view((n,) + (1,) * (-axis - 1))


def shift(arr, offset: int, axis: int, fill):
    """Shift ``arr`` by ``offset`` along ``axis`` without wraparound:
    ``out[i] = arr[i + offset]`` where valid, else ``fill``."""
    out = torch.full_like(arr, fill)
    k = arr.shape[axis] - abs(offset)
    if k > 0:
        out.narrow(axis, max(-offset, 0), k).copy_(
            arr.narrow(axis, max(offset, 0), k))
    return out


def consistent_divergence(u, v, w, mask, dx, dy, dz, variant: str = "roll"):
    """FV divergence with the reference's face conventions.

    Face velocity: mean of the two cells if the neighbor is fluid, 0 at a
    solid face (no-penetration), own-cell value at domain edges (Neumann).
    Computed on every cell; only fluid rows are meaningful downstream.

    The reference ships two inconsistent formulations, and so does this
    function: ``variant='roll'`` (the lower face is the lower cell's upper
    face, so at a fluid cell whose lower neighbour is solid the face takes
    ``v_i/2``; the projection loop and every diagnostic use it) and
    ``variant='operator'`` (both solid faces 0, the symmetric convention
    of the variational cleaner). See the JAX package's docstring.
    """
    def face_div(vel, axis, h):
        s = (_lo(vel, axis) + _hi(vel, axis)) * 0.5      # (v_i + v_{i+1})/2
        g_next = torch.where(_hi(mask, axis), s, 0.0)
        n = vel.shape[axis]
        f_next = torch.cat([g_next, vel.narrow(axis, n - 1, 1)], axis)
        if variant == "roll":
            g_prev = g_next                              # f_next[i-1]
        else:
            g_prev = torch.where(_lo(mask, axis), s, 0.0)
        f_prev = torch.cat([vel.narrow(axis, 0, 1), g_prev], axis)
        return (f_next - f_prev) / h

    return (face_div(u, -1, dx) + face_div(v, -2, dy)
            + face_div(w, -3, dz))


def laplacian_coeffs(mask, dx, dy, dz, dtype=torch.float32):
    """The masked Laplacian's face coefficients, per axis x, y, z: ``1/h²``
    on each face between two fluid cells, else 0 (n−1 faces along the
    axis). Computed once per mask and reused by every application."""
    h = (dx, dy, dz)
    return tuple((_lo(mask, axis) & _hi(mask, axis)).to(dtype)
                 * (1.0 / (h[i] * h[i])) for axis, i in _XYZ)


def laplacian_apply_coeffs(phi, coeffs):
    """:func:`laplacian_apply` with the face coefficients of
    :func:`laplacian_coeffs`."""
    out = torch.zeros_like(phi)
    for (axis, _), c in zip(_XYZ, coeffs):
        flux = c * (_hi(phi, axis) - _lo(phi, axis))   # (φ_{i+1} − φ_i)/h²
        _lo(out, axis).add_(flux)                      # the +1 neighbour
        _hi(out, axis).sub_(flux)                      # the −1 neighbour
    return out


def laplacian_apply(phi, mask, dx, dy, dz):
    """Matrix-free application of the reference's masked 7-point Laplacian
    (`physics.py:55-108`): for each fluid cell, ``Σ (φ_j − φ_i)/h²`` over
    in-domain fluid neighbors j. Zero on solid rows. Symmetric NSD."""
    return laplacian_apply_coeffs(
        phi, laplacian_coeffs(mask, dx, dy, dz, phi.dtype))


def laplacian_diag_coeffs(coeffs):
    """:func:`laplacian_diag` from the face coefficients."""
    c0 = coeffs[0]
    shape = list(c0.shape)
    shape[-1] += 1
    diag = torch.zeros(shape, dtype=c0.dtype, device=c0.device)
    for (axis, _), c in zip(_XYZ, coeffs):
        _lo(diag, axis).sub_(c)
        _hi(diag, axis).sub_(c)
    return diag


def laplacian_diag(mask, dx, dy, dz):
    """Diagonal of the masked Laplacian: ``−Σ 1/h²`` per connected neighbor —
    the Jacobi preconditioner for the CG solves."""
    return laplacian_diag_coeffs(laplacian_coeffs(mask, dx, dy, dz))


def divergence_dtd_diag(mask, dx, dy, dz):
    """Exact per-component diagonal of ``D̃ᵀD̃`` where ``D̃`` is the masked
    'operator'-variant FV divergence (rows and columns both restricted to
    fluid cells) — the Jacobi preconditioner for the variational cleaner's
    ``(I + λ D̃ᵀD̃)`` system. Per axis the divergence row at cell ``i``
    carries ``±1/(2h)`` on the in-domain fluid neighbours ``i±1`` and
    ``(a₊ − a₋)/(2h) ± 1/h`` (edge Neumann) on ``i`` itself; the column
    sum of squares for unknown ``j`` has the closed form below.
    Returns the (x, y, z) components."""
    maskf = mask.float()

    def axis_diag(axis, h):
        m_next = shift(maskf, +1, axis, 0.0)   # fluid indicator at j+1
        m_prev = shift(maskf, -1, axis, 0.0)
        idx = _axis_index(maskf, axis)
        n = maskf.shape[axis]
        inv2h = 1.0 / (2.0 * h)
        edge = ((idx == n - 1).float() - (idx == 0).float()) / h
        c_self = (m_next - m_prev) * inv2h + edge      # c_{j,j}
        # rows j∓1 (if fluid) each touch u_j with ±1/(2h)
        off = (m_next + m_prev) * (inv2h * inv2h)
        return maskf * (c_self * c_self + off)

    return (axis_diag(-1, dx), axis_diag(-2, dy), axis_diag(-3, dz))


def operator_divergence_coeffs(mask, dtype=torch.float32):
    """The masked 'operator' divergence's face coefficients, per axis x,
    y, z: ``0.5`` on each face between two fluid cells, else 0."""
    return tuple((_lo(mask, axis) & _hi(mask, axis)).to(dtype) * 0.5
                 for axis, _ in _XYZ)


def masked_divergence(uvw, maskf, coeffs, dx, dy, dz):
    """``D̃ U``: the 'operator' divergence with rows and columns restricted
    to fluid, ``maskf · consistent_divergence(maskf·u, maskf·v, maskf·w,
    variant='operator')``, from :func:`operator_divergence_coeffs`.

    A face between two fluid cells carries ``(a_i + a_{i+1})/2``, any other
    interior face 0 (a solid row is zeroed by the outer mask, so one
    symmetric coefficient serves both cells); the domain-edge faces carry
    the own-cell value."""
    h = (dx, dy, dz)
    out = None
    for vel, (axis, i), c in zip(uvw, _XYZ, coeffs):
        a = vel * maskf
        n = a.shape[axis]
        g = c * (_lo(a, axis) + _hi(a, axis))
        f_next = torch.cat([g, a.narrow(axis, n - 1, 1)], axis)
        f_prev = torch.cat([a.narrow(axis, 0, 1), g], axis)
        d = (f_next - f_prev) / h[i]
        out = d if out is None else out + d
    return out * maskf


def masked_divergence_T(q, maskf, coeffs, dx, dy, dz):
    """``D̃ᵀ q``, the adjoint of :func:`masked_divergence`, written out as
    a stencil. Per axis, with ``r = maskf·q/h``: each face carries
    ``c·(r_i − r_{i+1})`` back to both of its cells, and the domain-edge
    Neumann faces give the self terms ``+r`` at ``i = n−1`` and ``−r`` at
    ``i = 0`` (the ``±1/h`` of :func:`divergence_dtd_diag`). Returns the
    (x, y, z) components."""
    h = (dx, dy, dz)
    p = q * maskf
    out = []
    for (axis, i), c in zip(_XYZ, coeffs):
        r = p / h[i]
        n = r.shape[axis]
        gt = c * (_lo(r, axis) - _hi(r, axis))
        as_lower = torch.cat([gt, r.narrow(axis, n - 1, 1)], axis)
        as_upper = torch.cat([-r.narrow(axis, 0, 1), gt], axis)
        out.append((as_lower + as_upper) * maskf)
    return tuple(out)


def consistent_correction(u, v, w, phi, mask, dx, dy, dz):
    """Velocity correction from a potential φ (`physics.py:110-147`):
    cell-centered gradient = mean of the two staggered face gradients,
    with zero gradient at solid faces and domain edges; solid re-zeroed."""
    def cell_grad(p, axis, h):
        g = torch.where(_lo(mask, axis) & _hi(mask, axis),
                        (_hi(p, axis) - _lo(p, axis)) / h, 0.0)
        return (_faces_to_next(g, axis) + _faces_to_prev(g, axis)) * 0.5

    u_new = (u - cell_grad(phi, -1, dx)) * mask
    v_new = (v - cell_grad(phi, -2, dy)) * mask
    w_new = (w - cell_grad(phi, -3, dz)) * mask
    return u_new, v_new, w_new


def force_divergence(fx, fy, fz, mask, dx, dy, dz,
                     wall_bc: str = "zero-neumann"):
    """Face-flux divergence of a force field for the Poisson RHS
    (`physics.py:211-262`).

    ``zero-neumann``: boundary faces (domain edges and solid walls) carry
    zero flux, injecting the force into the RHS. ``inhomogeneous``: solid
    faces take the one-sided fluid value.
    """
    def flux_grad(field, axis, h):
        # the face between cell i and i+1; the domain edges carry no flux
        f_lo, f_hi = _lo(field, axis), _hi(field, axis)
        m_lo, m_hi = _lo(mask, axis), _hi(mask, axis)
        f_face = torch.where(m_lo & m_hi, 0.5 * (f_lo + f_hi), 0.0)
        if wall_bc == "inhomogeneous":
            f_face = torch.where(m_lo & ~m_hi, f_lo, f_face)
            f_face = torch.where(~m_lo & m_hi, f_hi, f_face)
        return (_faces_to_next(f_face, axis)
                - _faces_to_prev(f_face, axis)) / h

    return (flux_grad(fx, -1, dx) + flux_grad(fy, -2, dy)
            + flux_grad(fz, -3, dz))


def gradient(f, dx, dy, dz):
    """Central-difference gradient identical to ``np.gradient`` (one-sided
    at edges). Returns (df/dz, df/dy, df/dx) like numpy's axis order."""
    def grad_axis(axis, h):
        f_next = shift(f, +1, axis, 0.0)
        f_prev = shift(f, -1, axis, 0.0)
        idx = _axis_index(f, axis)
        n = f.shape[axis]
        interior = (f_next - f_prev) / (2.0 * h)
        first = (f_next - f) / h
        last = (f - f_prev) / h
        out = torch.where(idx == 0, first, interior)
        return torch.where(idx == n - 1, last, out)

    return grad_axis(-3, dz), grad_axis(-2, dy), grad_axis(-1, dx)
