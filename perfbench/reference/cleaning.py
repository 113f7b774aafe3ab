"""Variational divergence cleaning (the upstream's ``physics.py:440-514``)
in plain PyTorch: minimise ``‖U − U0‖² + λ‖D̃U‖²`` over the fluid, that
is solve ``(I + λ D̃ᵀD̃) U = U0`` with ``D̃`` the finite-volume 'operator'
divergence restricted to fluid cells.

``D̃`` is a frozen copy of the f64 check the repository's smoke script
holds the port against: a face between two fluid cells carries the mean of
their values, a face next to solid carries 0, a domain-edge face the
cell's own value. ``D̃ᵀ`` is taken from autograd, so no adjoint is written
by hand. The solve is plain conjugate gradients on the 3n-unknown system,
started from ``U0``, in the dtype of the field.
"""

from __future__ import annotations

import torch

TOL = 1e-11
MAXITER = 2000


def operator_divergence(u, v, w, mask, spacing):
    """The 'operator' divergence of (u, v, w) on (nz, ny, nx) arrays;
    ``mask`` bool, True = fluid."""
    dx, dy, dz = spacing

    def face(vel, dim, h):
        n = vel.shape[dim]
        nxt = torch.where(torch.roll(mask, -1, dim),
                          (vel + torch.roll(vel, -1, dim)) / 2.0, 0.0)
        nxt = torch.cat([nxt.narrow(dim, 0, n - 1), vel.narrow(dim, n - 1, 1)],
                        dim)
        prv = torch.where(torch.roll(mask, 1, dim),
                          (vel + torch.roll(vel, 1, dim)) / 2.0, 0.0)
        prv = torch.cat([vel.narrow(dim, 0, 1), prv.narrow(dim, 1, n - 1)],
                        dim)
        return (nxt - prv) / h

    return face(u, 2, dx) + face(v, 1, dy) + face(w, 0, dz)


def clean_variational(field, mask, spacing, lam, tol=TOL, maxiter=MAXITER):
    """The cleaned field (3, nz, ny, nx) from ``field`` (its values in
    solid are ignored); the solid stays 0. Stops where the residual, in
    the 2-norm and relative to ``U0``'s, falls below ``tol``, or where it
    stops being finite (the last finite iterate is returned)."""
    m = mask.to(field.dtype)

    def d_tilde(U):
        return operator_divergence(U[0] * m, U[1] * m, U[2] * m, mask,
                                   spacing) * m

    def a_op(U):
        with torch.enable_grad():
            x = torch.zeros_like(U, requires_grad=True)
            div = d_tilde(x)
            (dtd,) = torch.autograd.grad(div, x, grad_outputs=d_tilde(U))
        return (U + lam * dtd) * m

    b = field * m
    x = b.clone()
    r = b - a_op(x)
    p = r.clone()
    rr = (r * r).sum()
    bb = (b * b).sum()
    for _ in range(maxiter):
        if not bool(torch.isfinite(rr)) or float(rr) <= tol * tol * float(bb):
            break
        ap = a_op(p)
        alpha = rr / (p * ap).sum()
        x_next = x + alpha * p
        if not bool(torch.isfinite(x_next).all()):
            break
        x = x_next
        r = r - alpha * ap
        rr_next = (r * r).sum()
        p = r + (rr_next / rr) * p
        rr = rr_next
    return x
