"""Matrix-free preconditioned CG over a tensor or a tuple of tensors.

Counterpart of ``ptv_interpolation_tpu/ops/solvers.py``, which runs the
same iteration as a ``jax.lax.while_loop`` over a pytree. Here the loop is
a Python ``while``; the operators are the stencils of ``ops/stencils.py``,
so each iteration is a few hundred small kernels plus three f32 dot
products.

Singular (pure-Neumann) systems are handled by explicit null-space
projection each iteration, which reproduces the role of the reference's
``b − mean(b)`` compatibility shift plus LSQR's least-squares robustness.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


def _leaves(t):
    return t if isinstance(t, tuple) else (t,)


def _map(fn, *trees):
    """``fn`` over the leaves of equally structured trees (a tensor or a
    tuple of tensors)."""
    if isinstance(trees[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*trees))
    return fn(*trees)


def _dot(a, b):
    """Σ a·b over the leaves, each an f32 dot product, like the JAX
    package's ``vdot`` sums."""
    total = 0
    for x, y in zip(_leaves(a), _leaves(b)):
        total = total + torch.dot(x.reshape(-1).float(), y.reshape(-1).float())
    return total


def _dots(*pairs):
    """The inner product of each ``(a, b)`` pair (:func:`_dot`)."""
    return [_dot(a, b) for a, b in pairs]


def _axpy(alpha, x, y):
    return _map(lambda xi, yi: alpha * xi + yi, x, y)


class CGResult(NamedTuple):
    x: object               # a tensor or a tuple of tensors, like ``b``
    iterations: int
    residual_norm: torch.Tensor
    converged: bool


def pcg(A: Callable, b, x0=None, M_inv: Optional[Callable] = None,
        project: Optional[Callable] = None, tol: float = 1e-8,
        maxiter: int = 1000, dot: Optional[Callable] = None) -> CGResult:
    """Preconditioned conjugate gradients for SPD (or PSD + projected) A.

    Parameters
    ----------
    A : linear operator over a tensor or a tuple of tensors.
    M_inv : preconditioner application (approximate A⁻¹).
    project : projector onto range(A) applied to residuals/iterates each
        iteration — pass the zero-mean projector for pure-Neumann Poisson.
    dot : ``dot(*pairs)`` → the inner product of each ``(a, b)`` pair;
        the one-device dots by default. A z-sharded solve passes its
        slabs' dots summed over the ranks: the dots an iteration needs
        together (``r·z`` and ``r·r``) come in one call, so they cost one
        collective, and every rank must receive the same values, since
        the loop branches on them.

    The iteration is the JAX package's step for step, so ``iterations``
    counts the same steps: stop when ``r·r ≤ (tol·‖b‖)²`` or at
    ``maxiter``; ``converged`` is ``‖r‖ ≤ tol·‖b‖``.
    """
    if x0 is None:
        x0 = _map(torch.zeros_like, b)
    if project is not None:
        b = project(b)

    r = _axpy(-1.0, A(x0), b)
    if project is not None:
        r = project(r)
    z = M_inv(r) if M_inv is not None else r
    if project is not None and M_inv is not None:
        z = project(z)   # keep preconditioned directions out of the null space
    p = z
    dot = _dots if dot is None else dot
    rz, bb, rr = dot((r, z), (b, b), (r, r))
    b_norm = torch.sqrt(bb)
    atol2 = (tol * b_norm) ** 2
    atol2_host = float(atol2)

    x, it = x0, 0
    # reading rr is the only host synchronisation of an iteration
    while it < maxiter and float(rr) > atol2_host:
        Ap = A(p)
        if project is not None:
            Ap = project(Ap)
        (pap,) = dot((p, Ap))
        alpha = rz / torch.clamp_min(pap, 1e-37)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, Ap, r)
        if project is not None:
            r = project(r)
        z = M_inv(r) if M_inv is not None else r
        if project is not None and M_inv is not None:
            z = project(z)
        rz_new, rr = dot((r, z), (r, r))
        beta = rz_new / torch.clamp_min(rz, 1e-37)
        p = _axpy(beta, p, z)
        rz = rz_new
        it += 1
    res_norm = torch.sqrt(rr)
    return CGResult(x=x, iterations=it, residual_norm=res_norm,
                    converged=bool(res_norm <= torch.sqrt(atol2)))
