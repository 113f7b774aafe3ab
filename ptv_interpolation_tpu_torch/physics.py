"""Divergence cleaning and Poisson solves, matrix-free, on one device.

Counterpart of ``ptv_interpolation_tpu/physics.py``. The reference
assembles sparse operators over fluid cells and solves with scipy
LSQR/CG; here every operator is a full-grid stencil (``ops/stencils.py``),
every solve is matrix-free preconditioned CG (``ops/solvers.py``) with a
geometric multigrid V-cycle (``ops/multigrid.py``), and masks are tensors.

The variational cleaner needs ``Dᵀ`` of the masked 'operator' divergence.
The JAX package takes it from ``jax.linear_transpose``; here it is written
out as a stencil (:func:`ops.stencils.masked_divergence_T`), domain-edge
Neumann terms included, and tested against ``torch.func.vjp`` and against
the JAX transpose.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when no
card is there; results are tensors on that device.

The cleaners also run z-sharded over a mesh of ranks (``mesh=``, the
port's counterpart of the JAX package's cleaning on z-sharded arrays):
each rank solves on its z-slab with the halo exchanges and sums of
``parallel/halo.py`` that GSPMD inserts in JAX.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.ops.multigrid import (
    _pad_to_even,
    make_mg_preconditioner,
    make_mg_preconditioner_batched,
    mg_level_count,
)
from ptv_interpolation_tpu_torch.ops.solvers import _dots, pcg
from ptv_interpolation_tpu_torch.ops.stencils import (
    consistent_correction,
    consistent_divergence,
    divergence_dtd_diag,
    force_divergence,
    laplacian_apply_coeffs,
    laplacian_coeffs,
    laplacian_diag_coeffs,
    masked_divergence,
    masked_divergence_T,
    operator_divergence_coeffs,
)

# re-export reference-named aliases
compute_consistent_divergence = consistent_divergence
apply_consistent_correction = consistent_correction
compute_force_divergence = force_divergence


class CleanResult(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    mean_abs_div_initial: torch.Tensor
    mean_abs_div_final: torch.Tensor
    cg_iterations: int
    converged: bool


def _as_mask(mask, dev):
    return torch.as_tensor(mask, device=dev).to(torch.bool)


def _mean_abs_div(u, v, w, mask, dx, dy, dz):
    div = consistent_divergence(u, v, w, mask, dx, dy, dz)
    n_fluid = torch.clamp_min(mask.sum(), 1)
    return (div.abs() * mask).sum() / n_fluid


def mid_plane_flux(u, dy, dz):
    """Net X-flux through the middle YZ plane (`physics.py:160-165`)."""
    nx = u.shape[2]
    return u[:, :, nx // 2].sum() * dy * dz


def _jacobi(coeffs):
    """``1/diag`` of the masked Laplacian where the diagonal is negative,
    else 0: the Jacobi preconditioner of the CG solves."""
    diag = laplacian_diag_coeffs(coeffs)
    return torch.where(diag < 0, 1.0 / torch.where(diag < 0, diag, -1.0), 0.0)


def divergence_operators(mask, dx, dy, dz, dtype=torch.float32):
    """``(div_op, div_op_T)``: the masked 'operator' divergence ``D̃``
    (a tuple ``(u, v, w)`` → a field) and its adjoint ``D̃ᵀ`` (a field → a
    tuple), with the face coefficients of ``mask`` computed once."""
    maskf = mask.to(dtype)
    coeffs = operator_divergence_coeffs(mask, dtype)

    def div_op(uvw):
        return masked_divergence(uvw, maskf, coeffs, dx, dy, dz)

    def div_op_T(q):
        return masked_divergence_T(q, maskf, coeffs, dx, dy, dz)

    return div_op, div_op_T


# ---------------------------------------------------------------------------
# Projection cleaning
# ---------------------------------------------------------------------------

def clean_divergence_projection(u, v, w, mask, dx, dy, dz, iterations: int = 3,
                                tol: float = 1e-8, maxiter: int = 1000,
                                precond: str = "mg",
                                device="cuda", mesh=None) -> CleanResult:
    """Iterative pressure-projection cleaning (`physics.py:149-209`).

    Each iteration: FV divergence → masked-Laplacian Poisson solve
    (multigrid- or Jacobi-preconditioned CG with zero-mean projection over
    fluid) → staggered-gradient correction.

    With ``mesh`` (``parallel.make_mesh``) every rank of it calls alike
    with the whole fields and mask; each keeps its z-slab on
    ``mesh.device`` (``device`` is not used), solves z-sharded and
    returns the whole cleaned fields, the same on every rank. The JAX
    counterpart returns z-sharded global arrays instead.
    """
    if mesh is not None:
        return _projection_on_slabs(u, v, w, mask, dx, dy, dz, iterations,
                                    tol, maxiter, precond, mesh)
    dev = resolve_device(device)
    mask = _as_mask(mask, dev)
    maskf = mask.float()
    u, v, w = (as_f32(a, dev) * maskf for a in (u, v, w))
    n_fluid = torch.clamp_min(maskf.sum(), 1.0)

    coeffs = laplacian_coeffs(mask, dx, dy, dz)

    def project(x):
        return (x - (x * maskf).sum() / n_fluid) * maskf

    def neg_lap(phi):
        return -laplacian_apply_coeffs(phi, coeffs)

    if precond == "mg":
        m_inv = make_mg_preconditioner(mask, dx, dy, dz)
    else:
        inv_diag = _jacobi(coeffs)

        def m_inv(r):
            return -inv_diag * r

    m_div_init = _mean_abs_div(u, v, w, mask, dx, dy, dz)
    total_iters, conv = 0, True
    for _ in range(iterations):
        div = consistent_divergence(u, v, w, mask, dx, dy, dz) * maskf
        b = project(div)
        # solve Lap φ = b  ⇔  (−Lap) φ = −b (PSD)
        res = pcg(neg_lap, -b, M_inv=m_inv, project=project,
                  tol=tol, maxiter=maxiter)
        u, v, w = consistent_correction(u, v, w, res.x, mask, dx, dy, dz)
        total_iters += res.iterations
        conv = res.converged

    m_div_final = _mean_abs_div(u, v, w, mask, dx, dy, dz)
    return CleanResult(u, v, w, m_div_init, m_div_final, total_iters, conv)


# ---------------------------------------------------------------------------
# Variational cleaning
# ---------------------------------------------------------------------------

def _parity_maps(shape):
    """``(to_parity, from_parity)`` for a ``(nz, ny, nx)`` grid: the field
    padded to even extents and split into its 8 parity sublattices
    ``(8, ez/2, ey/2, ex/2)``, and back (cropped)."""
    nz, ny, nx = shape
    ez, ey, ex = nz + nz % 2, ny + ny % 2, nx + nx % 2

    def to_parity(a):
        ap = _pad_to_even(a, 0).reshape(ez // 2, 2, ey // 2, 2, ex // 2, 2)
        return ap.permute(1, 3, 5, 0, 2, 4).reshape(
            8, ez // 2, ey // 2, ex // 2)

    def from_parity(b):
        a = b.reshape(2, 2, 2, ez // 2, ey // 2, ex // 2)
        a = a.permute(3, 0, 4, 1, 5, 2).reshape(ez, ey, ex)
        return a[:nz, :ny, :nx]

    return to_parity, from_parity


def _woodbury_operators(mask, dx, dy, dz, lambda_reg):
    """The Woodbury system of :func:`clean_divergence_variational`:
    ``(S, m_inv, div_op, div_op_T)`` with ``S q = q/λ + D̃D̃ᵀq`` on fluid
    and ``m_inv`` the parity-decomposed batched V-cycle at spacing 2h with
    screening 1/λ. Building it is the solve's set-up."""
    maskf = mask.float()
    div_op, div_op_T = divergence_operators(mask, dx, dy, dz)

    def S(q):
        return maskf * q / lambda_reg + div_op(div_op_T(q))

    # pad to even so the 8 parity sublattices share one shape and run as
    # one batched V-cycle
    to_parity, from_parity = _parity_maps(mask.shape)
    mg = make_mg_preconditioner_batched(
        to_parity(mask), 2 * dx, 2 * dy, 2 * dz, screening=1.0 / lambda_reg)

    def m_inv(r):
        return from_parity(mg(to_parity(r))) * maskf

    return S, m_inv, div_op, div_op_T


def clean_divergence_variational(u, v, w, mask, dx, dy, dz,
                                 lambda_reg: float = 1e3, tol: float = 1e-8,
                                 maxiter: int = 2000,
                                 solver: str = "woodbury",
                                 device="cuda", mesh=None) -> CleanResult:
    """Variational cleaning (`physics.py:440-514`): minimize
    ``‖U − U0‖² + λ‖div U‖²`` ⇔ solve ``(I + λ D̃ᵀD̃) U = U0``, matrix-free,
    with ``D̃`` the FV divergence restricted to fluid cells.

    ``solver='woodbury'`` (default) reduces the 3n-unknown system by the
    Woodbury identity to the scalar SPD screened system

        ((1/λ) I + D̃D̃ᵀ) q = D̃ U0,     U = U0 − D̃ᵀ q

    whose interior operator is the compact 7-point Laplacian at spacing 2h
    on each of the 8 parity sublattices, so a parity-decomposed geometric
    V-cycle preconditions it. ``solver='direct'`` keeps the literal 3n CG
    formulation with the exact Jacobi diagonal (the oracle the tests hold
    Woodbury against).

    With ``mesh`` it runs z-sharded, as
    :func:`clean_divergence_projection` does: the whole fields in on
    every rank, the whole cleaned fields out on every rank (the JAX
    counterpart returns z-sharded global arrays)."""
    if mesh is not None:
        return _variational_on_slabs(u, v, w, mask, dx, dy, dz, lambda_reg,
                                     tol, maxiter, solver, mesh)
    dev = resolve_device(device)
    mask = _as_mask(mask, dev)
    maskf = mask.float()
    example = tuple(as_f32(a, dev) * maskf for a in (u, v, w))
    m_div_init = _mean_abs_div(*example, mask, dx, dy, dz)

    if solver == "direct":
        div_op, div_op_T = divergence_operators(mask, dx, dy, dz)

        def A(uvw):
            dtu = div_op_T(div_op(uvw))
            return tuple(x * maskf + lambda_reg * y * maskf
                         for x, y in zip(uvw, dtu))

        # Jacobi on the exact per-component diagonal of (I + λ D̃ᵀD̃):
        # boundary-adjacent entries differ from the interior 1 + λ/(2h²)
        # by up to 4× either way
        inv_diag = tuple(1.0 / (1.0 + lambda_reg * d)
                         for d in divergence_dtd_diag(mask, dx, dy, dz))

        def m_inv(uvw):
            return tuple(r * di * maskf for r, di in zip(uvw, inv_diag))

        res = pcg(A, example, M_inv=m_inv, tol=tol, maxiter=maxiter)
        sol = res.x
    else:
        S, m_inv, div_op, div_op_T = _woodbury_operators(mask, dx, dy, dz,
                                                         lambda_reg)
        res = pcg(S, div_op(example), M_inv=m_inv, tol=tol, maxiter=maxiter)
        dt = div_op_T(res.x)
        sol = tuple(x - d * maskf for x, d in zip(example, dt))

    # reference behavior: non-convergence only warns and uses the partial
    # solution; a *broken* solve (NaNs) falls back to the input unchanged
    # (`physics.py:486-491`)
    bad = bool(torch.stack([torch.isnan(x).any() for x in sol]).any())
    u_n, v_n, w_n = example if bad else sol
    m_div_final = _mean_abs_div(u_n, v_n, w_n, mask, dx, dy, dz)
    return CleanResult(u_n, v_n, w_n, m_div_init, m_div_final,
                       res.iterations, res.converged and not bad)


def clean_divergence(u, v, w, mask, dx, dy, dz, iterations: int = 3,
                     method: str = "projection", lambda_reg: float = 1e3,
                     verbose: bool = True, device="cuda", mesh=None):
    """Dispatcher matching the reference signature (`physics.py:347-354`).
    Returns ``(u, v, w)`` tensors on ``device``; diagnostics are printed
    like the reference's cleaning reports when ``verbose``. With ``mesh``
    the cleaner runs z-sharded and every rank of the mesh returns the
    whole fields on ``mesh.device``."""
    dev = resolve_device(device) if mesh is None else mesh.device
    if method == "variational":
        if verbose:
            print(f"Starting Variational Divergence Cleaning (lambda={lambda_reg})...")
        res = clean_divergence_variational(u, v, w, mask, dx, dy, dz,
                                           lambda_reg=lambda_reg, device=dev,
                                           mesh=mesh)
        title = "VARIATIONAL CLEANING COMPLETE"
    else:
        if verbose:
            print(f"Starting Iterative Divergence Cleaning ({iterations} iterations)...")
            print(f"  [Initial] Net X-Flux (mid-plane): "
                  f"{float(mid_plane_flux(as_f32(u, dev), dy, dz)):.4e}")
        res = clean_divergence_projection(u, v, w, mask, dx, dy, dz,
                                          iterations=iterations, device=dev,
                                          mesh=mesh)
        title = "DIVERGENCE CLEANING COMPLETE"
    if verbose:
        init = float(res.mean_abs_div_initial)
        final = float(res.mean_abs_div_final)
        print("\n" + "=" * 40)
        print(title)
        print(f"Initial Mean Abs Div: {init:.6e}")
        print(f"Final Mean Abs Div:   {final:.6e}")
        reduction = init / final if final > 0 else float("inf")
        print(f"Total Reduction:      {reduction:.2f}x")
        print(f"CG iterations:        {int(res.cg_iterations)}")
        if not bool(res.converged):
            print("  Warning: CG did not converge to tolerance "
                  "(variational falls back to the input field).")
        if method != "variational":
            print(f"  [Final] Net X-Flux (mid-plane): "
                  f"{float(mid_plane_flux(res.u, dy, dz)):.4e}")
        print("=" * 40 + "\n")
    return res.u, res.v, res.w


# ---------------------------------------------------------------------------
# Z-sharded cleaning: each rank solves on its z-slab
# ---------------------------------------------------------------------------

class _SlabGrid:
    """This rank's z-slab of a mask that every rank holds whole, and the
    cleaning operators on slabs of fields.

    Each operator that reads z ± 1 follows one rule: extend its operands
    by a halo (``parallel.halo.ZSlabs``), apply the unchanged one-device
    operator, crop the halo planes. An operand that the operator reads
    only in its own plane takes zero planes in place of a halo, unless the
    result's halo planes feed a second operator. The mask's halos are cut
    from the whole mask, so they cost no exchange."""

    def __init__(self, mask, mesh, n_levels: int, unit: int, spacing):
        from ptv_interpolation_tpu_torch.parallel.halo import (ZSlabs,
                                                               mg_slab_plan)
        whole = _as_mask(mask, mesh.device)
        bounds, self.n_sharded = mg_slab_plan(whole.shape[0], mesh, n_levels,
                                              unit)
        self.slabs = sl = ZSlabs(mesh, bounds)
        self.mask = sl.take(whole)
        self.maskf = self.mask.float()
        # the mask with halos of 1 and 2 planes
        self.mask_e = (sl.take(whole, 1), sl.take(whole, 2))
        self.n_fluid = torch.clamp_min(whole.sum(), 1)
        self.h = tuple(spacing)

    def field(self, a) -> torch.Tensor:
        """This rank's slab of the whole field ``a``, f32, zero on solid."""
        return self.slabs.take(a, dtype=torch.float32) * self.maskf

    def gather(self, fields):
        """The whole fields from their slabs, in one all-gather."""
        return self.slabs.gather(torch.stack(fields)).unbind()

    def dot(self, *pairs):
        """:func:`pcg`'s ``dot``: the slabs' dots, one all-reduce."""
        from ptv_interpolation_tpu_torch.parallel.halo import allreduce_sum
        return allreduce_sum(self.slabs.mesh, torch.stack(_dots(*pairs))
                             ).unbind()

    def divergence(self, u, v, w):
        """:func:`consistent_divergence` (the 'roll' variant)."""
        sl = self.slabs
        return sl.crop(consistent_divergence(
            sl.pad(u), sl.pad(v), sl.extend(w), self.mask_e[0], *self.h))

    def mean_abs_div(self, u, v, w):
        """:func:`_mean_abs_div` over the whole grid."""
        return (self.slabs.sum(self.divergence(u, v, w).abs() * self.mask)
                / self.n_fluid)

    @functools.cached_property
    def _lap_coeffs(self):
        return laplacian_coeffs(self.mask_e[0], *self.h)

    def neg_lap(self, phi):
        """``−Lap φ`` of the masked Laplacian."""
        sl = self.slabs
        return -sl.crop(laplacian_apply_coeffs(sl.extend(phi),
                                               self._lap_coeffs))

    def jacobi(self):
        """:func:`_jacobi` of the masked Laplacian."""
        return self.slabs.crop(_jacobi(self._lap_coeffs))

    def correction(self, u, v, w, phi):
        """:func:`consistent_correction` by the potential ``φ``."""
        sl = self.slabs
        return tuple(sl.crop(a) for a in consistent_correction(
            sl.pad(u), sl.pad(v), sl.pad(w), sl.extend(phi), self.mask_e[0],
            *self.h))

    @functools.cached_property
    def _op_coeffs(self):
        """``(maskf, coeffs)`` of ``D̃`` on the masks with halos 1 and 2."""
        return tuple((m.float(), operator_divergence_coeffs(m))
                     for m in self.mask_e)

    def _div(self, uvw, width):
        maskf, coeffs = self._op_coeffs[width - 1]
        return self.slabs.crop(masked_divergence(uvw, maskf, coeffs,
                                                 *self.h))

    def _div_T(self, q, width):
        maskf, coeffs = self._op_coeffs[width - 1]
        return tuple(self.slabs.crop(d) for d in masked_divergence_T(
            q, maskf, coeffs, *self.h))

    def div_op(self, uvw):
        """``D̃ U`` (:func:`masked_divergence`)."""
        u, v, w = uvw
        sl = self.slabs
        return self._div((sl.pad(u), sl.pad(v), sl.extend(w)), 1)

    def div_op_T(self, q):
        """``D̃ᵀ q`` (:func:`masked_divergence_T`)."""
        return self._div_T(self.slabs.extend(q), 1)

    def woodbury_S(self, q, lambda_reg):
        """``q/λ + D̃(D̃ᵀq)`` on fluid: one halo of 2 planes, one crop per
        factor."""
        return self.maskf * q / lambda_reg + self._div(
            self._div_T(self.slabs.extend(q, 2), 2), 1)

    def direct_A(self, uvw, lambda_reg):
        """``(I + λ D̃ᵀD̃) U`` on fluid. ``D̃``'s halo plane feeds ``D̃ᵀ``,
        so every component takes the halo of 2 planes."""
        d = self._div(self.slabs.extend(torch.stack(uvw), 2).unbind(), 2)
        return tuple(x * self.maskf + lambda_reg * y * self.maskf
                     for x, y in zip(uvw, self._div_T(d, 1)))

    def dtd_diag(self):
        """:func:`divergence_dtd_diag`."""
        return tuple(self.slabs.crop(d)
                     for d in divergence_dtd_diag(self.mask_e[0], *self.h))


def _projection_on_slabs(u, v, w, mask, dx, dy, dz, iterations, tol,
                         maxiter, precond, mesh) -> CleanResult:
    """:func:`clean_divergence_projection` over ``mesh``: the same loop on
    this rank's slab, the fluid means and dots summed over the ranks, and
    the V-cycle the one-device hierarchy, sharded
    (:func:`make_mg_preconditioner`)."""
    whole = _as_mask(mask, mesh.device)
    n_levels = mg_level_count(whole.shape) if precond == "mg" else 1
    g = _SlabGrid(whole, mesh, n_levels, 1, (dx, dy, dz))
    maskf = g.maskf
    u, v, w = (g.field(a) for a in (u, v, w))

    def project(x):
        return (x - g.slabs.sum(x * maskf) / g.n_fluid) * maskf

    if precond == "mg":
        m_inv = make_mg_preconditioner(whole, dx, dy, dz, slabs=g.slabs,
                                       n_sharded=g.n_sharded)
    else:
        inv_diag = g.jacobi()

        def m_inv(r):
            return -inv_diag * r

    m_div_init = g.mean_abs_div(u, v, w)
    total_iters, conv = 0, True
    for _ in range(iterations):
        b = project(g.divergence(u, v, w) * maskf)
        res = pcg(g.neg_lap, -b, M_inv=m_inv, project=project, tol=tol,
                  maxiter=maxiter, dot=g.dot)
        u, v, w = g.correction(u, v, w, res.x)
        total_iters += res.iterations
        conv = res.converged

    m_div_final = g.mean_abs_div(u, v, w)
    return CleanResult(*g.gather((u, v, w)), m_div_init, m_div_final,
                       total_iters, conv)


def _variational_on_slabs(u, v, w, mask, dx, dy, dz, lambda_reg, tol,
                          maxiter, solver, mesh) -> CleanResult:
    """:func:`clean_divergence_variational` over ``mesh``, on this rank's
    slab. Every slab boundary is even, so the 8 parity sublattices split
    locally, and a multiple of the parity V-cycle's sharded alignment."""
    whole = _as_mask(mask, mesh.device)
    parity_mask = _parity_maps(whole.shape)[0](whole)
    n_levels = (mg_level_count(parity_mask.shape) if solver != "direct"
                else 1)
    g = _SlabGrid(whole, mesh, n_levels, 2, (dx, dy, dz))
    maskf = g.maskf
    example = tuple(g.field(a) for a in (u, v, w))
    m_div_init = g.mean_abs_div(*example)

    if solver == "direct":
        inv_diag = tuple(1.0 / (1.0 + lambda_reg * d) for d in g.dtd_diag())

        def m_inv(uvw):
            return tuple(r * di * maskf for r, di in zip(uvw, inv_diag))

        res = pcg(lambda uvw: g.direct_A(uvw, lambda_reg), example,
                  M_inv=m_inv, tol=tol, maxiter=maxiter, dot=g.dot)
        sol = res.x
    else:
        to_parity, from_parity = _parity_maps(maskf.shape)
        mg = make_mg_preconditioner_batched(
            parity_mask, 2 * dx, 2 * dy, 2 * dz, screening=1.0 / lambda_reg,
            slabs=g.slabs.coarsen(), n_sharded=g.n_sharded)

        def m_inv(r):
            return from_parity(mg(to_parity(r))) * maskf

        res = pcg(lambda q: g.woodbury_S(q, lambda_reg), g.div_op(example),
                  M_inv=m_inv, tol=tol, maxiter=maxiter, dot=g.dot)
        sol = tuple(x - d * maskf for x, d in zip(example,
                                                  g.div_op_T(res.x)))

    # the NaN fallback, decided alike on every rank
    bad = bool(g.slabs.sum(torch.stack([torch.isnan(x).any()
                                        for x in sol]).float()) > 0)
    u_n, v_n, w_n = example if bad else sol
    m_div_final = g.mean_abs_div(u_n, v_n, w_n)
    return CleanResult(*g.gather((u_n, v_n, w_n)), m_div_init, m_div_final,
                       res.iterations, res.converged and not bad)


# ---------------------------------------------------------------------------
# Poisson solver (pressure recovery)
# ---------------------------------------------------------------------------

def _solve_poisson_impl(rhs_field, mask, dx, dy, dz, dirichlet_mask,
                        dirichlet_values, wall_bc: str, has_dirichlet: bool,
                        tol: float, maxiter: int, precond: str = "mg"):
    """The solve of :func:`solve_poisson` on tensors of one device:
    ``(p, iterations, converged)``."""
    maskf = mask.float()
    b = rhs_field * maskf

    coeffs = laplacian_coeffs(mask, dx, dy, dz)

    def make_m_inv(solve_mask):
        if precond == "mg":
            return make_mg_preconditioner(solve_mask, dx, dy, dz)
        inv_diag, smf = _jacobi(coeffs), solve_mask.float()
        return lambda r: -inv_diag * r * smf

    if has_dirichlet:
        d_mask = dirichlet_mask & mask
        free = mask & ~d_mask
        freef = free.float()
        d_field = torch.where(d_mask, dirichlet_values, 0.0)
        # b_f -= A_fd x_d   (reference `physics.py:299-307`)
        b_eff = (b - laplacian_apply_coeffs(d_field, coeffs)) * freef

        def neg_lap_free(phi):
            return -laplacian_apply_coeffs(phi * freef, coeffs) * freef

        # the MG hierarchy uses the free mask, so Dirichlet cells act as
        # walls inside the preconditioner — approximate but SPD
        res = pcg(neg_lap_free, -b_eff, M_inv=make_m_inv(free),
                  tol=tol, maxiter=maxiter)
        p = res.x * freef + d_field
    else:
        n_fluid = torch.clamp_min(maskf.sum(), 1.0)

        def project(x):
            return (x - (x * maskf).sum() / n_fluid) * maskf

        def neg_lap(phi):
            return -laplacian_apply_coeffs(phi, coeffs)

        b_eff = project(b)
        res = pcg(neg_lap, -b_eff, M_inv=make_m_inv(mask),
                  project=project, tol=tol, maxiter=maxiter)
        p = res.x
    return p * maskf, res.iterations, res.converged


def solve_poisson(source, mask, dx, dy, dz, force_field=None,
                  wall_bc: str = "inhomogeneous", dirichlet_mask=None,
                  dirichlet_values=0.0, tol: float = 1e-8,
                  maxiter: int = 3000, precond: str = "mg", device="cuda"):
    """Solve ``Lap(p) = source`` on the fluid domain (`physics.py:264-345`).

    ``force_field=(fx, fy, fz)`` computes the RHS as a consistent face-flux
    divergence with ``wall_bc`` boundary treatment. ``dirichlet_mask`` pins
    nodes to ``dirichlet_values`` (scalar or field); otherwise the singular
    pure-Neumann system is solved with zero-mean projection. Returns ``p``
    on ``device``.
    """
    dev = resolve_device(device)
    mask = _as_mask(mask, dev)
    if int(mask.sum()) == 0:
        return torch.zeros(mask.shape, dtype=torch.float32, device=dev)
    if force_field is not None:
        fx, fy, fz = (as_f32(f, dev) for f in force_field)
        rhs_field = force_divergence(fx, fy, fz, mask, dx, dy, dz,
                                     wall_bc=wall_bc)
    else:
        rhs_field = as_f32(source, dev)

    has_dirichlet = dirichlet_mask is not None
    d_mask = (_as_mask(dirichlet_mask, dev) if has_dirichlet
              else torch.zeros(mask.shape, dtype=torch.bool, device=dev))
    d_vals = as_f32(dirichlet_values, dev)
    p, _, _ = _solve_poisson_impl(rhs_field, mask, dx, dy, dz, d_mask, d_vals,
                                  wall_bc, has_dirichlet, tol, maxiter,
                                  precond)
    return p
