"""Geometric multigrid V-cycle preconditioner for the masked Poisson solves.

Counterpart of ``ptv_interpolation_tpu/ops/multigrid.py``: masks coarsen
by any-child-fluid, operators re-discretize on the coarse masks with
doubled spacing, smoothing is damped Jacobi (symmetric, so the
preconditioner stays CG-compatible), restriction is the child average and
prolongation injection. The level plan comes from the static grid shape.

The stencils count their spatial axes from the end, so one V-cycle serves
a single grid and a batch of them (the variational cleaner's 8 parity
sublattices) alike; each level's face coefficients and diagonal are
computed once, when the preconditioner is built.
"""

from __future__ import annotations

from ptv_interpolation_tpu_torch.ops.stencils import (laplacian_apply_coeffs,
                                                      laplacian_coeffs,
                                                      laplacian_diag_coeffs)


def _pad_to_even(a, fill=0):
    """``a`` padded at the far end of each odd spatial axis with ``fill``."""
    *lead, nz, ny, nx = a.shape
    if not (nz % 2 or ny % 2 or nx % 2):
        return a
    out = a.new_full((*lead, nz + nz % 2, ny + ny % 2, nx + nx % 2), fill)
    out[..., :nz, :ny, :nx] = a
    return out


def _blocks(a):
    """The 2×2×2 children of each coarse cell: (…, nz/2, 2, ny/2, 2, nx/2, 2)."""
    *lead, nz, ny, nx = a.shape
    return a.reshape(*lead, nz // 2, 2, ny // 2, 2, nx // 2, 2)


def _coarsen_mask(mask):
    m = _blocks(_pad_to_even(mask, False))
    return m.any(dim=-1).any(dim=-2).any(dim=-3)


def _restrict(r):
    """Child-average restriction (adjoint of injection up to the 1/8)."""
    return _blocks(_pad_to_even(r, 0.0)).sum(dim=(-5, -3, -1)) * 0.125


def _prolong(e, fine_shape):
    """Injection: copy each coarse value to its 2³ children."""
    *lead, nz, ny, nx = e.shape
    ef = e[..., :, None, :, None, :, None].expand(
        *lead, nz, 2, ny, 2, nx, 2).reshape(*lead, 2 * nz, 2 * ny, 2 * nx)
    return ef[..., :fine_shape[-3], :fine_shape[-2], :fine_shape[-1]]


def mg_level_count(shape, min_size: int = 8) -> int:
    """The number of levels :func:`make_mg_preconditioner` plans for a grid
    of spatial ``shape`` (nz, ny, nx): it coarsens, each odd axis padded,
    while the smallest extent exceeds ``min_size``."""
    shape, n = tuple(shape[-3:]), 1
    while min(shape) > min_size:
        shape = tuple(-(-s // 2) for s in shape)
        n += 1
    return n


def make_mg_preconditioner(mask, dx, dy, dz, n_smooth: int = 2,
                           omega: float = 0.8, min_size: int = 8,
                           coarse_iters: int = 20, screening=0.0,
                           slabs=None, n_sharded: int = 0):
    """Build ``M_inv(r)`` approximating ``(εI − Lap)⁻¹`` on the fluid cells
    of ``mask`` (a bool tensor, ``(…, nz, ny, nx)``) — pass as the
    ``M_inv`` of :func:`ops.solvers.pcg` (which solves the
    positive-definite ``−Lap``). ``screening`` ε ≥ 0 turns the operator
    into the screened (Helmholtz-like) Poisson problem used by the
    variational cleaner's Woodbury solve. Levels coarsen while the
    smallest spatial extent exceeds ``min_size``; leading axes are a
    batch of independent grids.

    Sharded form: ``mask`` is whole on every rank, ``slabs``
    (:class:`parallel.halo.ZSlabs`) cuts its z-axis and ``n_sharded``
    levels run on z-slabs (:func:`parallel.halo.mg_slab_plan` gives
    both); ``M_inv`` then maps this rank's slab of ``r`` to its slab of
    the one-device V-cycle's result. The hierarchy is planned from the
    whole mask, so it is the one-device one. A sharded level takes one
    halo exchange per Jacobi sweep and per residual, and its restriction
    and prolongation are local; the residual of the last sharded level is
    all-gathered and the coarser levels run whole on every rank, each
    keeping its slab of the correction."""
    masks = [mask]
    spacings = [(dx, dy, dz)]
    while min(masks[-1].shape[-3:]) > min_size:
        masks.append(_coarsen_mask(masks[-1]))
        sx, sy, sz = spacings[-1]
        spacings.append((sx * 2, sy * 2, sz * 2))
    n_levels = len(masks)
    # the z-slabs of each sharded level
    level_slabs = []
    for _ in range(n_sharded if slabs is not None else 0):
        level_slabs.append(slabs)
        slabs = slabs.coarsen()

    maskfs, coeffs, diags = [], [], []
    for lvl, (m, s) in enumerate(zip(masks, spacings)):
        if lvl < len(level_slabs):
            sl = level_slabs[lvl]
            c = laplacian_coeffs(sl.take(m, 1), *s)
            d = -sl.crop(laplacian_diag_coeffs(c))     # positive
            m = sl.take(m)
        else:
            c = laplacian_coeffs(m, *s)
            d = -laplacian_diag_coeffs(c)              # positive
        maskfs.append(m.float())
        coeffs.append(c)
        diags.append(d.masked_fill(d <= 0, 1.0) + screening)

    def neg_lap(x, lvl):
        if lvl < len(level_slabs):
            sl = level_slabs[lvl]
            return screening * x - sl.crop(
                laplacian_apply_coeffs(sl.extend(x), coeffs[lvl]))
        return screening * x - laplacian_apply_coeffs(x, coeffs[lvl])

    def smooth(x, b, lvl, sweeps):
        for _ in range(sweeps):
            x = x + omega * (b - neg_lap(x, lvl)) / diags[lvl]
            x = x * maskfs[lvl]
        return x

    def v_cycle(b, lvl):
        zero = b.new_zeros(b.shape)
        if lvl == n_levels - 1:
            return smooth(zero, b, lvl, coarse_iters)
        x = smooth(zero, b, lvl, n_smooth)
        r = (b - neg_lap(x, lvl)) * maskfs[lvl]
        if lvl == len(level_slabs) - 1:
            # the last sharded level: the coarser ones run whole
            sl = level_slabs[lvl]
            ec = v_cycle(_restrict(sl.gather(r)) * maskfs[lvl + 1], lvl + 1)
            e = sl.take(_prolong(ec, masks[lvl].shape))
        else:
            ec = v_cycle(_restrict(r) * maskfs[lvl + 1], lvl + 1)
            e = _prolong(ec, x.shape)
        x = x + e * maskfs[lvl]
        return smooth(x, b, lvl, n_smooth)

    def m_inv(r):
        return v_cycle(r * maskfs[0], 0)

    return m_inv


# The JAX package's name for the batched form (it maps its V-cycle over a
# leading axis); the V-cycle above serves a batch of grids as it is.
make_mg_preconditioner_batched = make_mg_preconditioner
