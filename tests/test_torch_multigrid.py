"""The port's multigrid V-cycle (``ops/multigrid.py``) and preconditioned
CG (``ops/solvers.py``) against the JAX package's on the same residuals
and right-hand sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from ptv_interpolation_tpu.ops import multigrid as jmg
from ptv_interpolation_tpu.ops import solvers as jsol
from ptv_interpolation_tpu.ops.stencils import laplacian_apply as jax_lap
from ptv_interpolation_tpu_torch.ops import multigrid as tmg
from ptv_interpolation_tpu_torch.ops import solvers as tsol
from ptv_interpolation_tpu_torch.ops.stencils import laplacian_apply
from ptv_interpolation_tpu_torch.physics import _parity_maps
from test_physics import _sphere_mask

torch.set_num_threads(2)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("shape", [(7, 10, 9), (8, 8, 8), (2, 5, 6, 3)])
def test_transfers_match_jax(shape):
    """Coarsening, restriction and prolongation on odd and even extents,
    and with a leading batch axis (the JAX package maps over it)."""
    import jax
    rng = np.random.default_rng(0)
    mask = rng.random(shape) > 0.6
    r = rng.normal(size=shape).astype(np.float32)
    batched = len(shape) == 4
    j_coarsen = jax.vmap(jmg._coarsen_mask) if batched else jmg._coarsen_mask
    j_restrict = (jax.vmap(lambda a: jmg._restrict(a, None)) if batched
                  else lambda a: jmg._restrict(a, None))
    got_m = tmg._coarsen_mask(torch.as_tensor(mask))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(j_coarsen(mask)))
    got_r = tmg._restrict(torch.as_tensor(r))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(j_restrict(r)),
                               rtol=1e-6, atol=1e-7)
    e = got_r.numpy()
    want_p = (jax.vmap(jmg._prolong, in_axes=(0, None))(e, shape[1:])
              if batched else jmg._prolong(e, shape))
    np.testing.assert_array_equal(
        tmg._prolong(torch.as_tensor(e), shape).numpy(), np.asarray(want_p))


def test_v_cycle_matches_jax():
    """One application of the plain V-cycle (Poisson, no screening) to the
    same residual, on the 24³ sphere mask of ``test_physics.py``."""
    mask = _sphere_mask(24)
    rng = np.random.default_rng(7)
    r = (rng.normal(size=mask.shape) * mask).astype(np.float32)
    h = (1.0, 0.9, 1.2)
    want = jmg.make_mg_preconditioner(mask, *h)(jnp.asarray(r))
    got = tmg.make_mg_preconditioner(torch.as_tensor(mask), *h)(
        torch.as_tensor(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    assert _rel_l2(got.numpy(), want) < 1e-6


def test_v_cycle_batched_with_screening_matches_jax():
    """The variational cleaner's preconditioner: the 8 parity sublattices
    of the odd anisotropic problem as one batch, spacing 2h, screening
    1/λ at λ = 200."""
    fluid, _, _, _, (dx, dy, dz) = fx.odd_anisotropic()
    to_parity, _ = _parity_maps(fluid.shape)
    pm = to_parity(torch.as_tensor(fluid))
    assert tuple(pm.shape) == (8, 11, 12, 14)
    rng = np.random.default_rng(3)
    r = (rng.normal(size=pm.shape) * pm.numpy()).astype(np.float32)
    kw = dict(screening=1.0 / 200.0)
    want = jmg.make_mg_preconditioner_batched(
        pm.numpy(), 2 * dx, 2 * dy, 2 * dz, **kw)(jnp.asarray(r))
    got = tmg.make_mg_preconditioner_batched(
        pm, 2 * dx, 2 * dy, 2 * dz, **kw)(torch.as_tensor(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # the batch is 8 independent sublattices
    one = tmg.make_mg_preconditioner(pm[5], 2 * dx, 2 * dy, 2 * dz, **kw)(
        torch.as_tensor(r[5]))
    np.testing.assert_allclose(got[5].numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-7)


def _poisson_system(n=24):
    mask = _sphere_mask(n)
    rng = np.random.default_rng(7)
    b = (rng.normal(size=mask.shape) * mask).astype(np.float32)
    b -= (mask * b[mask].mean()).astype(np.float32)
    return mask, b


# Unpreconditioned CG on this system takes ~150 steps to 1e-8, the last
# ~20 with its residual at the f32 floor (1e-8·‖b‖), where the count is
# set by rounding: the JAX package's CPU dot sums sequentially, and its
# count there is 168 against the port's 151, while at 1e-5, 1e-6 and 1e-7
# the two take 105/105, 123/123 and 140/138 steps. So plain CG is held to
# ±2 at 1e-6.
@pytest.mark.parametrize("precond,tol", [("mg", 1e-8), ("none", 1e-6)])
def test_pcg_projected_matches_jax(precond, tol):
    """Pure-Neumann Poisson (zero-mean projection), MG-preconditioned and
    plain: the same iteration count within ±2 and the same solution
    within 1e-5 relative."""
    mask, b = _poisson_system()
    h = (1.0, 1.0, 1.0)
    n_fluid = float(mask.sum())

    jm = jnp.asarray(mask, jnp.float32)
    want = jsol.pcg(lambda x: -jax_lap(x, mask, *h), jnp.asarray(-b),
                    M_inv=(jmg.make_mg_preconditioner(mask, *h)
                           if precond == "mg" else None),
                    project=lambda x: (x - jnp.sum(x * jm) / n_fluid) * jm,
                    tol=tol, maxiter=5000)

    m = torch.as_tensor(mask)
    tm = m.float()
    got = tsol.pcg(lambda x: -laplacian_apply(x, m, *h),
                   torch.as_tensor(-b),
                   M_inv=(tmg.make_mg_preconditioner(m, *h)
                          if precond == "mg" else None),
                   project=lambda x: (x - (x * tm).sum() / n_fluid) * tm,
                   tol=tol, maxiter=5000)
    assert got.converged and bool(want.converged)
    assert abs(got.iterations - int(want.iterations)) <= 2, (
        got.iterations, int(want.iterations))
    assert _rel_l2(got.x.numpy(), want.x) < 1e-5
    np.testing.assert_allclose(float(got.residual_norm),
                               float(want.residual_norm), rtol=0.5)


def test_pcg_over_a_tuple_matches_jax():
    """An SPD system over a tuple of two fields (the JAX package's pytree),
    unprojected, with a Jacobi-like preconditioner."""
    mask, b = _poisson_system(16)
    h = (1.0, 1.3, 0.7)
    b2 = np.ascontiguousarray(b[::-1] * mask).astype(np.float32)

    def make(lap, asarr):
        def A(xy):
            x, y = xy
            return (0.5 * x - lap(x), 2.0 * y - lap(y))

        def m_inv(xy):
            return (xy[0] * 0.2, xy[1] * 0.1)
        return A, m_inv, (asarr(b), asarr(b2))

    A, m_inv, rhs = make(lambda x: jax_lap(x, mask, *h), jnp.asarray)
    want = jsol.pcg(A, rhs, M_inv=m_inv, tol=1e-7, maxiter=500)
    m = torch.as_tensor(mask)
    A, m_inv, rhs = make(lambda x: laplacian_apply(x, m, *h),
                         torch.as_tensor)
    got = tsol.pcg(A, rhs, M_inv=m_inv, tol=1e-7, maxiter=500)
    assert isinstance(got.x, tuple) and len(got.x) == 2
    assert abs(got.iterations - int(want.iterations)) <= 2
    for g, w in zip(got.x, want.x):
        assert _rel_l2(g.numpy(), w) < 1e-5


def test_pcg_zero_rhs_and_maxiter():
    """``b = 0`` stops before the first step and counts as converged;
    ``maxiter`` caps the count, as in the JAX package."""
    mask, b = _poisson_system(12)
    m = torch.as_tensor(mask)

    def A(x):
        return x - laplacian_apply(x, m, 1.0, 1.0, 1.0)

    zero = tsol.pcg(A, torch.zeros(mask.shape))
    want = jsol.pcg(lambda x: x - jax_lap(x, mask, 1.0, 1.0, 1.0),
                    jnp.zeros(mask.shape, jnp.float32))
    assert zero.iterations == int(want.iterations) == 0
    assert zero.converged and bool(want.converged)
    capped = tsol.pcg(A, torch.as_tensor(b), maxiter=3)
    assert capped.iterations == 3 and not capped.converged
