"""The port's FV stencils (``ptv_interpolation_tpu_torch/ops/stencils.py``)
against the JAX package's on the same numpy inputs, and the adjoint of
the masked 'operator' divergence that the variational cleaner uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from ptv_interpolation_tpu.ops import stencils as js
from ptv_interpolation_tpu_torch.ops import stencils as ts
from ptv_interpolation_tpu_torch.physics import divergence_operators

torch.set_num_threads(2)

# f32 operators whose op order follows the JAX formulas; a division by a
# Python scalar may round differently
RTOL, ATOL = 1e-6, 1e-6

PROBLEMS = {
    "sphere": lambda: fx.sphere_problem(16)[:4] + ((1.0, 0.9, 1.1),),
    "odd_anisotropic": fx.odd_anisotropic,
}


def _problem(name):
    fluid, u, v, w, h = PROBLEMS[name]()
    return fluid, (u, v, w), h


def _t(*arrays):
    return tuple(torch.as_tensor(np.asarray(a)) for a in arrays)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("offset", [1, -1, 2, -3, 0, 30])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_shift_matches_jax(offset, axis):
    rng = np.random.default_rng(axis)
    a = rng.normal(size=(5, 6, 7)).astype(np.float32)
    m = rng.random((5, 6, 7)) > 0.5
    np.testing.assert_array_equal(
        ts.shift(torch.as_tensor(a), offset, axis, 0.0).numpy(),
        np.asarray(js.shift(a, offset, axis, 0.0)))
    np.testing.assert_array_equal(
        ts.shift(torch.as_tensor(m), offset, axis, False).numpy(),
        np.asarray(js.shift(m, offset, axis, False)))


@pytest.mark.parametrize("variant", ["roll", "operator"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_consistent_divergence_matches_jax(name, variant):
    fluid, uvw, h = _problem(name)
    want = js.consistent_divergence(*uvw, fluid, *h, variant=variant)
    got = ts.consistent_divergence(*_t(*uvw), torch.as_tensor(fluid), *h,
                                   variant=variant)
    _close(got, want)


def test_divergence_variants_differ_where_the_reference_does():
    """The two conventions differ at fluid cells with a solid lower
    neighbour, in the port as in the reference."""
    fluid, uvw, h = _problem("sphere")
    m = torch.as_tensor(fluid)
    d_roll = ts.consistent_divergence(*_t(*uvw), m, *h, variant="roll")
    d_op = ts.consistent_divergence(*_t(*uvw), m, *h, variant="operator")
    assert float((d_roll - d_op).abs()[m].max()) > 1e-4


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_laplacian_apply_and_diag_match_jax(name):
    fluid, _, h = _problem(name)
    rng = np.random.default_rng(1)
    phi = (rng.normal(size=fluid.shape) * fluid).astype(np.float32)
    m = torch.as_tensor(fluid)
    _close(ts.laplacian_apply(torch.as_tensor(phi), m, *h),
           js.laplacian_apply(phi, fluid, *h))
    _close(ts.laplacian_diag(m, *h), js.laplacian_diag(fluid, *h))
    # the prepared coefficients give the same operator
    coeffs = ts.laplacian_coeffs(m, *h)
    _close(ts.laplacian_apply_coeffs(torch.as_tensor(phi), coeffs),
           js.laplacian_apply(phi, fluid, *h))


@pytest.mark.parametrize("name", sorted(PROBLEMS) + ["faces"])
def test_divergence_dtd_diag_matches_jax(name):
    if name == "faces":
        fluid, h = fx.faces_mask(), (1.0, 0.8, 1.3)
    else:
        fluid, _, h = _problem(name)
    got = ts.divergence_dtd_diag(torch.as_tensor(fluid), *h)
    for g, w in zip(got, js.divergence_dtd_diag(jnp.asarray(fluid), *h)):
        _close(g, w)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_consistent_correction_matches_jax(name):
    fluid, uvw, h = _problem(name)
    rng = np.random.default_rng(2)
    phi = (rng.normal(size=fluid.shape) * fluid).astype(np.float32)
    want = js.consistent_correction(*uvw, phi, fluid, *h)
    got = ts.consistent_correction(*_t(*uvw, phi), torch.as_tensor(fluid),
                                   *h)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("wall_bc", ["zero-neumann", "inhomogeneous"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_force_divergence_matches_jax(name, wall_bc):
    fluid, _, h = _problem(name)
    rng = np.random.default_rng(5)
    f = [rng.normal(size=fluid.shape).astype(np.float32) for _ in range(3)]
    want = js.force_divergence(*f, fluid, *h, wall_bc=wall_bc)
    got = ts.force_divergence(*_t(*f), torch.as_tensor(fluid), *h,
                              wall_bc=wall_bc)
    _close(got, want)


@pytest.mark.parametrize("shape", [(8, 9, 10), (1, 2, 5)])
def test_gradient_matches_jax_and_numpy(shape):
    rng = np.random.default_rng(2)
    f = rng.normal(size=shape).astype(np.float32)
    got = ts.gradient(torch.as_tensor(f), 1.3, 0.9, 1.1)
    for g, w in zip(got, js.gradient(f, 1.3, 0.9, 1.1)):
        _close(g, w)
    if min(shape) > 1:
        for g, w in zip(got, np.gradient(f.astype(np.float64), 1.1, 0.9,
                                         1.3)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


def test_operators_take_a_leading_batch_axis():
    """Every operator counts its spatial axes from the end: a stack of two
    problems gives each problem's own result."""
    f1, uvw1, h = _problem("odd_anisotropic")
    f2 = fx.faces_mask(f1.shape, seed=3)
    uvw2 = tuple(a[::-1].copy() * f2 for a in uvw1)
    m = torch.as_tensor(np.stack([f1, f2]))
    uvw = tuple(torch.as_tensor(np.stack([a, b])) for a, b in zip(uvw1, uvw2))
    phi = uvw[0]
    maskf = m.float()
    c_op = ts.operator_divergence_coeffs(m)
    batched = {
        "roll": ts.consistent_divergence(*uvw, m, *h),
        "lap": ts.laplacian_apply(phi, m, *h),
        "diag": ts.laplacian_diag(m, *h),
        "div_op": ts.masked_divergence(uvw, maskf, c_op, *h),
        "div_op_T": torch.stack(ts.masked_divergence_T(phi, maskf, c_op,
                                                       *h)),
    }
    for i in range(2):
        mi, ui = m[i], tuple(a[i] for a in uvw)
        ci = ts.operator_divergence_coeffs(mi)
        single = {
            "roll": ts.consistent_divergence(*ui, mi, *h),
            "lap": ts.laplacian_apply(ui[0], mi, *h),
            "diag": ts.laplacian_diag(mi, *h),
            "div_op": ts.masked_divergence(ui, mi.float(), ci, *h),
            "div_op_T": torch.stack(ts.masked_divergence_T(
                ui[0], mi.float(), ci, *h)),
        }
        for key, want in single.items():
            got = batched[key][:, i] if key == "div_op_T" else batched[key][i]
            assert torch.equal(got, want), key


# ------------------------------------------------ D̃ and its adjoint D̃ᵀ

def _jax_div_op(fluid, h):
    maskb = jnp.asarray(fluid)
    maskf = maskb.astype(jnp.float32)

    def div_op(uvw):
        return maskf * js.consistent_divergence(
            uvw[0] * maskf, uvw[1] * maskf, uvw[2] * maskf, maskb, *h,
            variant="operator")
    return div_op


@pytest.mark.parametrize("name", sorted(PROBLEMS) + ["faces"])
def test_masked_divergence_matches_jax(name):
    """``div_op`` is the JAX package's masked 'operator' divergence."""
    if name == "faces":
        fluid, h = fx.faces_mask(), (1.0, 0.8, 1.3)
        rng = np.random.default_rng(4)
        uvw = tuple(rng.normal(size=fluid.shape).astype(np.float32)
                    for _ in range(3))
    else:
        fluid, uvw, h = _problem(name)
    div_op, _ = divergence_operators(torch.as_tensor(fluid), *h)
    _close(div_op(_t(*uvw)),
           _jax_div_op(fluid, h)(tuple(jnp.asarray(a) for a in uvw)))


@pytest.mark.parametrize("name", sorted(PROBLEMS) + ["faces"])
def test_adjoint_identity_f64(name):
    """⟨D̃u, q⟩ = ⟨u, D̃ᵀq⟩ to 1e-12 in f64, on masks whose fluid touches
    all six faces: a ``D̃ᵀ`` without the domain-edge Neumann terms fails
    at the faces."""
    if name == "faces":
        fluid, h = fx.faces_mask(), (1.0, 0.8, 1.3)
    else:
        fluid, _, h = _problem(name)
    m = torch.as_tensor(fluid)
    div_op, div_op_T = divergence_operators(m, *h, dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        uvw = tuple(torch.randn(fluid.shape, generator=g, dtype=torch.float64)
                    for _ in range(3))
        q = torch.randn(fluid.shape, generator=g, dtype=torch.float64)
        lhs = float((div_op(uvw) * q).sum())
        rhs = float(sum((a * b).sum() for a, b in zip(uvw, div_op_T(q))))
        assert abs(lhs - rhs) <= 1e-12 * abs(lhs), (lhs, rhs)


@pytest.mark.parametrize("name", sorted(PROBLEMS) + ["faces"])
def test_div_op_T_matches_vjp_and_jax_transpose(name):
    """The stencil ``D̃ᵀ`` against ``torch.func.vjp`` of ``D̃`` (f64, to
    rounding) and against the JAX package's ``jax.linear_transpose`` of
    its divergence (f32, rtol/atol 1e-6)."""
    if name == "faces":
        fluid, h = fx.faces_mask(), (1.0, 0.8, 1.3)
    else:
        fluid, _, h = _problem(name)
    m = torch.as_tensor(fluid)
    rng = np.random.default_rng(9)
    q = rng.normal(size=fluid.shape).astype(np.float32)

    div_op, div_op_T = divergence_operators(m, *h, dtype=torch.float64)
    zeros = tuple(torch.zeros(fluid.shape, dtype=torch.float64)
                  for _ in range(3))
    _, pullback = torch.func.vjp(div_op, zeros)
    (via_vjp,) = pullback(torch.as_tensor(q, dtype=torch.float64))
    for a, b in zip(div_op_T(torch.as_tensor(q, dtype=torch.float64)),
                    via_vjp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)

    _, div_op_T32 = divergence_operators(m, *h)
    example = tuple(jnp.zeros(fluid.shape, jnp.float32) for _ in range(3))
    (want,) = jax.linear_transpose(_jax_div_op(fluid, h), example)(
        jnp.asarray(q))
    for a, b in zip(div_op_T32(torch.as_tensor(q)), want):
        _close(a, b)
