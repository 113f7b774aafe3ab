"""The port's ``analysis.py`` against the JAX package's on the same numpy
fields, run on the CPU, and against the analytic validations of
``tests/test_analysis.py`` under the same bars.

Tolerances: derivative fields rtol 1e-5 / atol 1e-6 of the field's max;
pressure relative L2 ≤ 1e-5 (the bar of the cleaning tests); CG
iteration counts within ±2 at tol 1e-6, which the f32 residual reaches
cleanly; permeabilities rtol 1e-5 against an f64 numpy evaluation of the
same formula on the same f32 inputs, and against JAX within 1e-5 plus
JAX's own distance from that f64 value (XLA sums an f32 mean on the CPU
in one sequential pass, which at 24³ is off by up to ~1e-4; torch's
pairwise sum is not).
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu import analysis as ja
from ptv_interpolation_tpu import physics as jphys
from ptv_interpolation_tpu_torch import analysis as ta
from ptv_interpolation_tpu_torch import physics as tphys
from test_analysis import _grid, _to_lib

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
P_L2 = 1e-5
SPACING = (0.7, 0.9, 1.1)            # dx, dy, dz
MU = 1e-3


@functools.lru_cache(maxsize=None)
def _fields(sign=1.0):
    """A smooth field with noise on a (24, 26, 28) grid around an
    ellipsoidal solid; mean w = sign · ~1, far from 0, so 'auto' picks
    the same anchor plane in both packages."""
    shape = (24, 26, 28)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in shape),
                          indexing="ij")
    fluid = ((x - 14) / 7) ** 2 + ((y - 12) / 6) ** 2 + ((z - 11) / 5) ** 2 > 1
    rng = np.random.default_rng(5)
    u = 0.2 * np.sin(0.3 * x + 0.1 * z) + 0.02 * rng.normal(size=shape)
    v = 0.1 * np.cos(0.25 * y) + 0.02 * rng.normal(size=shape)
    w = sign * (1.0 + 0.3 * np.sin(0.2 * z) * np.cos(0.15 * x)
                + 0.02 * rng.normal(size=shape))
    u, v, w = (np.asarray(a * fluid, np.float32) for a in (u, v, w))
    return u, v, w, fluid


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


MASKS = pytest.mark.parametrize("masked", (False, True),
                                ids=("nomask", "mask"))


@MASKS
def test_strain_vorticity_dissipation_flow_type_match_jax(masked):
    u, v, w, fluid = _fields()
    m = fluid if masked else None
    sr = ta.compute_strain_rate(u, v, w, *SPACING, m, device="cpu")
    _close(sr, ja.compute_strain_rate(u, v, w, *SPACING, m))
    vm = ta.compute_vorticity(u, v, w, *SPACING, m, device="cpu")
    _close(vm, ja.compute_vorticity(u, v, w, *SPACING, m))
    srn, vmn = sr.numpy(), vm.numpy()
    _close(ta.compute_viscous_dissipation(srn, MU, *SPACING, mask=m,
                                          device="cpu"),
           ja.compute_viscous_dissipation(srn, MU, *SPACING, mask=m))
    _close(ta.compute_astarita_flow_type(srn, vmn, m, device="cpu"),
           ja.compute_astarita_flow_type(srn, vmn, m))
    if masked:
        assert not sr.numpy()[~fluid].any() and not vm.numpy()[~fluid].any()


WANTS = list(itertools.product((False, True), repeat=4))


@MASKS
@pytest.mark.parametrize("want", WANTS,
                         ids=["".join("sdvx"[i] if f else "-"
                                      for i, f in enumerate(w))
                              for w in WANTS])
def test_derivative_fields_match_jax(want, masked):
    u, v, w, fluid = _fields()
    m = fluid if masked else None
    kw = dict(zip(("want_strain", "want_diss", "want_vort", "want_xi"), want))
    got = ta.compute_derivative_fields(u, v, w, *SPACING, MU, m,
                                       device="cpu", **kw)
    ref = ja.compute_derivative_fields(u, v, w, *SPACING, MU, m, **kw)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])


def test_derivative_fields_equal_single_field_functions():
    """As in the JAX package, the fused form equals the single-field
    functions bit for bit (same op order, same masking)."""
    u, v, w, fluid = _fields()
    f = ta.compute_derivative_fields(u, v, w, *SPACING, MU, fluid,
                                     want_xi=True, device="cpu")
    sr = ta.compute_strain_rate(u, v, w, *SPACING, fluid, device="cpu")
    vm = ta.compute_vorticity(u, v, w, *SPACING, fluid, device="cpu")
    assert torch.equal(f["strain_rate"], sr)
    assert torch.equal(f["vorticity"], vm)
    assert torch.equal(f["dissipation"], ta.compute_viscous_dissipation(
        sr, MU, mask=fluid, device="cpu"))
    assert torch.equal(f["xi"], ta.compute_astarita_flow_type(
        sr, vm, fluid, device="cpu"))


@MASKS
@pytest.mark.parametrize("fill_sweeps", (0, 1, 2))
def test_laplacian_mask_aware_matches_jax(fill_sweeps, masked):
    u, v, w, fluid = _fields()
    m = fluid if masked else None
    for f in (u, w):
        _close(ta.laplacian_mask_aware(f, *SPACING, m,
                                       fill_sweeps=fill_sweeps, device="cpu"),
               ja.laplacian_mask_aware(f, *SPACING, m,
                                       fill_sweeps=fill_sweeps))


PRESSURE_CASES = (
    [dict(wall_bc=bc, anchor=a) for bc in ("zero-neumann", "inhomogeneous")
     for a in ("inlet", "outlet", "none")]
    + [dict(flow_direction=d, anchor=a) for d in ("positive", "negative")
       for a in ("inlet", "outlet")]
    + [dict(sign=-1.0), dict(sign=-1.0, anchor="inlet"),
       dict(rho=1000.0), dict(rho=1000.0, sign=-1.0,
                              wall_bc="inhomogeneous")])


def _pressure_id(case):
    return "-".join(f"{k}={v}" for k, v in case.items())


@pytest.mark.parametrize("case", PRESSURE_CASES, ids=_pressure_id)
def test_pressure_field_matches_jax(case):
    case = dict(case)
    u, v, w, fluid = _fields(case.pop("sign", 1.0))
    rho = case.pop("rho", 0.0)
    want = np.asarray(ja.compute_pressure_field(
        u, v, w, *SPACING, MU, rho, fluid, verbose=False, **case))
    got = ta.compute_pressure_field(u, v, w, *SPACING, MU, rho, fluid,
                                    verbose=False, device="cpu", **case)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_l2(got.numpy(), want) <= P_L2
    assert not got.numpy()[~fluid].any()


def _capture_solves(monkeypatch, module):
    seen = []
    impl = module._solve_poisson_impl

    def grab(*a, **kw):
        out = impl(*a, **kw)
        seen.append((int(out[1]), bool(out[2])))
        return out

    monkeypatch.setattr(module, "_solve_poisson_impl", grab)
    return seen


@pytest.mark.parametrize("anchor", ("outlet", "none"))
def test_pressure_cg_iterations_match_jax(monkeypatch, anchor):
    """MG-PCG iteration counts within ±2 of the JAX package's at tol 1e-6,
    above the f32 floor; both converge."""
    u, v, w, fluid = _fields()
    want = _capture_solves(monkeypatch, jphys)
    got = _capture_solves(monkeypatch, tphys)
    kw = dict(anchor=anchor, tol=1e-6, verbose=False)
    ja.compute_pressure_field(u, v, w, *SPACING, MU, 0.0, fluid, **kw)
    ta.compute_pressure_field(u, v, w, *SPACING, MU, 0.0, fluid,
                              device="cpu", **kw)
    (it_j, conv_j), (it_t, conv_t) = want[0], got[0]
    assert conv_j and conv_t and it_t > 0
    assert abs(it_t - it_j) <= 2, (it_t, it_j)


def test_pressure_prints_the_jax_lines(capsys):
    u, v, w, fluid = _fields()
    ja.compute_pressure_field(u, v, w, *SPACING, MU, 0.0, fluid)
    want = capsys.readouterr().out
    ta.compute_pressure_field(u, v, w, *SPACING, MU, 0.0, fluid,
                              device="cpu")
    assert capsys.readouterr().out == want


def _f64_k_diss(u, v, w, phi):
    u0sq = sum(a.astype(np.float64).mean() ** 2 for a in (u, v, w))
    return MU * u0sq / phi.astype(np.float64).mean()


def _f64_k_press(u, v, w, p, spacing):
    dx, dy, dz = spacing
    u0 = np.asarray([a.astype(np.float64).mean() for a in (u, v, w)])
    dpz, dpy, dpx = np.gradient(p.astype(np.float64), dz, dy, dx)
    g = np.asarray([dpx.mean(), dpy.mean(), dpz.mean()])
    return -MU * u0 @ g / (g @ g)


def _check_scalar(got, jax_value, f64):
    got, jax_value = float(got), float(jax_value)
    assert abs(got - f64) <= RTOL * abs(f64)
    assert abs(got - jax_value) <= RTOL * abs(f64) + abs(jax_value - f64)


@MASKS
def test_permeabilities_match_jax_and_f64(masked):
    u, v, w, fluid = _fields()
    m = fluid if masked else None
    phi = ja.compute_derivative_fields(u, v, w, *SPACING, MU, m,
                                       want_vort=False)["dissipation"]
    phi = np.asarray(phi)
    _check_scalar(ta.compute_permeability(u, v, w, phi, MU, *SPACING, m,
                                          device="cpu"),
                  ja.compute_permeability(u, v, w, phi, MU, *SPACING, m),
                  _f64_k_diss(u, v, w, phi))
    p = np.asarray(ja.compute_pressure_field(u, v, w, *SPACING, MU, 0.0,
                                             fluid, verbose=False))
    _check_scalar(ta.compute_permeability_from_pressure(
                      u, v, w, p, MU, *SPACING, device="cpu"),
                  ja.compute_permeability_from_pressure(u, v, w, p, MU,
                                                        *SPACING),
                  _f64_k_press(u, v, w, p, SPACING))


def test_permeabilities_are_zero_without_signal():
    z = np.zeros((8, 8, 8), np.float32)
    assert float(ta.compute_permeability(z, z, z, z, MU, 1, 1, 1,
                                         device="cpu")) == 0.0
    assert float(ta.compute_permeability_from_pressure(
        z, z, z, z, MU, 1, 1, 1, device="cpu")) == 0.0


# --- the analytic validations of tests/test_analysis.py, on the port ------

def _sr_vm_xi(u, v, w, d):
    sr = ta.compute_strain_rate(u, v, w, d, d, d, device="cpu")
    vm = ta.compute_vorticity(u, v, w, d, d, d, device="cpu")
    xi = ta.compute_astarita_flow_type(sr, vm, device="cpu")
    return sr.numpy(), vm.numpy(), xi.numpy()


def test_simple_shear_couette():
    """u = γ̇ y: strain = vorticity = γ̇, ξ = 0."""
    gamma = 5.0
    X, Y, Z, d = _grid()
    u = _to_lib(gamma * Y)
    v = w = np.zeros_like(u)
    sr, vm, xi = _sr_vm_xi(u, v, w, d)
    assert np.allclose(sr[16, 16, 16], gamma, rtol=1e-2)
    assert np.allclose(vm[16, 16, 16], gamma, rtol=1e-2)
    assert np.allclose(xi[16, 16, 16], 0.0, atol=1e-2)


def test_pure_extension():
    """u = Ex, v = −Ey: strain = 2E, vorticity = 0, ξ = 1."""
    E = 2.0
    X, Y, Z, d = _grid()
    sr, vm, xi = _sr_vm_xi(_to_lib(E * X), _to_lib(-E * Y),
                           np.zeros_like(X), d)
    assert np.allclose(sr[16, 16, 16], 2 * E, rtol=1e-2)
    assert np.allclose(vm[16, 16, 16], 0.0, atol=1e-2)
    assert np.allclose(xi[16, 16, 16], 1.0, atol=1e-2)


def test_solid_body_rotation():
    """u = −Ω(y−y₀), v = Ω(x−x₀): strain = 0, vorticity = 2Ω, ξ = −1."""
    Omega, L = 3.0, 1.0
    X, Y, Z, d = _grid()
    sr, vm, xi = _sr_vm_xi(_to_lib(-Omega * (Y - L / 2)),
                           _to_lib(Omega * (X - L / 2)), np.zeros_like(X), d)
    assert np.allclose(sr[16, 16, 16], 0.0, atol=1e-2)
    assert np.allclose(vm[16, 16, 16], 2 * Omega, rtol=1e-2)
    assert np.allclose(xi[16, 16, 16], -1.0, atol=1e-2)


def test_permeability_energy_balance():
    """Pilotti energy balance k = μ U₀²/⟨Φ⟩ on a Darcy + shear field."""
    N, L = 32, 1e-3
    U0, mu, gamma = 1e-4, 1e-3, 1.0
    x = np.linspace(0, L, N)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    d = x[1] - x[0]
    u = _to_lib(U0 + gamma * Y)
    v = w = np.zeros_like(u)
    sr = ta.compute_strain_rate(u, v, w, d, d, d, device="cpu")
    phi = ta.compute_viscous_dissipation(sr, mu, d, d, d, device="cpu")
    k = float(ta.compute_permeability(u, v, w, phi, mu, d, d, d,
                                      device="cpu"))
    U_darcy = U0 + gamma * L / 2
    assert np.allclose(k, mu * U_darcy ** 2 / (mu * gamma ** 2), rtol=1e-2)


@pytest.fixture(scope="module")
def poiseuille_pipe():
    """3D Poiseuille pipe along Z (as ``tests/test_analysis.py``)."""
    d, mu = 20e-6, 1e-3
    coords = np.arange(40) * d
    z, y, x = np.meshgrid(coords, coords, coords, indexing="ij")
    c = coords.mean()
    radius = 15 * d
    r2 = (y - c) ** 2 + (x - c) ** 2
    mask = r2 < radius ** 2
    U_max = 1e-3
    w = U_max * (1 - r2 / radius ** 2)
    w[~mask] = 0.0
    return dict(z=z, r2=r2, mask=mask, w=w, d=d, mu=mu, radius=radius,
                U_max=U_max)


def test_pressure_recovery_poiseuille(poiseuille_pipe):
    """Recovered ∇P vs analytical −4μU/R² within 10%."""
    pp = poiseuille_pipe
    d, mu = pp["d"], pp["mu"]
    zeros = np.zeros_like(pp["w"])
    p = ta.compute_pressure_field(
        zeros, zeros, pp["w"], d, d, d, mu, mask=pp["mask"],
        wall_bc="inhomogeneous", verbose=False, tol=1e-10,
        device="cpu").numpy()
    expected = -4 * mu * pp["U_max"] / pp["radius"] ** 2
    dp_dz = np.gradient(p, d, axis=0)
    core = ((pp["r2"] < (0.5 * pp["radius"]) ** 2) & (pp["z"] > 5 * d)
            & (pp["z"] < 35 * d))
    err = abs((dp_dz[core].mean() - expected) / expected)
    assert err < 0.10, f"pressure gradient error {err:.2%}"


def test_darcy_permeability_consistency(poiseuille_pipe):
    """k from the pressure gradient has the right scale on the pipe flow."""
    pp = poiseuille_pipe
    d, mu = pp["d"], pp["mu"]
    zeros = np.zeros_like(pp["w"])
    grad_p = -4 * mu * pp["U_max"] / pp["radius"] ** 2
    k = float(ta.compute_permeability_from_pressure(
        zeros, zeros, pp["w"], grad_p * pp["z"], mu, d, d, d, device="cpu"))
    assert np.allclose(k, -mu * pp["w"].mean() / grad_p, rtol=1e-2)
