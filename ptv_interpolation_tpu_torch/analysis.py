"""Velocity-field analysis: strain rate, vorticity, dissipation, flow type,
permeability, and pressure recovery.

Counterpart of ``ptv_interpolation_tpu/analysis.py``, function for
function, as PyTorch ops (no kernel of its own: nothing here reaches a
``pallas_call`` in the JAX package either). Gradients are the
``np.gradient`` central differences of ``ops/stencils.py``; the pressure
solve is ``physics.solve_poisson`` with its multigrid-preconditioned CG.

Every entry point takes ``device=`` (default ``"cuda"``), moves numpy
inputs there once, and returns tensors on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.grid import binary_erosion6
from ptv_interpolation_tpu_torch.ops.stencils import (_axis_index, gradient,
                                                      shift)
from ptv_interpolation_tpu_torch.physics import solve_poisson


def _f32_sq(h):
    """``h·h`` rounded as the JAX package's traced f32 spacing gives it."""
    return float(np.float32(h) * np.float32(h))


def _as_mask(mask, dev):
    return None if mask is None else torch.as_tensor(mask, device=dev).bool()


def _maybe_mask(field, mask):
    if mask is None:
        return field
    return field * mask


def _velocity_gradients(u, v, w, dx, dy, dz, dev):
    """The nine gradients, each component's as (d/dz, d/dy, d/dx)."""
    return tuple(gradient(as_f32(f, dev), dx, dy, dz) for f in (u, v, w))


def _gamma(gu, gv, gw):
    du_dz, du_dy, du_dx = gu
    dv_dz, dv_dy, dv_dx = gv
    dw_dz, dw_dy, dw_dx = gw
    e_xx = 2 * du_dx
    e_yy = 2 * dv_dy
    e_zz = 2 * dw_dz
    e_xy = du_dy + dv_dx
    e_xz = du_dz + dw_dx
    e_yz = dv_dz + dw_dy
    return torch.sqrt(0.5 * (e_xx ** 2 + e_yy ** 2 + e_zz ** 2)
                      + e_xy ** 2 + e_xz ** 2 + e_yz ** 2)


def _vorticity_mag(gu, gv, gw):
    du_dz, du_dy, _ = gu
    dv_dz, _, dv_dx = gv
    _, dw_dy, dw_dx = gw
    vort_x = dw_dy - dv_dz
    vort_y = du_dz - dw_dx
    vort_z = dv_dx - du_dy
    return torch.sqrt(vort_x ** 2 + vort_y ** 2 + vort_z ** 2)


def compute_strain_rate(u, v, w, dx, dy, dz, mask=None, device="cuda"):
    """Shear-rate magnitude γ̇ = sqrt(0.5 Σ(2ε̇ᵢᵢ)² + Σ(2ε̇ᵢⱼ)²)
    (`velocity_analysis.py:10-63`)."""
    dev = resolve_device(device)
    grads = _velocity_gradients(u, v, w, dx, dy, dz, dev)
    return _maybe_mask(_gamma(*grads), _as_mask(mask, dev))


def compute_viscous_dissipation(strain_rate, viscosity, dx=1.0, dy=1.0,
                                dz=1.0, mask=None, device="cuda"):
    """Φ = μ γ̇² (Pilotti 2002; `velocity_analysis.py:65-92`)."""
    dev = resolve_device(device)
    return _maybe_mask(viscosity * as_f32(strain_rate, dev) ** 2,
                       _as_mask(mask, dev))


def compute_derivative_fields(u, v, w, dx, dy, dz, viscosity, mask=None,
                              want_strain: bool = True,
                              want_diss: bool = True,
                              want_vort: bool = True,
                              want_xi: bool = False, device="cuda"):
    """All first-derivative analysis fields from one set of gradients:
    strain rate, viscous dissipation, vorticity magnitude and the
    Astarita flow type, with the op order and masking of the single-field
    functions (so the results equal theirs).

    Returns a dict with the requested keys among
    ``{"strain_rate", "dissipation", "vorticity", "xi"}``.
    """
    dev = resolve_device(device)
    mask = _as_mask(mask, dev)
    grads = _velocity_gradients(u, v, w, dx, dy, dz, dev)

    out = {}
    gamma = None
    if want_strain or want_diss or want_xi:
        gamma = _maybe_mask(_gamma(*grads), mask)
        if want_strain:
            out["strain_rate"] = gamma
    if want_diss:
        out["dissipation"] = _maybe_mask(viscosity * gamma ** 2, mask)
    vort = None
    if want_vort or want_xi:
        vort = _maybe_mask(_vorticity_mag(*grads), mask)
        if want_vort:
            out["vorticity"] = vort
    if want_xi:
        out["xi"] = compute_astarita_flow_type(gamma, vort, mask, device=dev)
    return out


def compute_vorticity(u, v, w, dx, dy, dz, mask=None, device="cuda"):
    """|∇×u| (`velocity_analysis.py:94-120`)."""
    dev = resolve_device(device)
    grads = _velocity_gradients(u, v, w, dx, dy, dz, dev)
    return _maybe_mask(_vorticity_mag(*grads), _as_mask(mask, dev))


def compute_permeability(u, v, w, dissipation, viscosity, dx, dy, dz,
                         mask=None, device="cuda"):
    """Energy-dissipation permeability k = μ U₀² / ⟨Φ⟩ with Darcy velocity
    and mean dissipation over the **total** volume — solid included, the
    reference's deliberate Pilotti convention (`velocity_analysis.py:122-149`,
    SURVEY §7 quirk (d)). ``mask`` is accepted and unused, as in the JAX
    package. Returns a 0-d tensor."""
    dev = resolve_device(device)
    u, v, w, phi = (as_f32(a, dev) for a in (u, v, w, dissipation))
    u0 = torch.sqrt(u.mean() ** 2 + v.mean() ** 2 + w.mean() ** 2)
    mean_phi = phi.mean()
    return torch.where(mean_phi == 0, 0.0,
                       viscosity * u0 ** 2 / mean_phi)


def compute_astarita_flow_type(strain_rate, vorticity_mag, mask=None,
                               device="cuda"):
    """ξ = (γ̇ − |ω|)/(γ̇ + |ω|) ∈ [−1, 1] (`velocity_analysis.py:151-188`)."""
    dev = resolve_device(device)
    sr, vm = as_f32(strain_rate, dev), as_f32(vorticity_mag, dev)
    num = sr - vm
    den = sr + vm
    ok = den > 1e-15
    xi = torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)
    return _maybe_mask(xi, _as_mask(mask, dev))


def laplacian_mask_aware(f, dx, dy, dz, mask=None, fill_sweeps: int = 2,
                         device="cuda"):
    """Mask-protected Laplacian (`velocity_analysis.py:210-269`):

    1. 7-point Laplacian with edge-clamped neighbors.
    2. 'Bulk' = fluid eroded by 1; boundary fluid nodes get their Laplacian
       back-filled from adjacent bulk values by ``fill_sweeps`` dilation
       sweeps (avoids one-sided spikes at no-slip walls).
    """
    dev = resolve_device(device)
    f = as_f32(f, dev)
    lap = torch.zeros_like(f)
    for axis, h in ((0, dz), (1, dy), (2, dx)):
        f_next = shift(f, +1, axis, 0.0)
        f_prev = shift(f, -1, axis, 0.0)
        idx = _axis_index(f, axis - 3)
        n = f.shape[axis]
        f_next = torch.where(idx == n - 1, f, f_next)   # clamp at edges
        f_prev = torch.where(idx == 0, f, f_prev)
        lap = lap + (f_next - 2 * f + f_prev) / _f32_sq(h)

    if mask is None:
        return lap

    mask = _as_mask(mask, dev)
    bulk = binary_erosion6(mask, 1, device=dev)
    boundary = mask & ~bulk
    for _ in range(fill_sweeps):
        to_fill = boundary & ~bulk
        sum_val = torch.zeros_like(lap)
        count = torch.zeros_like(lap)
        for axis in (0, 1, 2):
            for s in (-1, 1):
                valid = to_fill & shift(bulk, s, axis, False)
                sum_val = sum_val + torch.where(
                    valid, shift(lap, s, axis, 0.0), 0.0)
                count = count + valid.float()
        upd = to_fill & (count > 0)
        lap = torch.where(upd, sum_val / torch.clamp_min(count, 1.0), lap)
        bulk = bulk | upd
    return lap


def compute_pressure_field(u, v, w, dx, dy, dz, mu, rho=0.0, mask=None,
                           wall_bc: str = "zero-neumann",
                           anchor: str = "outlet",
                           flow_direction: str = "auto",
                           tol: float = 1e-8, maxiter: int = 3000,
                           verbose: bool = True, device="cuda"):
    """Pressure recovery via the pressure Poisson equation
    (`velocity_analysis.py:190-330`): RHS force f = μ∇²u − ρ(u·∇)u with a
    mask-aware Laplacian; Dirichlet anchor plane at the inlet/outlet Z-face.
    Returns the pressure as a tensor on ``device``.
    """
    dev = resolve_device(device)
    u, v, w = (as_f32(a, dev) for a in (u, v, w))
    if mask is None:
        mask_b = torch.ones(u.shape, dtype=torch.bool, device=dev)
    else:
        mask_b = _as_mask(mask, dev)

    if verbose:
        print(f"Computing pressure field source term (mu={mu}, rho={rho}, "
              f"wall_bc={wall_bc}, flow={flow_direction})...")

    fx, fy, fz = (mu * laplacian_mask_aware(a, dx, dy, dz, mask_b,
                                            device=dev) for a in (u, v, w))

    if rho > 0:
        gu, gv, gw = _velocity_gradients(u, v, w, dx, dy, dz, dev)
        # gradient returns (d/dz, d/dy, d/dx)
        fx = fx - rho * (u * gu[2] + v * gu[1] + w * gu[0])
        fy = fy - rho * (u * gv[2] + v * gv[1] + w * gv[0])
        fz = fz - rho * (u * gw[2] + v * gw[1] + w * gw[0])

    # flow direction → inlet/outlet plane selection
    # (`velocity_analysis.py:304-314`)
    w_mean = float((w * mask_b).sum() / torch.clamp_min(mask_b.sum(), 1))
    if flow_direction == "positive":
        plane_inlet, plane_outlet = 0, -1
    elif flow_direction == "negative":
        plane_inlet, plane_outlet = -1, 0
    else:
        plane_inlet, plane_outlet = (0, -1) if w_mean >= 0 else (-1, 0)

    dirichlet_mask = None
    if anchor != "none":
        dirichlet_mask = torch.zeros(u.shape, dtype=torch.bool, device=dev)
        plane = plane_outlet if anchor == "outlet" else plane_inlet
        dirichlet_mask[plane] = True
        dirichlet_mask &= mask_b

    if verbose:
        print(f"Solving pressure Poisson equation (anchor={anchor} at "
              f"Z-plane, dir={flow_direction})...")
    return solve_poisson(None, mask_b, dx, dy, dz, force_field=(fx, fy, fz),
                         wall_bc=wall_bc, dirichlet_mask=dirichlet_mask,
                         dirichlet_values=0.0, tol=tol, maxiter=maxiter,
                         device=dev)


def compute_permeability_from_pressure(u, v, w, pressure, viscosity,
                                       dx, dy, dz, device="cuda"):
    """Darcy permeability k = −μ (U₀·∇P)/|∇P|² with bulk means
    (`velocity_analysis.py:659-697`). Returns a 0-d tensor."""
    dev = resolve_device(device)
    u, v, w, p = (as_f32(a, dev) for a in (u, v, w, pressure))
    u0 = torch.stack([u.mean(), v.mean(), w.mean()])
    dp_dz, dp_dy, dp_dx = gradient(p, dx, dy, dz)
    g = torch.stack([dp_dx.mean(), dp_dy.mean(), dp_dz.mean()])
    g2 = torch.sum(g * g)
    return torch.where(g2 == 0, 0.0, -viscosity * torch.dot(u0, g) / g2)
