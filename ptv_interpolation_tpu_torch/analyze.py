"""Unified flow-analysis pipeline (the `analyze_flow.py` equivalent).

Counterpart of ``ptv_interpolation_tpu/analyze.py``: loads a velocity-field
NPZ, enforces mask zeros, applies physical scaling (voxel size / frame
time), reports flow statistics and per-slice fluxes, then runs the selected
analyses (strain rate, dissipation, vorticity, pressure recovery, two
permeabilities, interface drag, Astarita flow type) on ``device``, writing
NPZ/TIFF artifacts and a stats text log with the JAX package's keys, names
and lines. Statistics are host f64, as there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

import torch

from ptv_interpolation_tpu_torch.analysis import (
    compute_derivative_fields,
    compute_permeability,
    compute_permeability_from_pressure,
    compute_pressure_field,
)
from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.drag import compute_interface_drag
from ptv_interpolation_tpu_torch.io import load_velocity_field
from ptv_interpolation_tpu_torch.io.tiff import read_tiff, write_tiff


@dataclasses.dataclass
class AnalyzeConfig:
    """Typed mirror of the reference analysis CLI (`analyze_flow.py:183-241`)."""

    input: str = "velocity_field.npz"
    basename: Optional[str] = None            # output prefix; default from input
    strain_rate: bool = True
    dissipation: bool = True
    vorticity: bool = True
    permeability_dissipation: bool = True
    permeability_pressure: bool = True
    pressure: bool = True
    pressure_wall_bc: str = "zero-neumann"
    pressure_anchor: str = "outlet"
    viscosity: float = 0.001
    rho: float = 0.0
    flow_direction: str = "auto"
    drag: bool = True
    drag_labels: Optional[Sequence[int]] = None
    drag_method: str = "mesh"
    drag_mesh_step: int = 1
    pore_mask: Optional[str] = None
    voxel_size: float = 1.0
    dt: float = 1.0
    flow_type: bool = False                   # --plot-flowtype side effect
    output_npz: Optional[str] = None
    save_tiffs: bool = True
    # per-field TIFF redirects (`analyze_flow.py:210-213`);
    # None → "<basename>_<field>.tif"
    output_tif_strain: Optional[str] = None
    output_tif_dissipation: Optional[str] = None
    output_tif_vorticity: Optional[str] = None
    output_tif_pressure: Optional[str] = None
    save_stats: bool = True
    verbose: bool = True


def run_analysis(config: AnalyzeConfig, field=None, timings=None,
                 device="cuda"):
    """Run the analysis pipeline on ``device``; returns (results dict,
    stats-log lines) with host numpy fields and Python floats.

    ``timings``: optional :class:`ptv_interpolation_tpu_torch.utils.StageTimings`
    collecting per-stage wall-clock (used by the profiling harness). The
    stages that dispatch device work (``derivatives``, ``drag``) do not
    wait for it; it completes inside a later stage that reads results."""
    from ptv_interpolation_tpu_torch.utils import StageTimings
    dev = resolve_device(device)
    if timings is None:
        timings = StageTimings()
    stats_log: list[str] = []

    def log(msg: str):
        if config.verbose:
            print(msg)
        stats_log.append(msg)

    basename = config.basename
    if basename is None:
        basename = os.path.splitext(os.path.basename(config.input))[0]

    log(f"Loading velocity field from {config.input}...")
    if field is None:
        field = load_velocity_field(config.input)
    u = np.asarray(field.u, np.float64).copy()
    v = np.asarray(field.v, np.float64).copy()
    w = np.asarray(field.w, np.float64).copy()
    x = np.asarray(field.x, np.float64).copy()
    y = np.asarray(field.y, np.float64).copy()
    z = np.asarray(field.z, np.float64).copy()
    mask = None if field.mask is None else np.asarray(field.mask, bool)

    if mask is not None:
        log("Enforcing zero velocity in solid regions of the mask...")
        u[~mask] = 0.0
        v[~mask] = 0.0
        w[~mask] = 0.0
        log(f"  Calculated porosity: {mask.mean():.4e}")

    speed_raw = np.sqrt(u ** 2 + v ** 2 + w ** 2)
    valid_raw = speed_raw[mask] if mask is not None else speed_raw
    log("\n--- Flow Field Statistics (Raw Scan Units) ---")
    log("  Velocity Magnitude (voxel/frame):")
    log(f"    Mean: {valid_raw.mean():.4e}")
    log(f"    Max:  {valid_raw.max():.4e}")
    log(f"    Std:  {valid_raw.std():.4e}")

    if config.voxel_size != 1.0 or config.dt != 1.0:
        log(f"Applying physical scaling: voxel_size={config.voxel_size}, dt={config.dt}...")
        scale_v = config.voxel_size / config.dt
        u *= scale_v
        v *= scale_v
        w *= scale_v
        x *= config.voxel_size
        y *= config.voxel_size
        z *= config.voxel_size

    dx = x[1] - x[0] if len(x) > 1 else config.voxel_size
    dy = y[1] - y[0] if len(y) > 1 else config.voxel_size
    dz = z[1] - z[0] if len(z) > 1 else config.voxel_size

    # Push the (scaled) fields to the device once (f32) and feed every
    # compute stage the same tensors. Host f64 copies are kept for the
    # printed stats (reference parity) and the TIFF/NPZ outputs.
    uj, vj, wj = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (u, v, w))
    mj = None if mask is None else torch.as_tensor(mask, device=dev)

    scaled = config.voxel_size != 1.0 or config.dt != 1.0
    speed = np.sqrt(u ** 2 + v ** 2 + w ** 2) if scaled else speed_raw
    valid = speed[mask] if mask is not None else speed
    log("\n--- Flow Field Statistics (Physical SI Units) ---")
    log("  Velocity Magnitude (um/s):")
    log(f"    Mean: {valid.mean() * 1e6:.4e}")
    log(f"    Max:  {valid.max() * 1e6:.4e}")
    log(f"    Std:  {valid.std() * 1e6:.4e}")

    # per-slice flux & Darcy flux (`analyze_flow.py:307-323`)
    dA = dx * dy
    Q_z = w.sum(axis=(1, 2)) * dA
    nz, ny, nx = w.shape
    q_z = Q_z / (nx * ny * dA)
    log("\n--- Z-Axis Flow Rates & Fluxes (SI Units) ---")
    log("  Volumetric Flow Rate (Q):")
    log(f"    Average: {Q_z.mean():.4e} m³/s ({Q_z.mean() * 6e10:.4e} uL/min)")
    log(f"    Range:   [{Q_z.min():.4e}, {Q_z.max():.4e}] m³/s")
    log("  Darcy Flux (q = Q/A_total):")
    log(f"    Average: {q_z.mean():.4e} m/s")
    log(f"    Range:   [{q_z.min():.4e}, {q_z.max():.4e}] m/s")

    results = {}

    # Every first-derivative field (strain, dissipation, vorticity) from
    # one set of the nine gradients. Dissipation (μγ̇²) and ξ
    # ((γ̇−|ω|)/(γ̇+|ω|)) are derived on the HOST from the pulled
    # strain/vorticity — f32 elementwise math, as the JAX package does —
    # so only two fields cross the device→host boundary instead of four.
    want_strain = config.strain_rate or config.dissipation
    want_xi = config.flow_type and want_strain
    deriv_dev = {}
    deriv = {}
    if want_strain or config.vorticity or want_xi:
        with timings.stage("derivatives"):
            deriv_dev = compute_derivative_fields(
                uj, vj, wj, dx, dy, dz, config.viscosity, mj,
                want_strain=want_strain,
                # device dissipation only feeds the k_diss reduction
                want_diss=config.permeability_dissipation and config.dissipation,
                want_vort=config.vorticity or want_xi, want_xi=False,
                device=dev)

    # The solver stages run before the bulk field pulls, as in the JAX
    # package: their small data-dependent scalar reads (flow-direction
    # mean, CG residuals, triangle counts) do not wait behind the field
    # copies. Log lines for each section are appended in the reference
    # order below, so the stats file is unchanged.
    pressure_dev = None
    if config.pressure:
        with timings.stage("pressure"):
            pressure_dev = compute_pressure_field(
                uj, vj, wj, dx, dy, dz, config.viscosity, config.rho, mj,
                wall_bc=config.pressure_wall_bc, anchor=config.pressure_anchor,
                flow_direction=config.flow_direction, verbose=config.verbose,
                device=dev)

    drag_finish = None
    drag_results = None
    background_mask = None
    if config.drag:
        # DELIBERATE reference-parity quirk (`analyze_flow.py:426`): the
        # pipeline labels the FLUID phase (mask=True → label 1) even though
        # the drag integrators document 0=fluid. Mesh drag then integrates
        # the force ON the fluid (resistive, physically meaningful), while
        # staircase viscous terms read hard-zeroed solid-side velocities.
        # Pass --drag-labels with a solid-labeled mask volume to integrate
        # grain forces instead, exactly as the reference's validation does.
        drag_mask = mask.astype(int) if mask is not None \
            else np.zeros_like(u, dtype=int)
        total_volume = nz * dz * ny * dy * nx * dx
        if config.pore_mask and os.path.exists(config.pore_mask):
            log(f"Loading background pore mask from {config.pore_mask}...")
            background_mask = read_tiff(config.pore_mask)
            if background_mask.shape != u.shape:
                log(f"  Warning: Pore mask shape {background_mask.shape} does "
                    f"not match velocity field {u.shape}. Skipping classification.")
                background_mask = None
            else:
                background_mask = background_mask > 0
        with timings.stage("drag"):
            drag_finish = compute_interface_drag(
                uj, vj, wj, pressure_dev, config.viscosity, dx, dy, dz,
                drag_mask, labels=config.drag_labels,
                method=config.drag_method, mesh_step=config.drag_mesh_step,
                volume=total_volume, background_mask=background_mask,
                defer=True, device=dev)

    # Everything is dispatched; pull the field results home.
    with timings.stage("collect"):
        deriv = {nm: deriv_dev[nm].cpu().numpy()
                 for nm in ("strain_rate", "vorticity") if nm in deriv_dev}
        if want_xi:
            sr32, vm32 = deriv["strain_rate"], deriv["vorticity"]
            num = sr32 - vm32
            den = sr32 + vm32
            safe = np.where(den > np.float32(1e-15), den, np.float32(1.0))
            deriv["xi"] = np.where(den > np.float32(1e-15), num / safe,
                                   np.float32(0.0))
        if config.dissipation:
            deriv["dissipation"] = (np.float32(config.viscosity)
                                    * deriv["strain_rate"] ** 2)

    strain_rate = deriv.get("strain_rate") if deriv_dev else None
    if strain_rate is not None:
        log("\n=== Computing Strain Rate ===")
        results["strain_rate"] = strain_rate
        log(f"  Mean: {(strain_rate[mask] if mask is not None else strain_rate).mean():.4e} 1/s")
        log(f"  Max:  {strain_rate.max():.4e} 1/s")
        if config.save_tiffs:
            with timings.stage("tiff_io"):
                write_tiff(config.output_tif_strain or f"{basename}_strain.tif",
                           strain_rate.astype(np.float32))

    dissipation = None
    if config.dissipation:
        log("\n=== Computing Viscous Dissipation ===")
        dissipation = deriv["dissipation"]
        results["dissipation"] = dissipation
        results["viscosity"] = config.viscosity
        vd = dissipation[mask] if mask is not None else dissipation
        log(f"  Mean: {vd.mean():.6e} W/m³")
        log(f"  Total dissipation: {vd.sum() * dx * dy * dz:.6e} W")
        if config.save_tiffs:
            with timings.stage("tiff_io"):
                write_tiff(config.output_tif_dissipation
                           or f"{basename}_dissipation.tif",
                           dissipation.astype(np.float32))

    vorticity_magnitude = None
    if config.vorticity:
        log("\n=== Computing Vorticity ===")
        vorticity_magnitude = deriv["vorticity"]
        results["vorticity_magnitude"] = vorticity_magnitude
        log(f"  Mean: {(vorticity_magnitude[mask] if mask is not None else vorticity_magnitude).mean():.4e} 1/s")
        if config.save_tiffs:
            with timings.stage("tiff_io"):
                write_tiff(config.output_tif_vorticity
                           or f"{basename}_vorticity.tif",
                           vorticity_magnitude.astype(np.float32))

    pressure = None
    if config.pressure:
        log("\n=== Recovering Pressure Field ===")
        with timings.stage("collect"):
            pressure = pressure_dev.cpu().numpy()
        results["pressure"] = pressure
        vp = pressure[mask] if mask is not None else pressure
        log(f"  Pressure Range: [{vp.min():.4e}, {vp.max():.4e}] Pa")

        log("\n--- Global Pressure Drops ---")
        for name, m_s, m_e, p_s, p_e in [
            ("Z (axial)", mask[0], mask[-1], pressure[0], pressure[-1]),
            ("Y (trans)", mask[:, 0], mask[:, -1], pressure[:, 0], pressure[:, -1]),
            ("X (trans)", mask[:, :, 0], mask[:, :, -1], pressure[:, :, 0], pressure[:, :, -1]),
        ] if mask is not None else []:
            if m_s.any() and m_e.any():
                dp = p_s[m_s].mean() - p_e[m_e].mean()
                log(f"  ΔP_{name}: {dp: .4e} Pa")
            else:
                log(f"  ΔP_{name}: N/A (Solid boundary)")
        if config.save_tiffs:
            with timings.stage("tiff_io"):
                write_tiff(config.output_tif_pressure
                           or f"{basename}_pressure.tif",
                           pressure.astype(np.float32))

    if config.permeability_dissipation or config.permeability_pressure:
        log("\n=== Estimating Permeability ===")
        k_diss = None
        if config.permeability_dissipation and dissipation is not None:
            k_diss = float(compute_permeability(
                uj, vj, wj, deriv_dev["dissipation"], config.viscosity,
                dx, dy, dz, mj, device=dev))
            results["permeability_dissipation"] = k_diss
            log(f"  From Energy Dissipation (k_diss): {k_diss:.6e} m²")
        if config.permeability_pressure and pressure is not None:
            k_press = float(compute_permeability_from_pressure(
                uj, vj, wj, pressure_dev, config.viscosity, dx, dy, dz,
                device=dev))
            results["permeability_pressure"] = k_press
            log(f"  From Pressure Gradient (k_press):  {k_press:.6e} m²")
            if k_diss:
                log(f"  Ratio (k_press/k_diss): {k_press / k_diss:.4f}")

    if want_xi and "xi" in deriv:
        log("\nComputing Astarita flow type classification...")
        xi = deriv["xi"]
        results["flow_type"] = xi
        vx = xi[mask] if mask is not None else xi
        log(f"  Mean ξ: {vx.mean():.4e}")

    if config.drag:
        log("\n=== Computing Interface Drag Force ===")
        with timings.stage("drag"):
            drag_results = drag_finish()
        results["drag"] = drag_results
        if not drag_results:
            log("  No interfaces found or labels not present.")
        for label, d in drag_results.items():
            log(f"  Grain/Phase Label {label}:")
            log(f"    Total Drag Force (N):       [{d['Fx']:.4e}, {d['Fy']:.4e}, {d['Fz']:.4e}]")
            log(f"    Force Density M (N/m³):     [{d['Mx']:.4e}, {d['My']:.4e}, {d['Mz']:.4e}]")
            log(f"    Surface Area (m²):           {d['Area']:.4e}")
            if background_mask is not None:
                log("    --- Phase-Split Analysis ---")
                log(f"    Water-Oil Drag (N):        [{d['Fx_water']:.4e}, {d['Fy_water']:.4e}, {d['Fz_water']:.4e}]")
                log(f"    Oil-Solid Friction (N):    [{d['Fx_solid']:.4e}, {d['Fy_solid']:.4e}, {d['Fz_solid']:.4e}]")
            log("    --- Stress Components ---")
            log(f"    Viscous Force (Shear) (N):  [{d['Fx_v_tan']:.4e}, {d['Fy_v_tan']:.4e}, {d['Fz_v_tan']:.4e}]")
            log(f"    Viscous Force (Normal) (N): [{d['Fx_v_nor']:.4e}, {d['Fy_v_nor']:.4e}, {d['Fz_v_nor']:.4e}]")
            if pressure is not None:
                log(f"    Pressure Force (N):         [{d['Fx_p']:.4e}, {d['Fy_p']:.4e}, {d['Fz_p']:.4e}]")

    if config.output_npz:
        log(f"\nSaving results to {config.output_npz}...")
        savable = {k: val for k, val in results.items()
                   if not isinstance(val, dict)}
        np.savez(config.output_npz, x=x, y=y, z=z,
                 mask=mask if mask is not None else np.ones(u.shape, bool),
                 **savable)

    if config.save_stats:
        stats_file = f"{basename}_stats.txt"
        log(f"Saving statistics to {stats_file}...")
        with open(stats_file, "w") as f:
            f.write("\n".join(stats_log))

    return results, stats_log
