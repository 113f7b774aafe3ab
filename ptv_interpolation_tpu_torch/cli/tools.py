"""Post-hoc tools over the NPZ field contract: results viewer, divergence
viewer, flux plotter, and PTV-vs-simulation comparator.

Counterpart of ``ptv_interpolation_tpu/cli/tools.py`` (the reference's
`open_results.py`, `view_divergence.py`, `plot_flux.py` and
`compare_results.py`): the JAX package's flags, plus ``--device`` (default
``cuda``) where there is device work. The divergence, the per-plane
fluxes and the comparison run on that device; loading and plotting are
host work. ``open_results`` only plots, so it has no ``--device``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import as_f32, resolve_device
from ptv_interpolation_tpu_torch.io import load_velocity_field
from ptv_interpolation_tpu_torch.physics import compute_consistent_divergence


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default), cuda:N or "
                        "cpu")


# --------------------------------------------------------------- open_results

def open_results(argv=None):
    """Visualize PTV results from an NPZ (`open_results.py:5-35`)."""
    p = argparse.ArgumentParser(description="Visualize PTV results from NPZ file.")
    p.add_argument("file", nargs="?", default="sinteredGlass_interpolated.npz")
    args = p.parse_args(argv)

    print(f"Loading data from {args.file}...")
    f = load_velocity_field(args.file)
    if f.has_dual:
        print("Found both initial and cleaned velocity fields.")
        u, v, w = (f.u, f.u_init), (f.v, f.v_init), (f.w, f.w_init)
    else:
        print("Found single velocity field.")
        u, v, w = f.u, f.v, f.w
    from ptv_interpolation_tpu_torch.viz import show
    print("Launching visualizer...")
    show(u, v, w, f.x, f.y, f.z, mask=f.mask)


# ------------------------------------------------------------ view_divergence

def view_divergence(argv=None):
    """Divergence before/after cleaning (`view_divergence.py:7-67`); the
    divergence runs on ``--device``. Returns the mean absolute divergence
    over fluid nodes before and after cleaning."""
    p = argparse.ArgumentParser(
        description="Visualize flow field divergence before and after cleaning.")
    p.add_argument("file", nargs="?", default="sinteredGlass_interpolated.npz")
    p.add_argument("--velocity", "-v", action="store_true",
                   help="Visualize velocity comparison instead of divergence.")
    p.add_argument("--no-plot", action="store_true",
                   help="Print statistics only (headless).")
    _add_device(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"Loading data from {args.file}...")
    f = load_velocity_field(args.file)
    dx, dy, dz = f.spacing
    print(f"Grid Spacing: dx={dx:.4e}, dy={dy:.4e}, dz={dz:.4e}")
    if not f.has_dual:
        print("Error: No initial velocity field found in NPZ. Only 'u', 'v', 'w' present.")
        return

    mask = f.mask
    mask_t = torch.as_tensor(np.asarray(mask, bool), device=dev)

    def divergence(u, v, w):
        return compute_consistent_divergence(
            as_f32(u, dev), as_f32(v, dev), as_f32(w, dev), mask_t, dx, dy,
            dz).cpu().numpy()

    print("Computing divergence for Initial field...")
    div_init = divergence(f.u_init, f.v_init, f.w_init)
    print("Computing divergence for Cleaned field...")
    div_clean = divergence(f.u, f.v, f.w)

    m_init = np.abs(div_init[mask]).mean()
    m_clean = np.abs(div_clean[mask]).mean()
    print("\nDivergence Statistics (Mean Absolute):")
    print(f"  Initial: {m_init:.6e}")
    print(f"  Cleaned: {m_clean:.6e}")
    print(f"  Reduction: {m_init / m_clean:.2f}x")

    if args.no_plot:
        return m_init, m_clean
    if args.velocity:
        from ptv_interpolation_tpu_torch.viz import show
        show((f.u, f.u_init), (f.v, f.v_init), (f.w, f.w_init),
             f.x, f.y, f.z, mask=mask)
    else:
        from ptv_interpolation_tpu_torch.viz import compare_scalars
        compare_scalars(div_init, div_clean, f.x, f.y, f.z, mask=mask,
                        labels=("Initial Divergence", "Cleaned Divergence"),
                        title="Flow Field Divergence Comparison")
    return m_init, m_clean


# ------------------------------------------------------------------ plot_flux

def _plane_flux(field, axes, h1, h2, device) -> np.ndarray:
    """Σ over ``axes`` of the f32 field on ``device``, times h1·h2 on the
    host (the JAX package's f32 ops), as a numpy f32 array."""
    s = as_f32(field, resolve_device(device)).sum(dim=axes)
    return s.cpu().numpy() * h1 * h2


def calculate_flux_xy(w_field, dx, dy, device="cuda"):
    """Flux through XY planes (`plot_flux.py:6-8`)."""
    return _plane_flux(w_field, (1, 2), dx, dy, device)


def calculate_flux_xz(v_field, dx, dz, device="cuda"):
    return _plane_flux(v_field, (0, 2), dx, dz, device)


def calculate_flux_yz(u_field, dy, dz, device="cuda"):
    return _plane_flux(u_field, (0, 1), dy, dz, device)


def plot_flux(argv=None):
    """Per-plane volumetric flux comparison plot (`plot_flux.py:18-87`);
    the fluxes are summed on ``--device``. Returns ``{plane: (mean, std)}``
    of the cleaned field's fluxes."""
    p = argparse.ArgumentParser(
        description="Compare volumetric flux of original and cleaned fields.")
    p.add_argument("file", nargs="?", default="sinteredGlass_interpolated.npz")
    p.add_argument("--output", "-o", default="flux_comparison.png")
    p.add_argument("--no-show", action="store_true")
    _add_device(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if not os.path.exists(args.file):
        print(f"Error: File '{args.file}' not found.")
        return
    print(f"Loading data from {args.file}...")
    f = load_velocity_field(args.file)
    dx, dy, dz = f.spacing

    import matplotlib
    if args.no_show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 3, figsize=(18, 6))
    fig.suptitle(f"Volumetric Flux Comparison: {os.path.basename(args.file)}",
                 fontsize=14)
    planes = [
        ("XY (Z-flux)", f.z, f.w, calculate_flux_xy, dx, dy, "Z Position",
         f.w_init),
        ("XZ (Y-flux)", f.y, f.v, calculate_flux_xz, dx, dz, "Y Position",
         f.v_init),
        ("YZ (X-flux)", f.x, f.u, calculate_flux_yz, dy, dz, "X Position",
         f.u_init),
    ]
    print("\nFlux Statistics:")
    stats = {}
    for i, (title, coords, field, func, h1, h2, xlabel, init) in enumerate(planes):
        ax = axs[i]
        flux_c = func(field, h1, h2, device=dev)
        ax.plot(coords, flux_c, "b-", label="Cleaned", linewidth=2)
        c_mean, c_std = flux_c.mean(), flux_c.std()
        c_var = (c_std / abs(c_mean) * 100) if abs(c_mean) > 1e-12 else 0
        print(f"  {title} Cleaned: Mean={c_mean:.4e}, Std={c_std:.4e} "
              f"({c_var:.2f}% variation)")
        stats[title] = (c_mean, c_std)
        if init is not None:
            flux_i = func(init, h1, h2, device=dev)
            ax.plot(coords, flux_i, "r--", label="Original", alpha=0.7)
            i_mean, i_std = flux_i.mean(), flux_i.std()
            i_var = (i_std / abs(i_mean) * 100) if abs(i_mean) > 1e-12 else 0
            print(f"  {title} Original: Mean={i_mean:.4e}, Std={i_std:.4e} "
                  f"({i_var:.2f}% variation)")
        ax.set_title(title)
        ax.set_xlabel(xlabel)
        if i == 0:
            ax.set_ylabel("Volumetric Flux (Q)")
        ax.legend()
        ax.grid(True, alpha=0.3)
    plt.tight_layout(rect=[0, 0.03, 1, 0.95])
    print(f"\nSaving plot to {args.output}...")
    plt.savefig(args.output, dpi=150)
    if not args.no_show:
        plt.show()
    return stats


# ------------------------------------------------------------ compare_results

def compare_results(argv=None):
    """Compare a PTV NPZ field against simulation reference TIFFs
    (`compare_results.py:7-130`): optional 2x PTV upscale or reference
    downscale, shape-mismatch truncation, mean-speed normalization — in
    f64 on ``--device``. Returns the L2 difference."""
    p = argparse.ArgumentParser(
        description="Compare PTV field with a simulated reference field.")
    p.add_argument("--ptv", required=True, help="PTV result NPZ")
    p.add_argument("--ref-u", required=True, help="Reference u TIFF")
    p.add_argument("--ref-v", required=True, help="Reference v TIFF")
    p.add_argument("--ref-w", required=True, help="Reference w TIFF")
    p.add_argument("--upscale-ptv", action="store_true",
                   help="Repeat-upscale the PTV field 2x")
    p.add_argument("--downscale-ref", action="store_true",
                   help="Stride-2 downscale the reference field")
    p.add_argument("--normalize", action="store_true", default=True)
    p.add_argument("--no-plot", action="store_true")
    _add_device(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from ptv_interpolation_tpu_torch.io.tiff import read_tiff

    def f64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)

    f = load_velocity_field(args.ptv)
    u_p, v_p, w_p = (f64(a) for a in (f.u, f.v, f.w))
    u_r, v_r, w_r = (f64(read_tiff(path))
                     for path in (args.ref_u, args.ref_v, args.ref_w))

    if args.upscale_ptv:
        u_p, v_p, w_p = (a.repeat_interleave(2, 0).repeat_interleave(2, 1)
                         .repeat_interleave(2, 2) for a in (u_p, v_p, w_p))
    if args.downscale_ref:
        u_r, v_r, w_r = (a[::2, ::2, ::2] for a in (u_r, v_r, w_r))

    shape = tuple(min(a, b) for a, b in zip(u_p.shape, u_r.shape))
    sl = tuple(slice(0, s) for s in shape)
    u_p, v_p, w_p = u_p[sl], v_p[sl], w_p[sl]
    u_r, v_r, w_r = u_r[sl], v_r[sl], w_r[sl]

    if args.normalize:
        s_p = float(torch.sqrt(u_p ** 2 + v_p ** 2 + w_p ** 2).mean()) or 1.0
        s_r = float(torch.sqrt(u_r ** 2 + v_r ** 2 + w_r ** 2).mean()) or 1.0
        u_r, v_r, w_r = (a * (s_p / s_r) for a in (u_r, v_r, w_r))
        print(f"Normalized reference by mean-speed ratio {s_p / s_r:.4f}")

    l2 = float(torch.sqrt(((u_p - u_r) ** 2 + (v_p - v_r) ** 2
                           + (w_p - w_r) ** 2).mean()))
    print(f"L2 difference (after alignment): {l2:.6e}")
    if not args.no_plot:
        from ptv_interpolation_tpu_torch.viz import side_by_side
        x = np.arange(shape[2])
        y = np.arange(shape[1])
        z = np.arange(shape[0])
        side_by_side(tuple(a.cpu().numpy() for a in (u_p, v_p, w_p)),
                     tuple(a.cpu().numpy() for a in (u_r, v_r, w_r)),
                     x, y, z, labels=("PTV", "Simulation"))
    return l2
