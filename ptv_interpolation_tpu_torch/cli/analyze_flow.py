"""Analysis pipeline CLI — flag-compatible with the reference
``python analyze_flow.py`` (`analyze_flow.py:183-243`) and the JAX
package's ``ptv_interpolation_tpu.cli.analyze_flow``, including the paired
``--no-*`` disables, plus ``--device`` (default ``cuda``)."""

from __future__ import annotations

import argparse
import os
import sys

from ptv_interpolation_tpu_torch.analyze import AnalyzeConfig, run_analysis


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Analyze interpolated velocity fields.")
    p.add_argument("--input", "-i", default="velocity_field.npz",
                   help="Input NPZ file with velocity field")
    # The positive analysis flags are deliberate no-ops (`store_true` with
    # default=True): the reference defines them identically
    # (`analyze_flow.py:184-224`) and only the paired `--no-*` forms below
    # act. Kept as-is so reference invocations parse unchanged.
    p.add_argument("--strain-rate", action="store_true", default=True)
    p.add_argument("--dissipation", action="store_true", default=True)
    p.add_argument("--vorticity", action="store_true", default=True)
    p.add_argument("--permeability_dissipation", action="store_true", default=True)
    p.add_argument("--permeability_pressure", action="store_true", default=True)
    p.add_argument("--pressure", action="store_true", default=True)
    p.add_argument("--pressure-wall-bc", choices=["zero-neumann", "inhomogeneous"],
                   default="zero-neumann")
    p.add_argument("--pressure-anchor", choices=["inlet", "outlet", "none"],
                   default="outlet")
    p.add_argument("--viscosity", type=float, default=0.001)
    p.add_argument("--rho", type=float, default=0.0)
    p.add_argument("--flow-direction", choices=["auto", "positive", "negative"],
                   default="auto")
    p.add_argument("--drag", action="store_true", default=True)
    p.add_argument("--drag-labels", type=int, nargs="*")
    p.add_argument("--drag-method", choices=["staircase", "mesh"], default="mesh")
    p.add_argument("--drag-mesh-step", type=int, default=1)
    p.add_argument("--pore-mask", help="TIFF with the background pore geometry")
    p.add_argument("--voxel-size", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--output-npz", default=None)
    p.add_argument("--no-output-npz", action="store_const", const="",
                   dest="output_npz")
    # per-field TIFF redirects (`analyze_flow.py:210-213`);
    # default None → "<basename>_<field>.tif"
    p.add_argument("--output-tif-strain", default=None,
                   help="Output TIFF file for strain rate field")
    p.add_argument("--output-tif-dissipation", default=None,
                   help="Output TIFF file for dissipation field")
    p.add_argument("--output-tif-vorticity", default=None,
                   help="Output TIFF file for vorticity magnitude field")
    p.add_argument("--output-tif-pressure", default=None,
                   help="Output TIFF file for pressure field")
    # visualization
    p.add_argument("--plot-strain", action="store_true", default=False)
    p.add_argument("--plot-dissipation", action="store_true", default=False)
    p.add_argument("--plot-vorticity", action="store_true", default=False)
    p.add_argument("--plot-pressure", action="store_true", default=False)
    p.add_argument("--plot-velocity", action="store_true", default=False)
    p.add_argument("--plot-flowtype", action="store_true", default=False)
    p.add_argument("--log-scale", action="store_true", default=True)
    p.add_argument("--interactive", action="store_true", default=True)
    # paired disables (`analyze_flow.py:226-241`)
    p.add_argument("--no-strain-rate", action="store_false", dest="strain_rate")
    p.add_argument("--no-dissipation", action="store_false", dest="dissipation")
    p.add_argument("--no-vorticity", action="store_false", dest="vorticity")
    p.add_argument("--no-permeability_dissipation", action="store_false",
                   dest="permeability_dissipation")
    p.add_argument("--no-permeability_pressure", action="store_false",
                   dest="permeability_pressure")
    p.add_argument("--no-pressure", action="store_false", dest="pressure")
    p.add_argument("--no-drag", action="store_false", dest="drag")
    p.add_argument("--no-plot-strain", action="store_false", dest="plot_strain")
    p.add_argument("--no-plot-dissipation", action="store_false",
                   dest="plot_dissipation")
    p.add_argument("--no-plot-vorticity", action="store_false",
                   dest="plot_vorticity")
    p.add_argument("--no-plot-pressure", action="store_false",
                   dest="plot_pressure")
    p.add_argument("--no-plot-velocity", action="store_false",
                   dest="plot_velocity")
    p.add_argument("--no-plot-flowtype", action="store_false",
                   dest="plot_flowtype")
    p.add_argument("--no-log-scale", action="store_false", dest="log_scale")
    p.add_argument("--no-interactive", action="store_false", dest="interactive")
    p.add_argument("--no-tiffs", action="store_false", dest="save_tiffs",
                   default=True)
    p.add_argument("--daemon", "-D", action="store_true",
                   help="Run through the persistent serving daemon "
                        "(ptv-torch-daemon); also enabled by PTV_DAEMON=1. "
                        "Implies --no-interactive.")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default), cuda:N or "
                        "cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ptv_interpolation_tpu_torch import daemon
    if daemon.wants_daemon(args.daemon) and not os.environ.get("PTV_IN_DAEMON"):
        fwd = [a for a in (argv if argv is not None else sys.argv[1:])
               if a not in ("--daemon", "-D")]
        fwd.append("--no-interactive")  # the daemon cannot open a viewer here
        rc = daemon.dispatch("analyze", fwd)
        if rc is not None:
            return rc
        print("daemon unavailable; running inline", file=sys.stderr)
    basename = os.path.splitext(os.path.basename(args.input))[0]
    output_npz = args.output_npz
    if output_npz is None:
        output_npz = basename + "_analysis.npz"
    elif output_npz == "":
        output_npz = None

    config = AnalyzeConfig(
        input=args.input, basename=basename, strain_rate=args.strain_rate,
        dissipation=args.dissipation, vorticity=args.vorticity,
        permeability_dissipation=args.permeability_dissipation,
        permeability_pressure=args.permeability_pressure,
        pressure=args.pressure, pressure_wall_bc=args.pressure_wall_bc,
        pressure_anchor=args.pressure_anchor, viscosity=args.viscosity,
        rho=args.rho, flow_direction=args.flow_direction, drag=args.drag,
        drag_labels=args.drag_labels, drag_method=args.drag_method,
        drag_mesh_step=args.drag_mesh_step, pore_mask=args.pore_mask,
        voxel_size=args.voxel_size, dt=args.dt,
        flow_type=args.plot_flowtype, output_npz=output_npz,
        save_tiffs=args.save_tiffs,
        output_tif_strain=args.output_tif_strain,
        output_tif_dissipation=args.output_tif_dissipation,
        output_tif_vorticity=args.output_tif_vorticity,
        output_tif_pressure=args.output_tif_pressure,
    )
    results, _ = run_analysis(config, device=args.device)

    any_plot = (args.plot_strain or args.plot_dissipation or args.plot_vorticity
                or args.plot_velocity or args.plot_flowtype or args.plot_pressure)
    if any_plot:
        import matplotlib.pyplot as plt
        import numpy as np

        from ptv_interpolation_tpu_torch.io import load_velocity_field
        from ptv_interpolation_tpu_torch.viz import show_scalar_field
        field = load_velocity_field(args.input)
        x, y, z, mask = field.x, field.y, field.z, field.mask
        plots = [
            (args.plot_strain, "strain_rate", "Strain Rate (Shear Rate) (1/s)",
             "viridis", False, None),
            (args.plot_dissipation, "dissipation", "Viscous Dissipation (W/m³)",
             "viridis", args.log_scale, None),
            (args.plot_vorticity, "vorticity_magnitude",
             "Vorticity Magnitude (1/s)", "viridis", False, None),
            (args.plot_pressure, "pressure", "Pressure Field (Pa)",
             "RdBu_r", False, None),
            (args.plot_flowtype, "flow_type",
             "Astarita Flow Type ξ (-1:Rot, 0:Shear, 1:Ext)", "RdBu_r",
             False, (-1, 1)),
        ]
        for enabled, key, name, cmap, log_scale, clim in plots:
            if enabled and key in results:
                fig = plt.figure(figsize=(14, 7))
                show_scalar_field(results[key], x, y, z, mask,
                                  field_name=name, log_scale=log_scale,
                                  fig=fig, interactive=args.interactive,
                                  cmap=cmap, clim=clim)
                if not args.interactive:
                    fig.savefig(f"{basename}_{key}.png", dpi=150)
        if args.plot_velocity:
            speed = np.sqrt(field.u ** 2 + field.v ** 2 + field.w ** 2)
            fig = plt.figure(figsize=(14, 7))
            show_scalar_field(speed, x, y, z, mask,
                              field_name="Velocity Magnitude (m/s)", fig=fig,
                              interactive=args.interactive)
        plt.show()
    print("\nDone.")


if __name__ == "__main__":
    main()
