"""Command-line entry points of the port (flag-compatible with the
reference scripts and the JAX package's CLIs, plus ``--device``).

python -m ptv_interpolation_tpu_torch.cli.main             — interpolation pipeline
python -m ptv_interpolation_tpu_torch.cli.analyze_flow     — analysis pipeline
python -m ptv_interpolation_tpu_torch.cli.auto_align       — mask/points offset
python -m ptv_interpolation_tpu_torch.cli.pre_viewer       — alignment viewer
python -m ptv_interpolation_tpu_torch.cli.open_results     — results viewer
python -m ptv_interpolation_tpu_torch.cli.view_divergence  — divergence viewer
python -m ptv_interpolation_tpu_torch.cli.plot_flux        — per-plane flux plot
python -m ptv_interpolation_tpu_torch.cli.compare_results  — PTV vs simulation
python -m ptv_interpolation_tpu_torch.daemon start|stop|status — serving daemon
"""
