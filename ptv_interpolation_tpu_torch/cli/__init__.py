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
"""

import os
import sys

DAEMON_HELP = ("Accepted for compatibility with the JAX package's CLI; the "
               "serving daemon is not ported, so the run is inline. Also "
               "read from PTV_DAEMON=1.")


def note_inline_run(daemon_flag: bool) -> None:
    """Say on stderr that a requested daemon run goes inline, as the JAX
    package's CLIs do when no daemon answers."""
    if daemon_flag or os.environ.get("PTV_DAEMON") == "1":
        print("daemon unavailable; running inline", file=sys.stderr)
