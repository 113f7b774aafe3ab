"""PyTorch/CUDA port of ``ptv_interpolation_tpu`` for NVIDIA Hopper GPUs.

Module paths and function names mirror the JAX package, which stays the
reference the port is tested against. This package imports ``torch`` and
numpy and never ``jax``. Ported so far: the grid interpolation routes
(sibson/IDW onto a regular grid), the outlier filters, divergence cleaning
and Poisson solves (``physics``: projection and variational cleaning on
the stencils, CG and multigrid of ``ops``), and the production pipeline
end to end (``pipeline.run_pipeline``: load, domain clip, threshold and
kNN-MAD outlier filters, mask resample, boundary particles, interpolation,
solid zeroing, divergence cleaning, NPZ/TIFF artifacts), flow analysis
(``analyze.run_analysis`` over ``analysis``, ``drag``, ``surface`` and
``ops/sampling``: strain rate, dissipation, vorticity, flow type, pressure
recovery, two permeabilities, staircase and mesh interface drag), and the
two CLIs (``cli/main.py``, ``cli/analyze_flow.py``) with their ``viz``
viewers. As in the JAX package, the cleaning entry points are reached
through the ``physics`` module.

Three hand-written CUDA kernels, built with ``nvcc`` at first use:
``ops/csrc/fused_grid_knn.cu`` (the grid kNN τ-bisection weighted sums),
``ops/csrc/fused_mad.cu`` (the kNN-MAD filter's statistics) and
``ops/csrc/pallas_grid_knn.cu`` (the one-phase kernel of
``backend='pallas'``). Cleaning and analysis run as PyTorch ops.
"""

from ptv_interpolation_tpu_torch.analyze import AnalyzeConfig, run_analysis
from ptv_interpolation_tpu_torch.grid import (
    Grid,
    create_grid,
    extract_boundary_particles,
    grid_from_mask_shape,
    sample_mask_on_grid,
)
from ptv_interpolation_tpu_torch.io import (
    FieldResult,
    PointCloud,
    load_mask,
    load_ptv_data,
    load_velocity_field,
    save_field_npz,
    save_field_tiff,
)
from ptv_interpolation_tpu_torch.pipeline import PipelineConfig, run_pipeline

__all__ = [
    "Grid",
    "create_grid",
    "grid_from_mask_shape",
    "sample_mask_on_grid",
    "extract_boundary_particles",
    "PointCloud",
    "FieldResult",
    "load_ptv_data",
    "load_mask",
    "load_velocity_field",
    "save_field_npz",
    "save_field_tiff",
    "PipelineConfig",
    "run_pipeline",
    "AnalyzeConfig",
    "run_analysis",
]
