"""PyTorch/CUDA port of ``ptv_interpolation_tpu`` for NVIDIA Hopper GPUs.

Module paths and function names mirror the JAX package, which stays the
reference the port is tested against. This package imports ``torch`` and
numpy and never ``jax``. Its one hand-written kernel lives in
``ops/csrc/fused_grid_knn.cu`` and is built with ``nvcc`` at first use.
"""

from ptv_interpolation_tpu_torch.grid import Grid, create_grid

__all__ = ["Grid", "create_grid"]
