"""Matplotlib viewers over the NPZ field contract (host-side compat layer).

Carried over from ``ptv_interpolation_tpu/viz/`` unchanged (host numpy;
matplotlib is imported only when a viewer is built), so that the port's
CLIs plot without importing JAX."""

from ptv_interpolation_tpu_torch.viz.scalar import show_scalar_field
from ptv_interpolation_tpu_torch.viz.slices import (
    ComparisonViewer,
    ScalarSideBySideViewer,
    ScalarSliceViewer,
    SideBySideViewer,
    SliceViewer,
    compare,
    compare_scalars,
    show,
    show_scalar,
    side_by_side,
)

__all__ = [
    "SliceViewer",
    "ComparisonViewer",
    "SideBySideViewer",
    "ScalarSliceViewer",
    "ScalarSideBySideViewer",
    "show",
    "compare",
    "side_by_side",
    "show_scalar",
    "compare_scalars",
    "show_scalar_field",
]
