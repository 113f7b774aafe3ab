"""Host-side I/O: CSV point clouds, TIFF volumes, NPZ field checkpoints.

Carried over from ``ptv_interpolation_tpu/io/`` (numpy only), so that the
port imports no JAX. The native parsers stay in ``native/`` (built by
``native/build.sh``); without them the pure-Python paths serve."""

from ptv_interpolation_tpu_torch.io.csvio import PointCloud, load_ptv_data, save_ptv_data
from ptv_interpolation_tpu_torch.io.tiff import read_tiff, write_tiff
from ptv_interpolation_tpu_torch.io.npz import (
    FieldResult,
    load_mask,
    load_velocity_field,
    save_field_npz,
    save_field_tiff,
)

__all__ = [
    "PointCloud",
    "load_ptv_data",
    "save_ptv_data",
    "read_tiff",
    "write_tiff",
    "FieldResult",
    "load_mask",
    "load_velocity_field",
    "save_field_npz",
    "save_field_tiff",
]
