"""Scattered-data interpolators: IDW, sibson, nearest, local and global
RBF, and linear (Delaunay), on scattered queries and on regular grids,
and the ``interpolate_field`` / ``interpolate_values`` dispatchers."""

from ptv_interpolation_tpu_torch.interpolate.delaunay import linear_interpolate
from ptv_interpolation_tpu_torch.interpolate.dispatch import (
    interpolate_field,
    interpolate_values,
)
from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
    idw_grid_interpolate,
    idw_interpolate,
    nearest_interpolate,
    sibson_grid_interpolate,
    sibson_interpolate,
)
from ptv_interpolation_tpu_torch.interpolate.rbf_global import (
    GlobalRBF,
    rbf_global_evaluate,
    rbf_global_fit,
    rbf_global_interpolate,
)
from ptv_interpolation_tpu_torch.interpolate.rbf_global_pcg import (
    rbf_global_fit_pcg,
)
from ptv_interpolation_tpu_torch.interpolate.rbf_local import (
    rbf_local_interpolate,
)

__all__ = [
    "interpolate_field",
    "interpolate_values",
    "idw_interpolate",
    "sibson_interpolate",
    "nearest_interpolate",
    "linear_interpolate",
    "rbf_local_interpolate",
    "GlobalRBF",
    "rbf_global_fit",
    "rbf_global_fit_pcg",
    "rbf_global_evaluate",
    "rbf_global_interpolate",
    "idw_grid_interpolate",
    "sibson_grid_interpolate",
]
