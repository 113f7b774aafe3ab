"""Scattered-data interpolators. Ported so far: IDW and sibson, on
scattered queries and on regular grids, and the ``interpolate_field`` /
``interpolate_values`` dispatchers for those two methods."""

from ptv_interpolation_tpu_torch.interpolate.dispatch import (
    interpolate_field,
    interpolate_values,
)
from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
    idw_grid_interpolate,
    idw_interpolate,
    sibson_grid_interpolate,
    sibson_interpolate,
)

__all__ = [
    "interpolate_field",
    "interpolate_values",
    "idw_interpolate",
    "sibson_interpolate",
    "idw_grid_interpolate",
    "sibson_grid_interpolate",
]
