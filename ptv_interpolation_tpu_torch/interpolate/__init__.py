"""Scattered-data interpolators. Ported so far: IDW and sibson, on
scattered queries and on regular grids."""

from ptv_interpolation_tpu_torch.interpolate.knn_weights import (
    idw_grid_interpolate,
    idw_interpolate,
    sibson_grid_interpolate,
    sibson_interpolate,
)

__all__ = [
    "idw_interpolate",
    "sibson_interpolate",
    "idw_grid_interpolate",
    "sibson_grid_interpolate",
]
