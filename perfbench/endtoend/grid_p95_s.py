"""The 95th percentile of every unit's own wall in the window (linear
interpolation between order statistics)."""

import numpy as np


def read(window):
    return float(np.percentile(window.unit_walls, 95)) if window.unit_walls else None
