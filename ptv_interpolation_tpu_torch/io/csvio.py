"""PTV point-cloud CSV ingest.

Carried over unchanged from ``ptv_interpolation_tpu/io/csvio.py``: host
numpy code, kept in the port so that it imports no JAX. Mirrors the
reference loader contract (the reference's ``interpolator.py:9-26``):
columns ``x,y,z,u,v,w`` with ``vx/vy/vz`` accepted as aliases; any violation
raises ``IOError``. The canonical in-memory representation here is a
:class:`PointCloud` (struct-of-arrays, float32) rather than a DataFrame —
fixed-dtype flat arrays are what the device path consumes.

A native C++ fast-path parser (``native/fastcsv``) is used automatically for
large files when its shared library has been built; the pandas path is the
portable fallback.
"""

from __future__ import annotations

import dataclasses
import numpy as np

_REQUIRED = ("x", "y", "z", "u", "v", "w")
_ALIASES = {"vx": "u", "vy": "v", "vz": "w"}


@dataclasses.dataclass
class PointCloud:
    """Scattered PTV vectors: positions (N,3) float32 and velocities (N,3) float32."""

    points: np.ndarray   # (N, 3) columns x, y, z
    values: np.ndarray   # (N, 3) columns u, v, w

    def __post_init__(self):
        self.points = np.ascontiguousarray(self.points, dtype=np.float32)
        self.values = np.ascontiguousarray(self.values, dtype=np.float32)
        assert self.points.shape == self.values.shape and self.points.shape[1] == 3

    def __len__(self) -> int:
        return self.points.shape[0]

    # convenience column views (x, y, z, u, v, w)
    @property
    def x(self): return self.points[:, 0]
    @property
    def y(self): return self.points[:, 1]
    @property
    def z(self): return self.points[:, 2]
    @property
    def u(self): return self.values[:, 0]
    @property
    def v(self): return self.values[:, 1]
    @property
    def w(self): return self.values[:, 2]

    def select(self, keep: np.ndarray) -> "PointCloud":
        """Row subset by boolean mask or index array (host-side compaction)."""
        return PointCloud(self.points[keep], self.values[keep])

    def concat(self, other: "PointCloud") -> "PointCloud":
        return PointCloud(np.concatenate([self.points, other.points]),
                          np.concatenate([self.values, other.values]))

    def offset(self, ox: float, oy: float, oz: float) -> "PointCloud":
        """Coordinate offset (reference `main.py:61-66`)."""
        return PointCloud(self.points + np.asarray([ox, oy, oz], np.float32), self.values)

    def swap_xy(self) -> "PointCloud":
        """Swap X/Y coordinates and velocities (reference `main.py:69-72`)."""
        perm = [1, 0, 2]
        return PointCloud(self.points[:, perm], self.values[:, perm])

    def clip_to_bounds(self, bounds) -> "PointCloud":
        """Domain filter: keep lo <= c < hi per axis (reference `main.py:140-142`)."""
        (xmin, xmax), (ymin, ymax), (zmin, zmax) = bounds
        p = self.points
        keep = ((p[:, 0] >= xmin) & (p[:, 0] < xmax)
                & (p[:, 1] >= ymin) & (p[:, 1] < ymax)
                & (p[:, 2] >= zmin) & (p[:, 2] < zmax))
        return self.select(keep)

    def to_dataframe(self):
        import pandas as pd
        return pd.DataFrame({"x": self.x, "y": self.y, "z": self.z,
                             "u": self.u, "v": self.v, "w": self.w})

    @staticmethod
    def from_arrays(x, y, z, u, v, w) -> "PointCloud":
        return PointCloud(np.stack([x, y, z], axis=-1), np.stack([u, v, w], axis=-1))


def load_ptv_data(filepath: str) -> PointCloud:
    """Load PTV vectors from CSV (reference `interpolator.py:9-26`)."""
    try:
        cloud = _load_native(filepath)
        if cloud is not None:
            return cloud
        import pandas as pd
        df = pd.read_csv(filepath)
        df = df.rename(columns=_ALIASES)
        if not set(_REQUIRED).issubset(df.columns):
            raise ValueError(f"CSV must contain columns: {set(_REQUIRED)}")
        return PointCloud(df[["x", "y", "z"]].to_numpy(np.float32),
                          df[["u", "v", "w"]].to_numpy(np.float32))
    except Exception as e:  # noqa: BLE001 - reference wraps all errors in IOError
        raise IOError(f"Error reading {filepath}: {e}")


def _load_native(filepath: str):
    """Try the C++ fast parser; return None to fall back to pandas."""
    try:
        from ptv_interpolation_tpu_torch.io import fastcsv
        return fastcsv.load(filepath)
    except Exception:  # library not built / header mismatch -> fallback
        return None


def save_ptv_data(filepath: str, cloud: PointCloud):
    header = "x,y,z,u,v,w"
    data = np.concatenate([cloud.points, cloud.values], axis=1)
    np.savetxt(filepath, data, delimiter=",", header=header, comments="", fmt="%.8g")
