"""NPZ/TIFF field artifacts — the checkpoint/resume contract between the
interpolation and analysis pipelines.

The reference joins its two pipelines through an NPZ with keys
``{x, y, z, u, v, w, mask[, u_init, v_init, w_init]}`` (`main.py:221-226`)
read back by `analyze_flow.py:27-52` and every post-hoc tool. This module
keeps that contract byte-for-byte so results are interchangeable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ptv_interpolation_tpu_torch.io.tiff import read_tiff, write_tiff


def load_mask(filepath: str) -> np.ndarray:
    """3D TIFF → boolean fluid mask; nonzero = fluid (reference
    `interpolator.py:28-39`)."""
    try:
        mask = read_tiff(filepath)
        return mask > 0
    except Exception as e:  # noqa: BLE001
        raise IOError(f"Error reading mask {filepath}: {e}")


@dataclasses.dataclass
class FieldResult:
    """A gridded velocity field plus metadata — the NPZ contract as a type."""

    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray
    mask: Optional[np.ndarray] = None        # True = fluid
    u_init: Optional[np.ndarray] = None
    v_init: Optional[np.ndarray] = None
    w_init: Optional[np.ndarray] = None

    @property
    def spacing(self):
        dx = float(self.x[1] - self.x[0]) if len(self.x) > 1 else 1.0
        dy = float(self.y[1] - self.y[0]) if len(self.y) > 1 else 1.0
        dz = float(self.z[1] - self.z[0]) if len(self.z) > 1 else 1.0
        return dx, dy, dz

    @property
    def has_dual(self) -> bool:
        return self.u_init is not None


def save_field_npz(filepath: str, result: FieldResult):
    """Write the `{x,y,z,u,v,w,mask[,*_init]}` NPZ (reference `main.py:221-226`)."""
    save_dict = {
        "x": np.asarray(result.x), "y": np.asarray(result.y), "z": np.asarray(result.z),
        "u": np.asarray(result.u), "v": np.asarray(result.v), "w": np.asarray(result.w),
    }
    if result.mask is not None:
        save_dict["mask"] = np.asarray(result.mask)
    if result.has_dual:
        save_dict.update(u_init=np.asarray(result.u_init),
                         v_init=np.asarray(result.v_init),
                         w_init=np.asarray(result.w_init))
    np.savez(filepath, **save_dict)


def load_velocity_field(filepath: str) -> FieldResult:
    """Read a field NPZ back (reference `analyze_flow.py:27-52`,
    `open_results.py:11-29`)."""
    data = np.load(filepath)
    for field in ("u", "v", "w", "x", "y", "z"):
        if field not in data:
            raise ValueError(f"NPZ file missing required field: {field}")
    mask = data["mask"] if "mask" in data else np.ones(data["u"].shape, dtype=bool)
    kwargs = {}
    if "u_init" in data:
        kwargs = dict(u_init=data["u_init"], v_init=data["v_init"], w_init=data["w_init"])
    return FieldResult(x=data["x"], y=data["y"], z=data["z"],
                       u=data["u"], v=data["v"], w=data["w"], mask=mask, **kwargs)


def save_field_tiff(filepath: str, u, v, w):
    """ZCYX multi-channel float32 stack (reference `main.py:228-231`)."""
    stack = np.stack([np.asarray(u, np.float32),
                      np.asarray(v, np.float32),
                      np.asarray(w, np.float32)], axis=1)
    write_tiff(filepath, stack, imagej=True, axes="ZCYX")
