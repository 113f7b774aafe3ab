"""The port's grid and device policy against the JAX package, and the
port's independence from JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.grid import create_grid as jax_create_grid
from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.grid import create_grid

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("bounds,res", [
    (((0, 25), (0, 25), (0, 25)), 24),
    (((0, 257), (0, 257), (0, 257)), 256),
    (((-3.5, 10.0), (2.0, 40.0), (0.0, 9.0)), (13, 37, 5)),
    (((0, 5), (0, 5), (0, 5)), (1, 4, 7)),
])
def test_grid_axes_and_spacing_match_jax(bounds, res):
    want = jax_create_grid(bounds, res)
    got = create_grid(bounds, res)
    assert got.shape == want.shape
    assert got.bounds == want.bounds
    assert got.n_points == want.n_points
    for axis in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(got, axis), getattr(want, axis))
    assert got.spacing == want.spacing


def test_resolve_device_policy():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            resolve_device("cuda")


def test_port_never_imports_jax():
    """Importing the port and running the slice end to end leaves every
    ``jax`` module out of ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import ptv_interpolation_tpu_torch
        import ptv_interpolation_tpu_torch.convert
        from ptv_interpolation_tpu_torch.interpolate import (
            idw_grid_interpolate, sibson_grid_interpolate)
        rng = np.random.default_rng(0)
        pts = rng.uniform([0, 0, 0], [12, 12, 5], (600, 3)).astype(np.float32)
        vals = np.stack([pts[:, 0], pts[:, 1], np.ones(600)], -1)
        grid = ptv_interpolation_tpu_torch.create_grid(((0, 13),) * 3, 12)
        a = sibson_grid_interpolate(pts, vals, grid, k=8, block=(2, 4, 8),
                                    device="cpu")
        b = idw_grid_interpolate(pts, vals, grid, k=8, block=(2, 4, 8),
                                 device="cpu")
        assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib")))
        print("JAX_MODULES", loaded)
        sys.exit(1 if loaded else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "JAX_MODULES []" in res.stdout
