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
from ptv_interpolation_tpu.grid import (
    grid_from_mask_shape as jax_grid_from_mask_shape)
from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.grid import create_grid, grid_from_mask_shape

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


@pytest.mark.parametrize("shape,bounds,downscale", [
    ((486, 336, 322), None, 2.0),
    ((64, 64, 64), None, 1.0),
    ((7, 9, 11), ((2.0, 13.0), (1.0, 10.0), (0.0, 7.0)), 3.0),
    ((3, 4, 5), None, 10.0),
])
def test_grid_from_mask_shape_matches_jax(shape, bounds, downscale):
    want = jax_grid_from_mask_shape(shape, bounds, downscale)
    got = grid_from_mask_shape(shape, bounds, downscale)
    assert got.shape == want.shape and got.bounds == want.bounds
    for axis in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(got, axis), getattr(want, axis))
    import ptv_interpolation_tpu_torch
    assert ptv_interpolation_tpu_torch.grid_from_mask_shape is \
        grid_from_mask_shape


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


def test_flat_coords_defaults_to_cuda():
    """``Grid.flat_coords`` runs on the card unless the CPU is asked for,
    like every entry point of the port: without an argument it raises
    where CUDA is absent; on the CPU it gives the JAX package's rows."""
    grid = create_grid(((-1.0, 4.0), (0.0, 3.0), (2.0, 9.0)), (5, 3, 4))
    want = np.asarray(jax_create_grid(((-1.0, 4.0), (0.0, 3.0), (2.0, 9.0)),
                                      (5, 3, 4)).flat_coords())
    np.testing.assert_array_equal(grid.flat_coords("cpu").numpy(), want)
    if torch.cuda.is_available():
        assert grid.flat_coords().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            grid.flat_coords()


def test_port_never_imports_jax():
    """Importing the port (the multi-GPU paths, alignment, the post-hoc
    tools and checkpoints included) and running its slices end to end (the
    grid entry points, the pipeline with variational cleaning, every other
    interpolation method, the datasets, the flow analysis with pressure
    and mesh drag, the sharded grid path and the pipeline step with its
    z-sharded cleaning on a one-rank mesh) leaves every ``jax`` module out
    of ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import ptv_interpolation_tpu_torch
        import ptv_interpolation_tpu_torch.convert
        import ptv_interpolation_tpu_torch.physics
        import ptv_interpolation_tpu_torch.parallel
        import ptv_interpolation_tpu_torch.parallel.slab_store
        import ptv_interpolation_tpu_torch.parallel.halo
        import ptv_interpolation_tpu_torch.entry
        import ptv_interpolation_tpu_torch.align
        import ptv_interpolation_tpu_torch.cli.tools
        import ptv_interpolation_tpu_torch.cli.auto_align
        import ptv_interpolation_tpu_torch.cli.pre_viewer
        import ptv_interpolation_tpu_torch.io.checkpoint
        from ptv_interpolation_tpu_torch.cli import (compare_results,
                                                     open_results, plot_flux,
                                                     view_divergence)
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
        from ptv_interpolation_tpu_torch.parallel import make_mesh
        from ptv_interpolation_tpu_torch.parallel.sharding import (
            sharded_grid_interpolate)
        c = sharded_grid_interpolate(pts, vals, grid, make_mesh(device="cpu"),
                                     k=8, block=(2, 4, 8))
        assert bool(torch.isfinite(c).all())
        from ptv_interpolation_tpu_torch.parallel import make_pipeline_step
        fluid = np.ones((12, 12, 12), bool)
        fluid[4:8, 4:8, 4:8] = False
        step = make_pipeline_step(grid, mesh=make_mesh(device="cpu"), k=8)
        assert bool(torch.isfinite(step(pts, vals, fluid)[0]).all())
        from ptv_interpolation_tpu_torch.io import PointCloud
        from ptv_interpolation_tpu_torch.pipeline import (PipelineConfig,
                                                          run_pipeline)
        res = run_pipeline(
            PipelineConfig(method="idw", idw_neighbors=8, filter_outliers=True,
                           filter_neighbors=10, boundary_particles=True,
                           divergence_free=True,
                           cleaning_method="variational", verbose=False),
            cloud=PointCloud(pts, vals), mask_raw=fluid, device="cpu")
        assert np.isfinite(res.u).all() and (res.u[~res.mask] == 0).all()
        assert res.has_dual
        from ptv_interpolation_tpu_torch.datasets import cylinders
        from ptv_interpolation_tpu_torch.interpolate import interpolate_field
        for method, kw in (("linear", {}), ("nearest", {}),
                           ("rbf", dict(rbf_neighbors=12)),
                           ("rbf", dict(rbf_neighbors=None,
                                        rbf_kernel="gaussian"))):
            u, v, w = interpolate_field(pts[:300], vals[:300], grid,
                                        method=method, device="cpu", **kw)
            assert u.shape == (12, 12, 12)
        cyl, _, _ = cylinders.generate(n_points=200)
        from ptv_interpolation_tpu_torch import AnalyzeConfig, run_analysis
        results, _ = run_analysis(
            AnalyzeConfig(flow_type=True, save_tiffs=False, save_stats=False,
                          verbose=False), field=res, device="cpu")
        assert results["drag"][1]["Area"] > 0
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


def _mask(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.random(shape) > 0.7


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("op", ["dilation", "erosion"])
def test_binary_morphology_matches_jax_and_scipy(op, iterations):
    import scipy.ndimage as ndi
    from ptv_interpolation_tpu import grid as jg
    from ptv_interpolation_tpu_torch import grid as tg
    m = _mask((9, 12, 7), iterations)
    if op == "erosion":
        m = ~m
    got = getattr(tg, f"binary_{op}6")(m, iterations, device="cpu")
    assert got.dtype == torch.bool
    want = np.asarray(getattr(jg, f"binary_{op}6")(m, iterations))
    np.testing.assert_array_equal(got.numpy(), want)
    scipy_op = getattr(ndi, f"binary_{op}")
    np.testing.assert_array_equal(
        got.numpy(), scipy_op(m, ndi.generate_binary_structure(3, 1),
                              iterations=iterations))


@pytest.mark.parametrize("shape,bounds,res,bounds_raw", [
    ((30, 24, 20), ((0, 20), (0, 24), (0, 30)), (10, 12, 15), None),
    ((31, 25, 19), ((0, 19), (0, 25), (0, 31)), (7, 13, 16), None),
    ((20, 20, 20), ((2, 18), (0, 20), (5, 20)), (8, 10, 7),
     ((0, 20), (0, 20), (0, 20))),
])
def test_sample_mask_on_grid_matches_jax(shape, bounds, res, bounds_raw):
    from ptv_interpolation_tpu.grid import sample_mask_on_grid as jax_sample
    from ptv_interpolation_tpu_torch.grid import sample_mask_on_grid
    m = _mask(shape, 5)
    want = jax_sample(m, jax_create_grid(bounds, res), bounds_raw)
    got = sample_mask_on_grid(m, create_grid(bounds, res), bounds_raw)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("step,thickness", [(1, 1), (3, 2), (50, 2)])
def test_extract_boundary_particles_matches_jax(step, thickness):
    """The same coordinates in the same (np.where) order."""
    from ptv_interpolation_tpu.grid import (
        extract_boundary_particles as jax_extract)
    from ptv_interpolation_tpu_torch.grid import extract_boundary_particles
    fluid = _mask((18, 21, 16), 8)
    bounds = ((0, 16), (0, 21), (3, 21))
    want = jax_extract(fluid, bounds, sampling_step=step, thickness=thickness)
    got = extract_boundary_particles(fluid, bounds, sampling_step=step,
                                     thickness=thickness, device="cpu")
    assert len(got[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
