"""The port's ``run_pipeline`` against the JAX package's on the sphere-pack
dataset of ``tests/test_pipeline_e2e.py``: sibson, outlier filter on,
boundary particles, without and with divergence cleaning, and every other
interpolation method."""

import functools
import io
import os
import contextlib

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from ptv_interpolation_tpu.datasets import sphere_pack
from ptv_interpolation_tpu.io import load_velocity_field as jax_load_field
from ptv_interpolation_tpu.io.csvio import load_ptv_data as jax_load_csv
from ptv_interpolation_tpu.io.tiff import read_tiff as jax_read_tiff
from ptv_interpolation_tpu.pipeline import PipelineConfig as JaxConfig
from ptv_interpolation_tpu.pipeline import run_pipeline as jax_run_pipeline
from ptv_interpolation_tpu_torch import filtering as tf
from ptv_interpolation_tpu_torch.interpolate import dispatch as td
from ptv_interpolation_tpu_torch.io.csvio import save_ptv_data
from ptv_interpolation_tpu_torch.pipeline import PipelineConfig, run_pipeline
from ptv_interpolation_tpu_torch.utils import (StageTimings, capture,
                                               profiler_trace)

torch.set_num_threads(2)

# f32 sums in another order (brute-force kNN chunks, weight normalisation)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The sphere pack (48³, 4000 tracks, solid = 1 in the mask), with
    planted outliers: 6 tracks ×20 for the speed threshold, 4 ×8 for the
    kNN-MAD filter. (The pack's speeds are uniform, so MAD = 0 and every
    neighbour of an outlier sits inside the fused kernel's uncertainty
    band; 4 outliers keep that under the 5% the exact re-decide takes.)"""
    d = tmp_path_factory.mktemp("torch_sphere_pack")
    csv = str(d / "pts.csv")
    tif = str(d / "mask.tif")
    sphere_pack.generate(n_points=4000, size=48, filename=csv, maskname=tif,
                         voxel_units=True)
    cloud = jax_load_csv(csv)
    rng = np.random.default_rng(3)
    idx = rng.choice(len(cloud), 10, replace=False)
    vals = cloud.values.copy()
    vals[idx[:6]] *= 20.0
    vals[idx[6:]] *= 8.0
    from ptv_interpolation_tpu_torch.io.csvio import PointCloud
    save_ptv_data(csv, PointCloud(cloud.points, vals))
    return d, csv, tif


def _config(cls, csv, tif, **kw):
    return cls(**{**dict(input=csv, mask=tif, invert_mask=True,
                         method="sibson", sibson_neighbors=15,
                         filter_outliers=True, boundary_particles=True,
                         boundary_sampling=10, verbose=True), **kw})


def _run(fn, config, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(config, **kw)
    counts = [line.strip() for line in out.getvalue().splitlines()
              if any(w in line for w in ("Removed", "Added", "Points:",
                                         "Filtering radius"))]
    return result, counts


@functools.lru_cache(maxsize=None)
def _jax_result(csv, tif):
    return _run(jax_run_pipeline, _config(JaxConfig, csv, tif))


def test_run_pipeline_matches_jax(dataset):
    """Identical filtered and boundary counts (the verbose prints), mask,
    and u, v, w within rtol 1e-5 / atol 1e-6; solid nodes exactly 0; the
    NPZ and TIFF load with the JAX package's loaders to the same arrays."""
    d, csv, tif = dataset
    npz, out_tif = str(d / "port.npz"), str(d / "port.tif")
    want, want_counts = _jax_result(csv, tif)
    got, got_counts = _run(run_pipeline, _config(
        PipelineConfig, csv, tif, output_npz=npz, output_tif=out_tif),
        device="cpu")
    assert got_counts == want_counts
    assert any("Threshold Filter: Removed 6" in c for c in got_counts)
    assert any("Outlier Filter: Removed" in c for c in got_counts)
    assert any("Added" in c for c in got_counts)
    assert got.u.shape == (48, 48, 48)
    np.testing.assert_array_equal(got.mask, want.mask)
    for f in "xyz":
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in "uvw":
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL)
    solid = ~got.mask
    for f in "uvw":
        assert np.all(getattr(got, f)[solid] == 0.0)
    assert not got.has_dual

    back = jax_load_field(npz)
    for f in ("x", "y", "z", "u", "v", "w", "mask"):
        np.testing.assert_array_equal(getattr(back, f), getattr(got, f))
    stack = jax_read_tiff(out_tif)
    assert stack.shape == (48, 3, 48, 48)
    np.testing.assert_array_equal(stack[:, 0], got.u)
    np.testing.assert_array_equal(stack[:, 2], got.w)


def test_fused_routes_decide_as_the_exact_routes(dataset, monkeypatch):
    """With the port's size switches lowered, the filter takes the fused
    MAD route and the interpolation the fused grid route on the same
    data. Decisions equal the JAX package's exact (brute-force) routes.

    The field is held against the JAX package's grid route (forced with
    ``use_grid_kernel='always'``), within atol 1e-5: the boundary
    particles sit on the voxel lattice, so many grid nodes have ties at
    the k-th distance, and a τ-threshold route takes every tied candidate
    where exact top-k takes k of them."""
    import ptv_interpolation_tpu.pipeline as jax_pipeline
    d, csv, tif = dataset
    monkeypatch.setattr(tf, "_SCATTER_MIN_POINTS", 1000)
    monkeypatch.setattr(td, "_GRID_FASTPATH_MIN_WORK", 1)
    monkeypatch.setattr(td, "_GRID_FASTPATH_MIN_POINTS", 1000)
    from ptv_interpolation_tpu_torch.ops import fused_grid_knn, fused_mad
    calls = {"mad": 0, "grid": 0}
    mad_plain, grid_plain = (fused_mad._mad_eval_plain,
                             fused_grid_knn._fused_eval_plain)

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fused_mad, "_mad_eval_plain", count("mad", mad_plain))
    monkeypatch.setattr(fused_grid_knn, "_fused_eval_plain",
                        count("grid", grid_plain))
    with capture() as rec:
        got, got_counts = _run(run_pipeline,
                               _config(PipelineConfig, csv, tif),
                               device="cpu")
    assert calls["mad"] >= 1 and calls["grid"] >= 1
    assert rec.counters().get("filter.branch.exact_scatter") == 1

    _, exact_counts = _jax_result(csv, tif)
    # every count; the radius is the bisection's (k+1)-th distance there
    assert ([c for c in got_counts if "radius" not in c]
            == [c for c in exact_counts if "radius" not in c])
    assert any("Outlier Filter: Removed" in c for c in got_counts)
    monkeypatch.setattr(jax_pipeline, "interpolate_field", functools.partial(
        jax_pipeline.interpolate_field, use_grid_kernel="always"))
    want, want_counts = _run(jax_run_pipeline,
                             _config(JaxConfig, csv, tif))
    np.testing.assert_array_equal(got.mask, want.mask)
    for f in "uvw":
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-5)


def _cleaning_report(lines):
    """The cleaning stage's printed lines, from its announcement to the
    report's closing rule."""
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("Applying divergence cleaning"))
    end = max(i for i, line in enumerate(lines) if line.startswith("===="))
    return lines[start:end + 1]


@functools.lru_cache(maxsize=None)
def _jax_cleaned(csv, tif, method):
    out = []
    lines = fx.printed_lines(lambda: out.append(jax_run_pipeline(
        _cleaning_config(JaxConfig, csv, tif, method))))
    return out[0], _cleaning_report(lines)


def _cleaning_config(cls, csv, tif, method, **kw):
    return _config(cls, csv, tif, divergence_free=True,
                   cleaning_method=method, cleaning_lambda=200.0,
                   iterations=2, **kw)


@pytest.mark.parametrize("method", ["projection", "variational"])
def test_run_pipeline_with_cleaning_matches_jax(dataset, method):
    """``divergence_free=True``: the field before cleaning (``u_init…``)
    within rtol 1e-5 / atol 1e-6 of the JAX package's, the cleaned field
    within 1e-5 relative L2, the verbose cleaning report line for line,
    the ``clean_divergence`` stage timed, solid nodes exactly 0, and the
    NPZ holding both fields."""
    d, csv, tif = dataset
    npz = str(d / f"clean_{method}.npz")
    want, want_report = _jax_cleaned(csv, tif, method)
    timings = StageTimings()
    out = []
    lines = fx.printed_lines(lambda: out.append(run_pipeline(
        _cleaning_config(PipelineConfig, csv, tif, method, output_npz=npz),
        timings=timings, device="cpu")))
    got = out[0]
    fx.assert_reports_match(_cleaning_report(lines), want_report)
    assert "clean_divergence" in timings.stages
    assert got.has_dual and want.has_dual
    for f in ("u", "v", "w"):
        np.testing.assert_allclose(getattr(got, f + "_init"),
                                   getattr(want, f + "_init"),
                                   rtol=RTOL, atol=ATOL)
        g, w = (getattr(r, f).astype(np.float64) for r in (got, want))
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
    solid = ~got.mask
    for f in ("u", "v", "w", "u_init", "v_init", "w_init"):
        assert np.all(getattr(got, f)[solid] == 0.0)
        assert np.isfinite(getattr(got, f)).all()
    back = jax_load_field(npz)
    assert back.has_dual
    for f in ("u", "v", "w", "u_init", "v_init", "w_init", "mask"):
        np.testing.assert_array_equal(getattr(back, f), getattr(got, f))


# method → config keywords, its k, and (rtol, atol). Linear is the same
# host Qhull and scipy walk on both sides, so bit for bit; nearest picks
# the same points; the weighted sums and local RBF solves round in another
# order, and the local fits among lattice-placed boundary particles are
# ill-conditioned (one cubic node differs by 5.4e-5, hence atol 1e-4 for
# the RBF methods). The kNN methods run at downscale 2 (24³ nodes) to keep
# the CPU time small.
_PIPELINE_METHODS = {
    "linear": (dict(), None, (0, 0)),
    "nearest": (dict(downscale=2.0), 1, (0, 0)),
    "idw": (dict(downscale=2.0, idw_neighbors=12), 12, (1e-5, 1e-6)),
    "rbf": (dict(downscale=2.0), 20, (1e-4, 1e-4)),
    "cubic_fallback": (dict(downscale=2.0, method="cubic",
                            cubic_fallback=True, rbf_neighbors=12), 12,
                       (1e-4, 1e-4)),
}


def _ambiguous_nodes(points, grid, nodes, k):
    """Of the flat grid ``nodes``, those whose k nearest points are not
    well defined at f32 precision: the k-th and (k+1)-th distances (f64)
    within 1e-5 relative. Brute force selects by the matmul expansion of
    d², whose f32 noise decides there, and the boundary particles sit on
    a lattice, where many such ties are exact."""
    q = grid.flat_coords("cpu").numpy()[nodes].astype(np.float64)
    p = np.asarray(points, np.float64)
    d = np.sort(np.sqrt(((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)),
                axis=1)
    return (d[:, k] - d[:, k - 1]) <= 1e-5 * d[:, k - 1]


@pytest.mark.parametrize("name", sorted(_PIPELINE_METHODS))
def test_run_pipeline_methods_match_jax(dataset, name, monkeypatch):
    """``run_pipeline`` with each interpolation method against the JAX
    package's on the sphere pack (outlier filter, boundary particles):
    the same counts and mask; u, v, w within the method's tolerance at
    every node but those whose k-set is ambiguous at f32 precision
    (:func:`_ambiguous_nodes`, at most 0.2% of them); the solid exactly 0
    and every value finite (non-finite values become 0, as in JAX)."""
    import ptv_interpolation_tpu_torch.pipeline as tpipeline
    d, csv, tif = dataset
    kw, k, (rtol, atol) = _PIPELINE_METHODS[name]
    kw = {"method": name, **kw}
    seen = {}
    interp = tpipeline.interpolate_field

    def grab(points, values, grid, **kwargs):
        seen["points"], seen["grid"] = np.asarray(points), grid
        return interp(points, values, grid, **kwargs)

    monkeypatch.setattr(tpipeline, "interpolate_field", grab)
    want, want_counts = _run(jax_run_pipeline, _config(JaxConfig, csv, tif,
                                                       **kw))
    got, got_counts = _run(run_pipeline, _config(PipelineConfig, csv, tif,
                                                 **kw), device="cpu")
    assert got_counts == want_counts
    np.testing.assert_array_equal(got.mask, want.mask)
    off = np.zeros(got.mask.shape, bool)
    for f in "uvw":
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.all(g[~got.mask] == 0.0)
        off |= ~np.isclose(g, w, rtol=rtol, atol=atol)
    nodes = np.flatnonzero(off)
    assert len(nodes) <= 0.002 * off.size
    if len(nodes):
        assert k is not None
        assert _ambiguous_nodes(seen["points"], seen["grid"], nodes, k).all()
    assert np.abs(got.w[got.mask]).max() > 0.5


@pytest.mark.parametrize("kw,error,match", [
    (dict(method="cubic"), ValueError, "2D-only"),
    (dict(method="kriging"), ValueError, "unknown interpolation method"),
])
def test_unported_stages_raise(dataset, kw, error, match):
    """What still raises, as in the JAX package: 'cubic' without
    ``cubic_fallback`` and an unknown method."""
    d, csv, tif = dataset
    config = _config(PipelineConfig, csv, tif, **kw)
    with pytest.raises(error, match=match):
        run_pipeline(config, device="cpu")


def test_cuda_without_a_card_raises(dataset):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card behaviour cannot show")
    d, csv, tif = dataset
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        run_pipeline(_config(PipelineConfig, csv, tif))


def test_stage_names_and_profiler_trace(dataset, tmp_path):
    """The stage timings carry the JAX package's stage names; a profile
    directory receives a Chrome trace."""
    d, csv, tif = dataset
    cloud = jax_load_csv(csv)
    from ptv_interpolation_tpu_torch.io import PointCloud
    timings = StageTimings()
    rng = np.random.default_rng(0)
    sub = rng.choice(len(cloud), 1500, replace=False)
    config = _config(PipelineConfig, csv, tif, downscale=4.0)
    config.verbose = False
    run_pipeline(config, cloud=PointCloud(cloud.points[sub],
                                          cloud.values[sub]),
                 timings=timings, profile_dir=str(tmp_path / "prof"),
                 device="cpu")
    assert list(timings.stages) == ["load_mask", "prepare_domain",
                                    "filter_outliers", "sample_mask",
                                    "boundary_particles", "interpolate"]
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with profiler_trace(None):
        pass
