"""End-to-end interpolation pipeline on one device.

Counterpart of ``ptv_interpolation_tpu/pipeline.py``, stage for stage:
CSV load → alignment transforms → mask load/crop → domain and outlier
filtering → grid construction → boundary particles → interpolation →
mask zeroing → divergence cleaning (``divergence_free``, projection or
variational) → NPZ/TIFF artifacts. Every ``method`` of the config runs:
linear (the default), nearest, rbf (local or global), idw, sibson, and
cubic as local RBF under ``cubic_fallback``.

Host code handles I/O and the dynamic-shape compactions (the cloud is a
host :class:`PointCloud`, the mask a numpy array); the numeric stages run
on ``device`` and hand back host arrays. The result is a
:class:`FieldResult` of numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.filtering import FilterConfig, apply_filters
from ptv_interpolation_tpu_torch.grid import (create_grid,
                                              extract_boundary_particles,
                                              sample_mask_on_grid)
from ptv_interpolation_tpu_torch.interpolate.dispatch import (
    interpolate_field)
from ptv_interpolation_tpu_torch.io import (FieldResult, PointCloud,
                                            load_mask, load_ptv_data,
                                            save_field_npz, save_field_tiff)
from ptv_interpolation_tpu_torch.physics import clean_divergence


@dataclasses.dataclass
class PipelineConfig:
    """Typed mirror of the reference CLI: the JAX package's fields and
    defaults."""

    input: str = ""
    mask: Optional[str] = None
    downscale: float = 1.0
    divergence_free: bool = False
    iterations: int = 3                       # --iter
    cleaning_method: str = "projection"
    cleaning_lambda: float = 1000.0
    output_tif: Optional[str] = None
    output_npz: Optional[str] = None
    crop: Optional[Sequence[int]] = None      # xmin xmax ymin ymax zmin zmax
    method: str = "linear"
    rbf_neighbors: int = 20
    rbf_kernel: str = "thin_plate_spline"
    smoothing: float = 0.0
    idw_power: float = 2.0
    idw_neighbors: int = 50
    sibson_neighbors: int = 30
    cubic_fallback: bool = False
    # k-th-distance selection of the grid kernel: 'bisect' (exact, the
    # default and the one ported)
    tau_mode: str = "bisect"
    boundary_particles: bool = False
    boundary_sampling: int = 1
    boundary_thickness: int = 1
    filter_outliers: bool = False
    filter_neighbors: int = 25
    filter_threshold: float = 3.0
    filter_max_speed: float = 10.0
    no_plot: bool = True
    invert_mask: bool = False
    data_offset: Optional[Tuple[float, float, float]] = None
    swap_xy: bool = False
    mask_transpose: Optional[Tuple[int, int, int]] = None
    verbose: bool = True
    tri_cache_dir: Optional[str] = None


def prepare_domain(config: PipelineConfig, cloud: PointCloud,
                   mask_raw: Optional[np.ndarray]):
    """Mask handling and domain definition: transpose, invert and crop the
    mask, derive bounds and resolution (from the mask, else from the
    data's extent), and clip the cloud to the bounds.

    Returns ``(cloud, mask_raw, bounds, resolution)``."""
    v = config.verbose
    bounds = None
    resolution = None
    if mask_raw is not None:
        if config.mask_transpose:
            if v:
                print(f"Transposing mask with axes {tuple(config.mask_transpose)}...")
            mask_raw = np.transpose(mask_raw, axes=config.mask_transpose)
        if config.invert_mask:
            if v:
                print("Inverting mask...")
            mask_raw = ~mask_raw
        if config.crop:
            xs, xe, ys, ye, zs, ze = config.crop
            if v:
                print(f"Cropping mask to X[{xs}:{xe}], Y[{ys}:{ye}], Z[{zs}:{ze}]...")
            mask_raw = mask_raw[zs:ze, ys:ye, xs:xe]
            bounds = ((xs, xe), (ys, ye), (zs, ze))
        else:
            nz, ny, nx = mask_raw.shape
            bounds = ((0, nx), (0, ny), (0, nz))
        nz, ny, nx = mask_raw.shape
        resolution = (
            max(1, int(round(nx / config.downscale))),
            max(1, int(round(ny / config.downscale))),
            max(1, int(round(nz / config.downscale))),
        )
    if bounds is None:
        # data-extent fallback; +1 because create_grid uses xmax-1
        xmin, xmax = float(cloud.x.min()), float(cloud.x.max())
        ymin, ymax = float(cloud.y.min()), float(cloud.y.max())
        zmin, zmax = float(cloud.z.min()), float(cloud.z.max())
        bounds = ((xmin, xmax + 1), (ymin, ymax + 1), (zmin, zmax + 1))
        resolution = max(1, int(round(64 / config.downscale)))

    if config.verbose:
        print("Filtering PTV data to domain bounds...")
    n0 = len(cloud)
    cloud = cloud.clip_to_bounds(bounds)
    if config.verbose:
        print(f"Points: {n0} -> {len(cloud)}")
    return cloud, mask_raw, bounds, resolution


def run_pipeline(config: PipelineConfig,
                 cloud: Optional[PointCloud] = None,
                 mask_raw: Optional[np.ndarray] = None,
                 timings=None, profile_dir: Optional[str] = None,
                 device="cuda") -> FieldResult:
    """Run the interpolation pipeline on ``device``. ``cloud``/``mask_raw``
    may be passed directly; otherwise they load from the config's paths.
    Pass a :class:`ptv_interpolation_tpu_torch.utils.StageTimings` to
    collect per-stage wall-clock; ``profile_dir`` wraps the run in a
    ``torch.profiler`` trace written there."""
    from ptv_interpolation_tpu_torch.utils import StageTimings, profiler_trace

    dev = resolve_device(device)
    if timings is None:
        timings = StageTimings()
    with profiler_trace(profile_dir):
        result = _run_pipeline_stages(config, cloud, mask_raw, timings, dev)
    if config.verbose:
        print(timings.report())
    return result


def _run_pipeline_stages(config: PipelineConfig, cloud, mask_raw, timings,
                         dev) -> FieldResult:
    v = config.verbose
    T = timings.stage

    # 1. load data
    if cloud is None:
        if v:
            print(f"Loading data from {config.input}...")
        with T("load_csv"):
            cloud = load_ptv_data(config.input)
    if config.data_offset:
        ox, oy, oz = config.data_offset
        if v:
            print(f"Applying coordinate offset: x+={ox}, y+={oy}, z+={oz}")
        cloud = cloud.offset(ox, oy, oz)
    if config.swap_xy:
        if v:
            print("Swapping X and Y coordinates and velocities...")
        cloud = cloud.swap_xy()

    # 2. mask & domain
    if mask_raw is None and config.mask:
        if v:
            print(f"Loading mask from {config.mask}...")
        with T("load_mask"):
            mask_raw = np.asarray(load_mask(config.mask))
        if v:
            print(f"Loaded Mask Shape: {mask_raw.shape}")
    with T("prepare_domain"):
        cloud, mask_raw, bounds, resolution = prepare_domain(config, cloud, mask_raw)

    # 3. outlier filtering
    if config.filter_outliers:
        if v:
            print("Applying PTV data filtering...")
        fcfg = FilterConfig(filter_outliers=True,
                            filter_neighbors=config.filter_neighbors,
                            filter_threshold=config.filter_threshold,
                            filter_max_speed=config.filter_max_speed)
        with T("filter_outliers"):
            cloud = apply_filters(cloud, fcfg, verbose=v, device=dev)

    # 4. grid + mask resample
    if v:
        print(f"Creating grid with resolution {resolution}...")
    grid = create_grid(bounds, resolution)
    if mask_raw is not None:
        if v:
            print("Sampling mask onto interpolation grid...")
        with T("sample_mask"):
            mask = sample_mask_on_grid(mask_raw, grid, bounds)
    else:
        mask = np.zeros(grid.shape, dtype=bool)

    # 5. boundary particles
    if config.boundary_particles and mask_raw is not None:
        if v:
            print(f"Extracting virtual boundary particles (sampling step "
                  f"{config.boundary_sampling}, thickness {config.boundary_thickness})...")
        with T("boundary_particles"):
            bx, by, bz = extract_boundary_particles(
                mask_raw, bounds, sampling_step=config.boundary_sampling,
                thickness=config.boundary_thickness, device=dev)
        if len(bx) > 0:
            b_cloud = PointCloud.from_arrays(
                bx, by, bz, np.zeros_like(bx), np.zeros_like(by),
                np.zeros_like(bz))
            if v:
                print(f"  Added {len(b_cloud)} virtual boundary particles with zero velocity.")
            cloud = cloud.concat(b_cloud)
        elif v:
            print("  No boundary particles found (fluid everywhere or no fluid-solid interface).")

    # 6. interpolate
    if v:
        print(f"Interpolating using {config.method} method...")
    with T("interpolate"):
        U, V, W = interpolate_field(
            cloud.points, cloud.values, grid, method=config.method,
            rbf_neighbors=config.rbf_neighbors, rbf_kernel=config.rbf_kernel,
            smoothing=config.smoothing, idw_power=config.idw_power,
            idw_neighbors=config.idw_neighbors,
            sibson_neighbors=config.sibson_neighbors,
            cubic_fallback=config.cubic_fallback, verbose=v,
            tau_mode=config.tau_mode, tri_cache_dir=config.tri_cache_dir,
            # solid voxels are zeroed in step 7 — exact repair of uncovered
            # solid-interior nodes would be discarded work
            skip_mask=(~mask if mask_raw is not None else None), device=dev)
        U, V, W = (np.nan_to_num(a.cpu().numpy()) for a in (U, V, W))

    # 7. hard zero in solid
    if mask_raw is not None:
        if v:
            print("Applying mask zeroes (enforcing zero velocity in solid regions)...")
        solid = ~mask
        U[solid] = 0
        V[solid] = 0
        W[solid] = 0

    # 8. divergence cleaning; the result keeps the field before it
    U_init = V_init = W_init = None
    if config.divergence_free:
        U_init, V_init, W_init = U.copy(), V.copy(), W.copy()
        if v:
            print(f"Applying divergence cleaning ({config.cleaning_method})...")
        dx, dy, dz = grid.spacing
        clean_mask = mask if mask_raw is not None else np.ones(grid.shape, bool)
        with T("clean_divergence"):
            U, V, W = (a.cpu().numpy() for a in clean_divergence(
                U, V, W, clean_mask, dx, dy, dz,
                iterations=config.iterations,
                method=config.cleaning_method,
                lambda_reg=config.cleaning_lambda, verbose=v, device=dev))

    result = FieldResult(x=grid.x, y=grid.y, z=grid.z, u=U, v=V, w=W,
                         mask=mask, u_init=U_init, v_init=V_init,
                         w_init=W_init)

    # 9. artifacts
    if config.output_npz:
        if v:
            print(f"Saving npz to {config.output_npz}...")
        save_field_npz(config.output_npz, result)
    if config.output_tif:
        if v:
            print(f"Saving TIFF to {config.output_tif}...")
        save_field_tiff(config.output_tif, U, V, W)

    return result
