#!/usr/bin/env python
"""Profile the PyTorch port's pipeline on one NVIDIA GPU.

Runs ``run_pipeline(..., device="cuda")`` on the production-shape problem
of ``chip_smoke.py`` phase 6 (a 486×336×322 raw mask, 650 000 tracks,
downscale 2, MAD filter k=30, boundary particles, sibson k=50) once to
warm up, then once under ``torch.profiler`` with CPU and CUDA activities.
Prints the stage walls, the device time by kernel name, the run's wall,
the device's busy and idle share of that wall (kernels of the one stream
do not overlap, so busy time is the sum of their device times); then,
from one more run without the profiler, the walls of the layers inside
the filter and interpolate stages (each between two synchronisations)
and how many grid nodes reach repair and which stage of the repair ladder
serves them. ``--trace FILE`` also writes the
Chrome trace.

    python tools/profile_torch_pipeline.py [--trace trace.json]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write the Chrome trace to this file")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    from chip_smoke import make_pipeline_problem, pipeline_config
    from ptv_interpolation_tpu_torch.io import PointCloud
    from ptv_interpolation_tpu_torch.interpolate import knn_weights
    from ptv_interpolation_tpu_torch.ops import (fused_grid_knn, fused_mad,
                                                 grid_knn)
    from ptv_interpolation_tpu_torch.pipeline import run_pipeline
    from ptv_interpolation_tpu_torch.utils import StageTimings, capture

    fluid, pts, vals, _, _ = make_pipeline_problem()
    config = pipeline_config()

    def run(timings=None):
        return run_pipeline(config, cloud=PointCloud(pts, vals),
                            mask_raw=fluid, timings=timings, device="cuda")

    run()
    torch.cuda.synchronize()

    # walls of the layers inside the filter and interpolate stages, each
    # between two synchronisations, and how many nodes reach repair
    walls, nodes = {}, []
    patches = []

    def timed(module, name, label):
        orig = getattr(module, name)

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                torch.cuda.synchronize()
                walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0

        patches.append((module, name, orig))
        setattr(module, name, wrapper)

    timed(fused_mad, "fused_mad_filter", "filter: fused_mad_filter")
    timed(fused_mad, "_mad_eval", "filter: MAD kernel launch")
    timed(grid_knn, "scatter_knn_apply", "filter: exact scatter re-decide")
    timed(fused_grid_knn, "fused_grid_weighted_interpolate",
          "interpolate: fused grid path")
    timed(fused_grid_knn, "_fused_eval_cells",
          "interpolate: grid kernel launch")
    timed(fused_grid_knn, "repair_empty_nodes", "interpolate: repair")
    timed(grid_knn, "_celllist_repair_eval_csr",
          "interpolate: repair, cell-list stage")
    timed(knn_weights, "sibson_interpolate",
          "interpolate: repair, brute-force stage")
    fused_repair = fused_grid_knn.fused_repair

    def count_fused(field, den, skip, *a, **kw):
        n = den == 0.0
        if skip is not None:
            n &= ~torch.as_tensor(skip, dtype=torch.bool, device=den.device)
        res = fused_repair(field, den, skip, *a, **kw)
        nodes.append((int(n.sum()), "declined" if res is None else
                      f"{res[2]} left for brute force"))
        return res

    patches.append((fused_grid_knn, "fused_repair", fused_repair))
    fused_grid_knn.fused_repair = count_fused
    timings = StageTimings()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(timings)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the same layers once more without the profiler
        walls.clear()
        nodes.clear()
        with capture() as rec:
            run()
    finally:
        for module, name, orig in reversed(patches):
            setattr(module, name, orig)

    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=25))
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(timings.report())
    print("layer walls, synchronised, in a run without the profiler: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in walls.items()))
    print(f"repair: uncovered fluid nodes and the fused stage's verdict "
          f"{nodes}; nodes served by each stage of the ladder "
          f"{ {k: v for k, v in rec.counters().items() if 'repair' in k} }")
    print(f"{torch.cuda.get_device_name(0)}: wall {wall:.4f} s (profiled), "
          f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall:.1%}, "
          f"idle {1 - busy_us / 1e6 / wall:.1%}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()
