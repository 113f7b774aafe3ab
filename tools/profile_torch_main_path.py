#!/usr/bin/env python
"""Profile the PyTorch port's headline main path on one NVIDIA GPU.

Runs ``sibson_grid_interpolate`` (1M points → 256³, k=50, block (8,8,16),
``bench.make_problem``) once to warm up, then once under
``torch.profiler`` with CPU and CUDA activities, and prints the device time
by kernel name, the run's wall, and the device's busy and idle share of
that wall (kernels of the one stream do not overlap, so busy time is the
sum of their device times). ``--trace FILE`` also writes the Chrome trace.

    python tools/profile_torch_main_path.py [--trace trace.json]
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
    from bench import GRID_N, K, make_problem
    from ptv_interpolation_tpu_torch.grid import create_grid
    from ptv_interpolation_tpu_torch.interpolate import (
        sibson_grid_interpolate)

    pts, vals = make_problem()
    grid = create_grid(((0, GRID_N + 1),) * 3, GRID_N)
    kw = dict(k=K, tau_mode="bisect", block=(8, 8, 16), device="cuda")
    sibson_grid_interpolate(pts, vals, grid, **kw)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sibson_grid_interpolate(pts, vals, grid, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=20))
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{torch.cuda.get_device_name(0)}: wall {wall:.4f} s (profiled), "
          f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall:.1%}, "
          f"idle {1 - busy_us / 1e6 / wall:.1%}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()
