"""Run one benchmark run with the program's timed path broken.

    python fault_run.py <checkout> <fault> <run.py arguments>

The faults, each patched into the port before the run starts:

- ``clean_unchanged``: the cleaning step returns its input unchanged;
- ``filter_unchanged``: the outlier filter returns its input unchanged;
- ``half_tracks``: the interpolation leaves out every other track and
  weighs the rest;
- ``answer_altered``: one answer, a node value of the interpolated field,
  is changed where it is produced.
"""

import sys
from pathlib import Path


def install(fault):
    import torch

    import ptv_interpolation_tpu_torch.interpolate as interp
    from ptv_interpolation_tpu_torch import pipeline

    if fault == "clean_unchanged":
        def clean(u, v, w, *a, device="cuda", **kw):
            return tuple(torch.as_tensor(x, device=device) for x in (u, v, w))
        pipeline.clean_divergence = clean
        return
    if fault == "filter_unchanged":
        pipeline.apply_filters = lambda cloud, *a, **kw: cloud
        return
    original = interp.interpolate_field

    def broken(points, values, grid, skip_mask=None, **kw):
        if fault == "half_tracks":
            return original(points[::2], values[::2], grid,
                            skip_mask=skip_mask, **kw)
        u, v, w = original(points, values, grid, skip_mask=skip_mask, **kw)
        needed = (torch.ones(grid.shape, dtype=torch.bool)
                  if skip_mask is None else ~torch.as_tensor(skip_mask))
        idx = torch.nonzero(needed.reshape(-1)).squeeze(1)
        node = int(idx[len(idx) // 2])
        u = u.clone()
        u.view(-1)[node] += 1.0
        return u, v, w

    if fault not in ("half_tracks", "answer_altered"):
        raise ValueError(f"unknown fault {fault!r}")
    interp.interpolate_field = broken
    pipeline.interpolate_field = broken


def main():
    root, fault, argv = Path(sys.argv[1]).resolve(), sys.argv[2], sys.argv[3:]
    sys.path.insert(0, str(root))
    from perfbench import run
    install(fault)
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
