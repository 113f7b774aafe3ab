#!/usr/bin/env python
"""Run ``chip_smoke.py`` phase 14 alone on NVIDIA GPUs: the sharded grid
path, z-sharded cleaning, the sharded query path, ``make_pipeline_step``
and the dry run, with the inputs the earlier phases would give it.

Usage, from the repository root::

    python3 tools/chip_phase14.py            # one card: a 1-rank (NCCL) and a 2-rank (gloo) world
    python3 tools/chip_phase14.py 1 4        # four cards: a 1-rank and a 4-rank world, NCCL
    python3 tools/chip_phase14.py --step-n 128   # make_pipeline_step at 128³ (phase 14: 64³)

It builds the kernels (phase 2), runs the headline on one device (phase
4: its wall, field and f64 reference), runs the production configuration
once (phase 10's ``run_pipeline`` with variational cleaning at λ = 200 on
phase 6's problem) to save the cleaning's input and one-device result,
then runs phase 14 over the worlds given. Every gate of phase 14 holds;
the exit code is non-zero when one fails.
"""

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main(argv):
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("worlds", type=int, nargs="*", default=[1, 2],
                        help="ranks of each world (default: 1 2)")
    parser.add_argument("--step-n", type=int, default=cs.STEP_N,
                        help="make_pipeline_step's grid edge, at phase 9's "
                             "density")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_phase14: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    worlds = tuple(args.worlds)
    t0 = time.perf_counter()
    cs.phase_environment(torch)
    cs.phase_build()
    from bench import GRID_N, K, make_problem
    from ptv_interpolation_tpu_torch import physics, pipeline
    from ptv_interpolation_tpu_torch.grid import create_grid
    from ptv_interpolation_tpu_torch.io import PointCloud

    pts, vals = make_problem()
    grid = create_grid(((0, GRID_N + 1),) * 3, GRID_N)
    _, wall, out, ref = cs.phase_main_path(torch, pts, vals, grid, K)
    del pts, vals
    fluid, pts, vals = cs.make_pipeline_problem()[:3]
    config = cs.pipeline_config(divergence_free=True,
                                cleaning_method="variational",
                                cleaning_lambda=cs.CLEAN_LAMBDA, iterations=5)
    calls = []
    variational = physics.clean_divergence_variational

    def grab(*a, **kw):
        calls.append((a, variational(*a, **kw)))
        return calls[-1][1]

    physics.clean_divergence_variational = grab
    try:
        pipeline.run_pipeline(config, cloud=PointCloud(pts, vals),
                              mask_raw=fluid, device="cuda")
    finally:
        physics.clean_divergence_variational = variational
    del fluid, pts, vals
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        cs.save_cleaning(workdir, *calls[0])
        launches = cs.phase_sharded(torch, wall, out, ref, workdir, worlds,
                                    args.step_n)
    cs.log(f"phase 14: kernel 1 launches over every rank {launches}; "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
