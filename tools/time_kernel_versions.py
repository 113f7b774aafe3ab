#!/usr/bin/env python
"""Time the port's CUDA kernels of several checkouts of this repository in
turns, on one NVIDIA GPU, on the same inputs.

Usage, from the repository root, with an older commit unpacked into a
git-ignored directory::

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python tools/time_kernel_versions.py [--measure grid,mad,pipeline,pallas] \\
        [--out FILE] _archive/parent . . _archive/parent

Each argument is a checkout; one worker process per argument, in the order
given, imports that checkout's ``ptv_interpolation_tpu_torch`` and
``bench`` (and, for the problems and the timer, the ``chip_smoke.py`` that
sits beside this tool), builds that checkout's kernels, captures each
kernel's arguments from one call of the entry point a user makes, and
times the kernel with CUDA events after a warm-up
(``chip_smoke._cuda_ms``). The measures:

* ``grid``: kernel 1 (``fused_grid_knn.cu``) on the headline's main-pass
  panel (``bench.make_problem``: 1M points → 256³, sibson k=50, block
  (8,8,16)) and on its fused repair's panel (the second launch, at 1.6×
  the margin), 5 launches each; the headline wall,
  ``sibson_grid_interpolate(..., device="cuda")``, median of 3 warm runs;
* ``mad``: kernel 2 (``fused_mad.cu``) on the production filter panel
  (``chip_smoke``'s production shape, k=30), 5 launches;
* ``pipeline``: kernel 1 on the pipeline's main-pass panel, 5 launches;
  the pipeline wall, ``run_pipeline(..., device="cuda")``, median of 3
  warm runs;
* ``pallas``: kernel 3 (``pallas_grid_knn.cu``) on ``chip_smoke`` phase
  7's slice of 1 024 headline blocks, 5 launches, and on every block, 2
  launches, with a digest of each and, where the checkout's wrapper keeps
  one, the count of nodes that overflowed their shortlist (and, for every
  measure, the kernel's counters where the checkout records them).

Each worker also prints digests of the kernels' outputs (sums and
uncovered counts, and for kernel 1 a SHA-1 of its output's bytes), which
agree between checkouts whose kernels compute the same function. One JSON line per worker goes to standard output, then a
table of the times; ``--out FILE`` also writes all the lines to FILE as a
JSON list.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEASURES = ("grid", "mad", "pipeline", "pallas")
KERNELS = {"grid": "fused_grid_knn", "pipeline": "fused_grid_knn",
           "mad": "fused_mad", "pallas": "pallas_grid_knn"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _all_calls(module, name, fn):
    """The positional arguments of every call that ``fn()`` makes to the
    kernel wrapper ``module.<name>``, in order."""
    seen = []
    orig = getattr(module, name)

    def grab(*a):
        seen.append(a)
        return orig(*a)

    setattr(module, name, grab)
    try:
        fn()
    finally:
        setattr(module, name, orig)
    return seen


def _wall(torch, fn, runs=3):
    import numpy as np
    walls = []
    fn()
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), walls


def _sha1(out):
    """SHA-1 of a kernel's output bytes: equal only where every bit is."""
    import hashlib
    return hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()


def _time_kernel(torch, cs, res, key, wrapper, args, reps=5):
    """Time ``wrapper(*args)``; record its overflow count where it keeps
    one (the ``kernel<n>.overflow`` counter, or the ``last_overflow``
    attribute of trees that predate the counters), and return one output
    for the digest."""
    res[f"{key}_ms"] = cs._cuda_ms(torch, lambda: wrapper(*args), reps)
    utils = sys.modules.get("ptv_interpolation_tpu_torch.utils")
    if hasattr(utils, "capture"):
        with utils.capture() as rec:
            out = wrapper(*args)
        counts = rec.counters()
        res[f"{key}_counters"] = counts
        ovf = next((n for name, n in counts.items()
                    if name.endswith(".overflow")), None)
    else:
        out = wrapper(*args)
        ovf = getattr(wrapper, "last_overflow", None)
    res[f"{key}_overflow"] = None if ovf is None else int(ovf)
    return out


def worker(tree, measures):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    cs = _chip_smoke()
    from bench import GRID_N, K, make_problem
    from ptv_interpolation_tpu_torch import pipeline
    from ptv_interpolation_tpu_torch.grid import create_grid
    from ptv_interpolation_tpu_torch.interpolate import (
        sibson_grid_interpolate)
    from ptv_interpolation_tpu_torch.io import PointCloud
    from ptv_interpolation_tpu_torch.ops import cuda_build
    from ptv_interpolation_tpu_torch.ops import fused_grid_knn as fg
    from ptv_interpolation_tpu_torch.ops import fused_mad as fm
    from ptv_interpolation_tpu_torch.ops import pallas_grid_knn as pg

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"tree": os.path.abspath(tree),
           "device": torch.cuda.get_device_name(0)}
    res["smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for name in sorted({KERNELS[m] for m in measures}):
        cuda_build.build_library(name)
        log = (cuda_build.BUILD_DIR / f"{name}.log").read_text()
        res[f"{name}_ptxas"] = [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]

    if "grid" in measures or "pallas" in measures:
        pts, vals = make_problem()
        grid = create_grid(((0, GRID_N + 1),) * 3, GRID_N)
    if "grid" in measures:
        def headline():
            return sibson_grid_interpolate(pts, vals, grid, k=K,
                                           tau_mode="bisect", block=cs.BLOCK,
                                           device="cuda")

        calls = _all_calls(fg, "_fused_eval", headline)
        for key, args in zip(("grid_headline", "grid_repair"), calls):
            out = _time_kernel(torch, cs, res, key, fg._fused_eval, args)
            res[f"{key}_digest"] = [float(out[:, :, :3].double().sum()),
                                    int((out[:, :, 3] == 0).sum())]
            res[f"{key}_sha1"] = _sha1(out)
            del args, out
        del calls
        res["headline_wall_s"], res["headline_walls"] = _wall(torch, headline)
    if "pallas" in measures:
        full = cs._captured(pg, "_pallas_eval", lambda: sibson_grid_interpolate(
            pts, vals, grid, k=K, backend="pallas", device="cuda"))
        out = _time_kernel(torch, cs, res, "pallas_slice", pg._pallas_eval,
                           cs._pallas_slice(full))
        res["pallas_slice_digest"] = [float(out[..., :3].double().sum()),
                                      float(out[..., 3].double().sum())]
        del out
        out = _time_kernel(torch, cs, res, "pallas_all", pg._pallas_eval,
                           full, reps=2)
        res["pallas_all_digest"] = [float(out[..., :3].double().sum()),
                                    float(out[..., 3].double().sum())]
        del out, full
    if "grid" in measures or "pallas" in measures:
        del pts, vals

    if "mad" in measures or "pipeline" in measures:
        fluid, ppts, pvals, _, _ = cs.make_pipeline_problem()
    if "mad" in measures:
        cloud, _ = cs._filter_input(fluid, ppts, pvals)
        args = cs._captured_mad_eval(cloud, 30)
        out = _time_kernel(torch, cs, res, "mad", fm._mad_eval, args)
        res["mad_digest"] = [float(out[:, 0].double().sum()),
                             float(out[:, 2:4].double().sum())]
        del out, args
    if "pipeline" in measures:
        config = cs.pipeline_config()

        def run():
            return pipeline.run_pipeline(config, cloud=PointCloud(ppts, pvals),
                                         mask_raw=fluid, device="cuda")

        args = cs._captured(fg, "_fused_eval", run)
        out = _time_kernel(torch, cs, res, "grid_pipeline", fg._fused_eval,
                           args)
        res["grid_pipeline_digest"] = [float(out[:, :, :3].double().sum()),
                                       int((out[:, :, 3] == 0).sum())]
        res["grid_pipeline_sha1"] = _sha1(out)
        del out, args
        res["pipeline_wall_s"], res["pipeline_walls"] = _wall(torch, run)
    print(json.dumps(res), flush=True)


def main(trees, measures, out=None):
    results = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             ",".join(measures)],
            capture_output=True, text=True, timeout=1200, check=False)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"worker for {tree} failed "
                             f"(exit {proc.returncode})")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    keys = [k for k in ("grid_headline_ms", "grid_repair_ms",
                        "headline_wall_s", "mad_ms",
                        "grid_pipeline_ms", "pipeline_wall_s",
                        "pallas_slice_ms", "pallas_all_ms")
            if k in results[0]]
    print("tree | " + " | ".join(keys))
    for r in results:
        print(f"{r['tree']} | " + " | ".join(f"{r[k]:.4f}" for k in keys))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3].split(","))
    else:
        import argparse
        ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
        ap.add_argument("trees", nargs="+", help="checkouts, timed in order")
        ap.add_argument("--measure", default=",".join(MEASURES),
                        help=f"comma-separated subset of {','.join(MEASURES)}")
        ap.add_argument("--out", help="also write the results here (JSON)")
        args = ap.parse_args()
        measures = args.measure.split(",")
        unknown = set(measures) - set(MEASURES)
        if unknown:
            ap.error(f"unknown measures {sorted(unknown)}")
        main(args.trees, measures, args.out)
