#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, the CUDA toolkit's ``nvcc`` and scipy, and never
imports JAX. Phases, each printing its own lines; every failure raises and
the script exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off;
2. build: the fused grid kNN kernel from ``ptv_interpolation_tpu_torch/ops/
   csrc/fused_grid_knn.cu`` with ``nvcc`` (timed, counted as set-up);
3. kernel against its plain PyTorch version on the headline problem
   (``bench.make_problem``: 1M points → 256³, k=50, block (8,8,16)): on a
   subset of blocks with the corner and edge blocks, sibson and IDW, then
   over the full panel (16 384 blocks × 4 sub-tiles), timed;
4. the main path: ``sibson_grid_interpolate(..., device="cuda")`` — one
   warm-up and 3 timed runs, the kernel's launch counts for the main pass
   and for repair, peak memory, a stage-by-stage breakdown, and relative
   L2 against the f64 scipy reference on 20k interior nodes and on 4k
   nodes of the faces, edges and corners (served by repair).

The second-to-last line of standard output is the kernels' JSON record,
the last line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BLOCK = (8, 8, 16)
RTOL, ATOL = 1e-5, 1e-6    # summation order and expf differ; d², τ² bit-equal
L2_LIMIT = 1e-6


def log(msg=""):
    print(msg, flush=True)


def phase_environment(torch):
    log("== 1. environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} × {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from ptv_interpolation_tpu_torch.ops import cuda_build, fused_grid_knn
    log("== 2. build")
    t0 = time.perf_counter()
    fused_grid_knn._kernel_lib()
    secs = time.perf_counter() - t0
    log(f"fused_grid_knn.cu built and loaded in {secs:.2f} s")
    build_log = cuda_build.BUILD_DIR / "fused_grid_knn.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "ptxas" in line:
                log(f"  {line.strip()}")
    return secs


def _cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare(torch, got, want, V, what):
    den_got, den_want = got[:, :, V], want[:, :, V]
    if not torch.equal(den_got == 0, den_want == 0):
        n = int(((den_got == 0) != (den_want == 0)).sum())
        raise AssertionError(f"{what}: den==0 pattern differs at {n} nodes")
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        bad = ~torch.isclose(got, want, rtol=RTOL, atol=ATOL)
        raise AssertionError(f"{what}: {int(bad.sum())} values outside "
                             f"rtol {RTOL} atol {ATOL}")
    err = float((got - want).abs().max())
    log(f"  {what}: den==0 identical ({int((den_got == 0).sum())} "
        f"uncovered), max |kernel - plain| = {err:.3e}")
    return err


def phase_kernel(torch, pts, vals, grid, k):
    from ptv_interpolation_tpu_torch.ops import fused_grid_knn as fg
    from ptv_interpolation_tpu_torch.ops.grid_knn import _host_setup
    log("== 3. kernel against its plain version")
    dev = torch.device("cuda")
    cells, values_sorted, axes, margin, mc, _, _ = _host_setup(
        pts, vals, grid, k, BLOCK, 1.45, cell_divisor=3.0, device=dev)
    C = fg._panel_width(fg._block_total_capacity(cells, axes, margin, BLOCK,
                                                 grid.shape, mc))
    dims = tuple(-(-n // b) for n, b in zip(grid.shape, BLOCK))
    sz = fg._pick_sz(*BLOCK)
    V = vals.shape[1]
    m2 = np.float32(margin * margin)
    n_blocks = int(np.prod(dims))
    log(f"  headline panel: {n_blocks} blocks × {BLOCK[0] // sz} sub-tiles "
        f"of {sz * BLOCK[1] * BLOCK[2]} nodes, C = {C}, margin = {margin:.4f}")

    # corner and edge blocks (where coverage fails) plus random interior ones
    nbz, nby, nbx = dims
    corners = [(z, y, x) for z in (0, nbz - 1) for y in (0, nby - 1)
               for x in (0, nbx - 1)]
    edges = [(0, 0, x) for x in range(nbx)] + [(z, nby - 1, 0)
                                               for z in range(nbz)]
    rng = np.random.default_rng(7)
    interior = rng.integers(1, n_blocks - 1, 200)
    ids = np.unique(np.concatenate([
        [(z * nby + y) * nbx + x for z, y, x in corners + edges], interior]))
    cand = fg._compact_gather(cells, values_sorted, axes, margin, BLOCK,
                              grid.shape, mc, C, ids=ids)
    q = fg._build_queries(axes, BLOCK, dims, sz, ids=ids, device=dev)
    errs = []
    for mode in ("sibson", "idw"):
        args = (m2, cand, *q, BLOCK, sz, k, V, C, mode, 2.0)
        got, want = fg._fused_eval(*args), fg._fused_eval_plain(*args)
        torch.cuda.synchronize()
        errs.append(_compare(torch, got, want, V,
                             f"{mode}, {len(ids)} blocks incl. corners/edges"))

    cand = fg._compact_gather(cells, values_sorted, axes, margin, BLOCK,
                              grid.shape, mc, C)
    q = fg._build_queries(axes, BLOCK, dims, sz, device=dev)
    args = (m2, cand, *q, BLOCK, sz, k, V, C, "sibson", 2.0)
    ms = _cuda_ms(torch, lambda: fg._fused_eval(*args), reps=5)
    plain_ms = _cuda_ms(torch, lambda: fg._fused_eval_plain(*args), reps=1)
    got, want = fg._fused_eval(*args), fg._fused_eval_plain(*args)
    torch.cuda.synchronize()
    errs.append(_compare(torch, got, want, V, "sibson, full headline panel"))
    log(f"  full panel, sibson: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return max(errs), ms, plain_ms


def phase_main_path(torch, pts, vals, grid, k):
    from bench import scipy_reference_values
    from ptv_interpolation_tpu_torch.interpolate import (
        sibson_grid_interpolate)
    from ptv_interpolation_tpu_torch.ops import fused_grid_knn as fg
    from ptv_interpolation_tpu_torch.ops import grid_knn as gk
    log("== 4. main path: sibson_grid_interpolate on cuda")
    kw = dict(k=k, tau_mode="bisect", block=BLOCK, device="cuda")

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sibson_grid_interpolate(pts, vals, grid, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out, first = run()
    log(f"  warm-up run: {first:.4f} s")

    # split the launch count between the main pass and repair
    counts = {"repair": 0}
    fused_repair = fg.fused_repair

    def counted_repair(*a, **kwa):
        before = fg._fused_eval.launches
        try:
            return fused_repair(*a, **kwa)
        finally:
            counts["repair"] += fg._fused_eval.launches - before

    torch.cuda.reset_peak_memory_stats()
    fg._fused_eval.launches = 0
    fg.fused_repair = counted_repair
    try:
        walls = []
        for i in range(3):
            out, wall = run()
            walls.append(wall)
            log(f"  run {i + 1}: {wall:.4f} s")
    finally:
        fg.fused_repair = fused_repair
    launches = fg._fused_eval.launches
    main_launches = launches - counts["repair"]
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls))
    log(f"  median wall {wall:.4f} s; peak device memory "
        f"{peak / 2**30:.3f} GiB; kernel launches: main pass "
        f"{main_launches}, repair {counts['repair']} (3 runs)")
    if main_launches <= 0 or counts["repair"] <= 0:
        raise AssertionError("the main path did not launch the kernel in "
                             "both the main pass and repair")
    if tuple(out.shape) != grid.shape + (vals.shape[1],):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite values in the interpolated field")

    # stage-by-stage breakdown of the same path, synchronised per stage
    dev = torch.device("cuda")
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return res

    V = vals.shape[1]
    dims = tuple(-(-n // b) for n, b in zip(grid.shape, BLOCK))
    sz = fg._pick_sz(*BLOCK)

    def setup():
        p = torch.as_tensor(pts, device=dev)
        v = torch.as_tensor(vals, device=dev)
        return (p,) + gk._host_setup(p, v, grid, k, BLOCK, 1.45,
                                     cell_divisor=3.0, device=dev)

    p, cells, vs, axes, margin, mc, _, v = stage("setup", setup)

    def phase1():
        C = fg._panel_width(fg._block_total_capacity(cells, axes, margin,
                                                     BLOCK, grid.shape, mc))
        cand = fg._compact_gather(cells, vs, axes, margin, BLOCK, grid.shape,
                                  mc, C)
        return C, cand, fg._build_queries(axes, BLOCK, dims, sz, device=dev)

    C, cand, q = stage("phase1", phase1)
    raw = stage("kernel", lambda: fg._fused_eval(
        np.float32(margin * margin), cand, *q, BLOCK, sz, k, V, C, "sibson",
        2.0))
    full = stage("reassemble",
                 lambda: fg._reassemble(raw, BLOCK, dims, sz, grid.shape))
    n_uncovered = int((full[..., V] == 0).sum())
    field = stage("repair", lambda: gk.repair_empty_nodes(
        full[..., :V], full[..., V], p, v, grid, k, "sibson", 2.0,
        cells=cells, margin=margin, values_sorted=vs, block=BLOCK))
    log("  stages (s): " + ", ".join(f"{n} {s:.4f}"
                                     for n, s in stages.items())
        + f"; {n_uncovered} nodes uncovered before repair")
    if not torch.equal(field, out):
        raise AssertionError("the stage-by-stage run differs from the "
                             "main path")

    # interior nodes, and nodes on the faces, edges and corners, which the
    # main pass leaves uncovered and repair serves
    n = grid.shape[0]
    rng = np.random.default_rng(1)
    interior = rng.integers(1, n - 1, (20_000, 3))
    faces = rng.integers(0, n, (4_000, 3))
    faces[np.arange(4_000), rng.integers(0, 3, 4_000)] = \
        rng.choice([0, n - 1], 4_000)
    corners = np.array([[z, y, x] for z in (0, n - 1) for y in (0, n - 1)
                        for x in (0, n - 1)])
    for what, idx in (("interior", interior),
                      ("face/edge/corner", np.concatenate([faces, corners]))):
        iz, iy, ix = idx.T
        queries = np.stack([grid.x[ix], grid.y[iy], grid.z[iz]],
                           axis=-1).astype(np.float32)
        ref = scipy_reference_values(pts, vals, queries)
        ours = out[torch.as_tensor(iz), torch.as_tensor(iy),
                   torch.as_tensor(ix)].cpu().numpy().astype(np.float64)
        l2 = float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))
        log(f"  relative L2 vs the f64 scipy reference on {len(idx)} "
            f"{what} nodes: {l2:.3e} (limit {L2_LIMIT:.0e})")
        if not l2 <= L2_LIMIT:
            raise AssertionError(f"relative L2 {l2:.3e} on {what} nodes "
                                 f"exceeds {L2_LIMIT:.0e}")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from bench import GRID_N, K, make_problem
    from ptv_interpolation_tpu_torch.grid import create_grid

    phase_environment(torch)
    phase_build()
    pts, vals = make_problem()
    grid = create_grid(((0, GRID_N + 1),) * 3, GRID_N)
    max_err, ms, plain_ms = phase_kernel(torch, pts, vals, grid, K)
    launches = phase_main_path(torch, pts, vals, grid, K)

    log(json.dumps({"kernels": [{
        "name": "fused_grid_knn",
        "route": "cuda",
        "source": "ptv_interpolation_tpu_torch/ops/csrc/fused_grid_knn.cu",
        "replaces": "ptv_interpolation_tpu/ops/fused_grid_knn.py:175",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
