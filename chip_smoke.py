#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, the CUDA toolkit's ``nvcc``, scipy and pandas, and
never imports JAX. Phases, each printing its own lines; every failure raises
and the script exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off and float32 matmul precision set
   to "highest";
2. build: the three kernels of ``ptv_interpolation_tpu_torch/ops/csrc/`` with
   ``nvcc``, one compiler per source, all started together (timed, counted
   as set-up);
3. the grid kernel against its plain PyTorch version on the headline problem
   (``bench.make_problem``: 1M points → 256³, k=50, block (8,8,16)): on a
   subset of blocks with the corner and edge blocks, sibson and IDW, then
   over the full panel (16 384 blocks × 4 sub-tiles), timed — τ² (the
   kernel's optional τ² output) bit-equal to the plain bisection's, den==0
   identical, values within RTOL/ATOL; it prints how many nodes overflowed
   their shortlist and ran over the whole panel, and the kernel's bound
   (``bound_ms``) reckoned from this panel's pairs within the margin;
4. the main path: ``sibson_grid_interpolate(..., device="cuda")`` — one
   warm-up and 3 timed runs, the kernel's launch counts for the main pass
   and for repair, peak memory, a stage-by-stage breakdown, and relative
   L2 against the f64 scipy reference on 20k interior nodes and on 4k
   nodes of the faces, edges and corners (served by repair);
5. the MAD kernel against its plain version on the filter's panel of the
   phase-6 problem: a subset of scatter blocks with the 8 domain corners
   and the planted outliers at k = 30 and 25, then the full panel at
   k = 30, timed — keep|covered identical and rows 1–3 (√τ², med, mad)
   bit-equal; it prints the shortlist overflow counts and the kernel's
   bound reckoned from this panel's pairs within the margin;
6. the pipeline: ``run_pipeline(..., device="cuda")`` at the production
   shape (a 486×336×322 raw mask, 650 000 tracks, downscale 2 → a
   161×168×243 grid; MAD filter k=30, boundary particles, sibson k=50) —
   one warm-up run through CSV/TIFF/NPZ files and 3 timed runs on arrays,
   with both kernels' launch counts, the filter branch, the repair ladder's
   stages, stage walls, peak memory, and checks of the decisions (f64
   cKDTree), the field (f64 scipy sibson) and the solid (exactly 0);
7. the one-phase kernel of ``backend='pallas'`` against its plain version
   on the headline problem (block (2,8,8), 14 halvings): a subset of
   blocks with the corners, edges, blocks whose windows leave the cell
   grid and random interior ones, sibson and IDW at p = 2 and 3 (τ²
   bit-equal); timed on one fixed slice of blocks (kernel and plain
   version), and the kernel alone on every block; it prints its shared
   memory plan (staged panel, shortlist entries S) and how many nodes
   overflowed their shortlist;
8. the route: ``sibson_grid_interpolate(..., backend="pallas",
   device="cuda")`` on the headline problem — one warm-up and 3 timed
   runs, launches, peak memory, a stage breakdown, and relative L2 against
   the f64 scipy reference on 20k interior nodes (reported, not gated: 14
   halvings leave τ coarse);
9. the streaming path (``backend="xla"``) and the exact top-k gather path
   (``exact_topk=True``) at 125 000 points → 128³ (the headline's density),
   timed once each, with the repair ladder's stages and relative L2 against
   f64 scipy on 20k interior nodes;
10. the production configuration: phase 6's problem through
   ``run_pipeline(..., device="cuda")`` with the flags of
   ``examples/porous_glass.py`` (``divergence_free=True``, variational
   cleaning, λ = 200, ``iterations=5``) — one warm-up and 3 timed runs,
   the stage walls with ``clean_divergence``, CG iterations, convergence,
   mean |div| before and after, peak memory; checks that the field before
   cleaning equals phase 6's, that Woodbury agrees with the direct 3n CG
   oracle (relative L2 < 1e-4 per component), that a 12³ crop where fluid
   meets solid agrees with a dense f64 solve of ``(I + λ D̃ᵀD̃) U = U0``,
   that solid nodes are exactly 0 and every value finite; runs the
   projection method once; and takes one more cleaning call apart (set-up,
   CG iterations × ms, the shares of the S operator, V-cycle and dots with
   a synchronisation between layers, launches and device busy time per
   iteration); it saves the cleaning's input and one-device result as
   ``.npy`` files for phase 14;
11. the other interpolation methods, PyTorch ops with no kernel of their
   own (TF32 checked off first): (a) local RBF on the grid route at
   scenarios 3/4's size (500 000 tracks → 128³, thin-plate, k = 20) —
   warm-up and 3 timed runs, the selection and solve walls, peak memory,
   f64 scipy ``RBFInterpolator`` on 2 000 fluid nodes (median and 99th
   percentile bars of ``tests/test_interpolate.py``), ``torch.linalg.solve``
   on one chunk of systems beside ``_gauss_solve_t``, the flat solve on
   the card against the CPU; (b) global dense RBF, scenario 2, against the
   analytic cylinder flow; (c) global RBF through PCG at 30 000 points
   against the dense fit and the analytic field; (d) nearest at phase 9's
   size through the cell list, bit for bit against the port on the CPU on
   20 000 nodes, with its agreement with an f64 cKDTree; (e) linear through
   ``run_pipeline`` at phase 6's mask and flags with 400 000 tracks — one
   cold run (Qhull, timed apart) and two warm ones, the solid exactly 0,
   the field against the device ``linear_interpolate`` on 20 000 fluid
   nodes. The generic paths'
   launches and wall per query tile are printed for the record;
12. flow analysis, PyTorch ops with no kernel of their own: (a) the user's
   two commands at the production configuration — phase 6's problem
   written to CSV and TIFF, ``cli.main.main`` with the flags of
   ``examples/porous_glass.py`` (kernels 1 and 2 launch here and count in
   the record), then ``cli.analyze_flow.main`` with its defaults
   (pressure, mesh drag, both permeabilities): both walls, the analysis
   stage walls and the stats log; gated on the files written, finite
   fields, strain/dissipation/vorticity exactly 0 on solid nodes, the
   pressure solve converged and drag label 1's area > 0; (b)
   ``run_analysis`` at 256³ on ``tools/profile_analysis.py``'s field
   (flow type, pressure, mesh drag) — one warm-up and 3 timed runs, stage
   walls, peak memory, CG iterations, triangle count, the drag stage split
   into extraction and tractions, launches per pressure-CG iteration;
   gated on strain and vorticity against f64 ``np.gradient`` (max |Δ| ≤
   1e-4 of max|field|), the device mesh against the host extractor (the
   same count, area within rtol 1e-4) and order-3 ``map_coordinates`` at
   100 000 centroids against the CPU (rtol 1e-5); (c) the reference's
   analytic validations: the Stokes sphere by mesh drag at 80³ and 160³
   (force errors < 20%, P/V in [0.4, 0.6]) and Poiseuille pressure
   recovery at 96³ (∇P within 10%);
13. the post-hoc tools on the files 12a wrote, each command's wall
   printed: ``view_divergence --no-plot`` (mean |div| before and after
   cleaning against an f64 numpy divergence of the same fields, rtol
   1e-4), ``plot_flux --no-show`` (Agg; the PNG written),
   ``compare_results`` against twice-scaled, padded reference TIFFs (L2 <
   1e-5), ``auto_align`` on phase 6's mask with 5 000 tracks shifted by
   (3, −2, 4) (recovered within 2 voxels), and a checkpoint round trip of
   the cleaned field on the card (bit for bit);
14. the sharded paths in two worlds of spawned processes: 1 rank over
   NCCL and 2 ranks over gloo, both on cuda:0 (the collectives staged
   through host memory). (a) ``sharded_grid_interpolate`` on the headline
   problem — a warm-up and 3 timed runs per world: the median wall per
   rank beside phase 4's, each rank's store bytes against the whole
   store's, kernel 1's launches per rank, the slabs' repair counts and
   ``n_left``, peak memory per rank, and the largest |Δ| and count of
   differing nodes against phase 4's output; gated on relative L2 ≤ 1e-6
   against f64 scipy on phase 4's 20 000 interior nodes, ≥ 99.9% of
   values within rtol 1e-3 / atol 1e-4 of phase 4's output and each
   rank's window within (total/n + halo)·1.35 rows. (b) z-sharded
   cleaning of phase 10's input at the production shape, variational (λ =
   200) and projection (2 iterations) — a warm-up and 3 timed runs each:
   the median wall per rank beside one device's, CG iterations, halo
   exchanges and all-reduces per CG iteration, peak memory per rank;
   gated on ``converged``, relative L2 ≤ 1e-4 per component against the
   one-device fields (phase 10's for variational), CG counts within ±2,
   every rank alike, the solid exactly 0. (c) ``sharded_interpolate_values``
   with cells on phase 9's problem (idw k=12) over the 2 ranks, bit for
   bit against the single-device ``interpolate_values``; (d)
   ``make_pipeline_step`` in the 1-rank world (IDW k=16, one projection
   iteration), timed, finite, the solid 0; (e) ``entry.dryrun_multichip(2)``
   on the card. The ranks' kernel-1 launches count in the record;
15. the serving daemon and approximate selection: (a) in 12a's directory,
   ``cli.main`` with 12a's flags as 3 fresh processes, then
   ``ptv_interpolation_tpu_torch.daemon`` started and 3 ``dispatch``
   requests of the same command, then ``cli.analyze_flow`` as one fresh
   process and 2 requests; each wall, the start wall, the processes on
   the card and the idle daemon's device memory (the card's memory in
   use, daemon idle against stopped). Gated on ``dispatch`` never
   returning None, every rc 0, the daemon's NPZ bit for bit 12a's, one
   more process on the card while it serves, a bad argv's nonzero rc with
   the server still up, and after ``stop`` status 1 with the socket gone.
   The daemon's kernel launches happen in its own process and do not
   count in the record. (b) ``tau_mode='approx'`` (served by exact
   selection) against ``'exact'`` on phase 9's problem: bit for bit, and
   relative L2 ≤ 1e-6 against f64 scipy on 20 000 interior nodes.

The script's wall is printed before the kernels' record. The second-to-last
line of standard output is the kernels' JSON record
(``ms``, ``plain_ms`` and ``bound_ms`` are the full panel for the first two
kernels and phase 7's fixed slice for the third; ``bound_ms`` is the larger
of the d² the function needs, 8 unfused fp32 operations each at 33.5e12/s
(the 67 TFLOP/s peak counts an FMA as two), and each input byte read once
and each output byte written once at 3.35 TB/s. Kernels 1 and 2 need the
d² of the (query, candidate) pairs within the margin, the only ones that
can change their outputs; kernel 3 needs every real point of its windows,
since the farthest sets its bisection's upper bound. ``library_ms`` is
null: no one PyTorch call computes these functions), the last line
``{"ok": true, "device": {...}}``.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BLOCK = (8, 8, 16)
RTOL, ATOL = 1e-5, 1e-6    # summation order and expf differ; d², τ² bit-equal
L2_LIMIT = 1e-6
# H100 SXM at 700 W: 67 TFLOP/s fp32 outside the tensor cores counts an FMA
# as two operations; d² is formed with __fmul_rn/__fadd_rn, which are not
# fused, so its operations issue at half that rate
FP32_UNFUSED_RATE = 33.5e12
HBM_RATE = 3.35e12         # H100 SXM HBM3 bytes/s
D2_OPS = 8                 # fp32 operations of one d²: 3 sub, 3 mul, 2 add
REAL = 1e18                # coordinates at or above it are sentinels/padding


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
    torch.set_float32_matmul_precision("highest")
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from ptv_interpolation_tpu_torch.ops import cuda_build, fused_grid_knn
    from ptv_interpolation_tpu_torch.ops import fused_mad, pallas_grid_knn
    log("== 2. build")
    names = ("fused_grid_knn", "fused_mad", "pallas_grid_knn")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        list(pool.map(cuda_build.build_library, names))
    fused_grid_knn._kernel_lib()
    fused_mad._kernel_lib()
    pallas_grid_knn._kernel_lib()
    secs = time.perf_counter() - t0
    log(f"{', '.join(n + '.cu' for n in names)} built and loaded in "
        f"{secs:.2f} s")
    for name in names:
        build_log = cuda_build.BUILD_DIR / f"{name}.log"
        if build_log.exists():
            for line in build_log.read_text().splitlines():
                if "ptxas" in line and ("registers" in line or "spill" in line):
                    log(f"  {name}: {line.strip()}")
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


def _bound(pairs, n_bytes):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``pairs`` d² evaluations (8 unfused fp32 operations each) and
    ``n_bytes`` moved once (at the HBM rate), whichever is larger."""
    ops_ms = float(pairs) * D2_OPS / FP32_UNFUSED_RATE * 1e3
    bytes_ms = float(n_bytes) / HBM_RATE * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def _pairs_within(torch, m2, c, q):
    """The (query, candidate) pairs of each block with d² ≤ m2, sentinel
    candidates and padding queries left out: the only pairs whose d² can
    change the grid or MAD kernel's output (a pair beyond the margin
    counts toward no coverage, halving or sum). ``c``: (3, nb, C) x, y, z
    of the panel, ``q``: (3, nb, B) of the queries; counted in chunks of
    blocks, d² summed in the kernels' op order."""
    _, nb, C = c.shape
    B = q.shape[2]
    step = max(1, (1 << 27) // (B * C))
    total = 0
    for b0 in range(0, nb, step):
        cs, qs = c[:, b0:b0 + step], q[:, b0:b0 + step]
        d = qs[0, :, :, None] - cs[0, :, None, :]
        d2 = d * d
        for a in (1, 2):
            torch.sub(qs[a, :, :, None], cs[a, :, None, :], out=d)
            d2 += d * d
        ok = (d2 <= m2) & (qs[0, :, :, None] < REAL) \
            & (cs[0, :, None, :] < REAL)
        total += int(ok.sum())
    return total


def _grid_bound(torch, m2, cand, q, C, V):
    """Kernel 1's bound on this panel: every node against its block's
    candidates within the margin; the x, y, z and V value rows, the
    queries and the output moved once."""
    nb = cand.shape[1] // C
    n_rows, _, Bt = q[0].shape
    pairs = _pairs_within(torch, float(m2), cand[:3].view(3, nb, C),
                          torch.stack(q).view(3, nb, n_rows // nb * Bt))
    n_bytes = 4 * ((3 + V) * cand.shape[1] + 3 * n_rows * Bt
                   + 8 * n_rows * Bt)
    return _bound(pairs, n_bytes), pairs / (n_rows * Bt)


def _check_tau2(torch, fg, args, what):
    """Kernel 1's τ² output bit-equal to the plain bisection's; returns
    the nodes that overflowed their shortlist and the node count."""
    m2, cand, qx, qy, qz, block, sz, k, V, C = args[:10]
    tau2 = torch.empty(qx.shape[0], qx.shape[2], device=cand.device)
    with capture() as rec:
        fg._fused_eval(*args, tau2=tau2)
    overflow = rec.counters()["kernel1.overflow"]
    want = fg._fused_tau2_plain(m2, cand, qx, qy, qz, block, sz, k, C)
    if not torch.equal(tau2, want):
        n = int((tau2 != want).sum())
        raise AssertionError(f"{what}: τ² differs from the plain version's "
                             f"at {n} nodes")
    log(f"  {what}: τ² bit-equal; {overflow} of {tau2.numel()} nodes "
        f"overflowed their shortlist")
    return overflow, tau2.numel()


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
        what = f"{mode}, {len(ids)} blocks incl. corners/edges"
        errs.append(_compare(torch, got, want, V, what))
        _check_tau2(torch, fg, args, what)

    cand = fg._compact_gather(cells, values_sorted, axes, margin, BLOCK,
                              grid.shape, mc, C)
    q = fg._build_queries(axes, BLOCK, dims, sz, device=dev)
    args = (m2, cand, *q, BLOCK, sz, k, V, C, "sibson", 2.0)
    ms = _cuda_ms(torch, lambda: fg._fused_eval(*args), reps=5)
    plain_ms = _cuda_ms(torch, lambda: fg._fused_eval_plain(*args), reps=1)
    got, want = fg._fused_eval(*args), fg._fused_eval_plain(*args)
    torch.cuda.synchronize()
    errs.append(_compare(torch, got, want, V, "sibson, full headline panel"))
    overflow, n_nodes = _check_tau2(torch, fg, args,
                                    "sibson, full headline panel")
    (bound_ms, bound_by), per_node = _grid_bound(torch, m2, cand, q, C, V)
    log(f"  full panel, sibson: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}; {per_node:.1f} candidates "
        f"within the margin per node); shortlist overflow {overflow} of "
        f"{n_nodes} nodes")
    return max(errs), ms, plain_ms, bound_ms, bound_by


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

    # split the launch count between the main pass and repair: the spans
    # ptv.grid.kernel1 inside and outside ptv.grid.repair
    torch.cuda.reset_peak_memory_stats()
    with capture() as rec:
        walls = []
        for i in range(3):
            out, wall = run()
            walls.append(wall)
            log(f"  run {i + 1}: {wall:.4f} s")
    spans = rec.spans()
    parent = {r["id"]: r["parent"] for r in spans}
    repair_ids = {r["id"] for r in spans if r["name"] == "ptv.grid.repair"}

    def in_repair(r):
        while r is not None and r not in repair_ids:
            r = parent.get(r)
        return r is not None

    launched = [r for r in spans if r["name"] == "ptv.grid.kernel1"
                and r["counters"].get("kernel1.launches")]
    counts = {"repair": sum(in_repair(r["id"]) for r in launched)}
    launches = len(launched)
    main_launches = launches - counts["repair"]
    ladder = {k: v for k, v in rec.counters().items()
              if k.startswith("repair.")}
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls))
    log(f"  median wall {wall:.4f} s; peak device memory "
        f"{peak / 2**30:.3f} GiB; kernel launches: main pass "
        f"{main_launches}, repair {counts['repair']} (3 runs); repair "
        f"ladder over the 3 runs {ladder}; host syncs "
        f"{rec.counters().get('host_syncs', 0) / 3:g} per run")
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
    refs = {}
    for what, idx in (("interior", interior),
                      ("face/edge/corner", np.concatenate([faces, corners]))):
        iz, iy, ix = idx.T
        queries = np.stack([grid.x[ix], grid.y[iy], grid.z[iz]],
                           axis=-1).astype(np.float32)
        ref = refs[what] = scipy_reference_values(pts, vals, queries)
        ours = out[torch.as_tensor(iz), torch.as_tensor(iy),
                   torch.as_tensor(ix)].cpu().numpy().astype(np.float64)
        l2 = float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))
        log(f"  relative L2 vs the f64 scipy reference on {len(idx)} "
            f"{what} nodes: {l2:.3e} (limit {L2_LIMIT:.0e})")
        if not l2 <= L2_LIMIT:
            raise AssertionError(f"relative L2 {l2:.3e} on {what} nodes "
                                 f"exceeds {L2_LIMIT:.0e}")
    # for phase 14: the wall, the field and the interior gate's reference
    return launches, wall, out.cpu().numpy(), (interior, refs["interior"])


# ---------------------------------------------------------------------------
# The pipeline at the production shape (phases 5 and 6)
# ---------------------------------------------------------------------------

RAW_SHAPE = (486, 336, 322)        # raw mask (z, y, x); downscale 2 → 243×168×161
N_TRACKS = 650_000
PIPE_L2_LIMIT = 1e-6
AGREE_LIMIT = 0.9999


def pipeline_config(**kw):
    from ptv_interpolation_tpu_torch.pipeline import PipelineConfig
    fields = dict(
        method="sibson", sibson_neighbors=50, downscale=2.0,
        boundary_particles=True, boundary_sampling=50, boundary_thickness=2,
        filter_outliers=True, filter_neighbors=30, filter_threshold=4.0,
        filter_max_speed=5.0, divergence_free=False, verbose=False)
    return PipelineConfig(**{**fields, **kw})


def make_pipeline_problem(seed=0, n_tracks=N_TRACKS):
    """The production shape of ``benchmarks/production_shape.py`` at raw
    resolution: its solid formula (line 46) evaluated at half the raw-voxel
    offsets (92% fluid), 650 000 tracks uniform in the fluid with its
    values (lines 57-61) at half the raw coordinates, 0.2% of the tracks
    scaled ×8 (speed above vmax 5: the threshold filter) and another 0.2%
    ×2.5 (the MAD filter). Returns ``(fluid, pts, vals, thr_idx,
    mad_idx)``."""
    nz, ny, nx = RAW_SHAPE
    rng = np.random.default_rng(seed)
    az = (np.arange(nz) - nz / 2) / 2
    ay = (np.arange(ny) - ny / 2) / 2
    ax = (np.arange(nx) - nx / 2) / 2
    solid = ((np.sin(az * 0.08)[:, None, None] * np.sin(ay * 0.14)[None, :, None])
             * np.sin(ax * 0.11)[None, None, :]) > 0.55
    fluid = ~solid
    pts = rng.uniform((0, 0, 0), (nx, ny, nz),
                      size=(int(n_tracks * 1.3), 3)).astype(np.float32)
    idx = np.clip(pts.astype(int), 0, (nx - 1, ny - 1, nz - 1))
    pts = pts[fluid[idx[:, 2], idx[:, 1], idx[:, 0]]][:n_tracks]
    half = pts / 2
    vals = np.stack([0.05 * np.sin(half[:, 0] * 0.05),
                     0.05 * np.cos(half[:, 1] * 0.04),
                     1.0 + 0.1 * np.sin(half[:, 2] * 0.03)],
                    axis=-1).astype(np.float32)
    planted = rng.choice(len(pts), 2 * (len(pts) // 500), replace=False)
    thr_idx, mad_idx = np.sort(planted[::2]), np.sort(planted[1::2])
    vals[thr_idx] *= 8.0
    vals[mad_idx] *= 2.5
    return fluid, pts, vals, thr_idx, mad_idx


def _filter_input(fluid, pts, vals):
    """The cloud the kNN-MAD filter sees: clipped to the domain, then
    through the speed threshold. Returns the cloud and its source rows."""
    from ptv_interpolation_tpu_torch.io import PointCloud
    nz, ny, nx = fluid.shape
    p = pts
    inside = ((p[:, 0] >= 0) & (p[:, 0] < nx) & (p[:, 1] >= 0)
              & (p[:, 1] < ny) & (p[:, 2] >= 0) & (p[:, 2] < nz))
    v = vals
    under = np.sqrt((v * v).sum(axis=-1)) <= 5.0
    rows = np.flatnonzero(inside & under)
    return PointCloud(pts[rows], vals[rows]), rows


def capture():
    """The port's span and counter record for a block
    (``ptv_interpolation_tpu_torch.utils.capture``)."""
    from ptv_interpolation_tpu_torch.utils import capture as port_capture
    return port_capture()


def _captured(module, name, fn):
    """The positional arguments of the first call that ``fn()`` makes to
    the kernel wrapper ``module.<name>``."""
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
    if not seen:
        raise AssertionError(f"{name} was not called")
    return seen[0]


def _captured_mad_eval(cloud, k):
    """The MAD kernel's inputs on this cloud, from one fused_mad_filter
    call on the card (its launch is not a main-path launch)."""
    from ptv_interpolation_tpu_torch.ops import fused_mad as fm
    speed = np.sqrt((cloud.values ** 2).sum(axis=-1))
    res = []
    args = _captured(fm, "_mad_eval", lambda: res.append(fm.fused_mad_filter(
        cloud.points, speed, k, 4.0, device="cuda")))
    if res[0] is None:
        raise AssertionError("fused_mad_filter declined the production panel")
    return args


def _compare_mad(torch, got, want, overflow, what):
    if not torch.equal(got[:, 0], want[:, 0]):
        n = int((got[:, 0] != want[:, 0]).sum())
        raise AssertionError(f"{what}: keep|covered differs at {n} slots")
    fin = torch.isfinite(want[:, 1])
    if not torch.equal(fin, torch.isfinite(got[:, 1])):
        raise AssertionError(f"{what}: padding (+inf) pattern differs")
    if not torch.equal(got[:, 1:4], want[:, 1:4]):
        n = int((got[:, 1:4] != want[:, 1:4]).sum())
        raise AssertionError(f"{what}: rows 1-3 differ at {n} entries")
    g = torch.where(fin[:, None], got[:, 1:4], 0.0)
    w = torch.where(fin[:, None], want[:, 1:4], 0.0)
    err = float((g - w).abs().max())
    n_unc = int(((got[:, 0] < 2) & fin).sum())
    log(f"  {what}: keep|covered identical ({n_unc} real slots uncovered), "
        f"rows 1-3 bit-equal; {overflow} of {int(fin.sum())} real queries "
        f"overflowed their shortlist")
    return err


def phase_mad_kernel(torch, fluid, pts, vals, thr_idx, mad_idx):
    from ptv_interpolation_tpu_torch.ops import fused_mad as fm
    log("== 5. MAD kernel against its plain version")
    cloud, rows = _filter_input(fluid, pts, vals)
    # the 8 domain corners' nearest tracks and the planted MAD outliers
    p = cloud.points
    lo, hi = p.min(axis=0), p.max(axis=0)
    corners = [np.argmin(((p - np.array([x, y, z])) ** 2).sum(axis=1))
               for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
               for z in (lo[2], hi[2])]
    outliers = np.flatnonzero(np.isin(rows, mad_idx))[:64]
    probe = torch.as_tensor(p[np.concatenate([corners, outliers])],
                            device="cuda")
    errs = []
    for k in (30, 25):
        m2, cand, qx, qy, qz, qs, kk, thr, Bt, C = _captured_mad_eval(
            cloud, k)
        nb = cand.shape[1] // C
        if k == 30:
            log(f"  production panel: {nb} scatter blocks × Bt = {Bt} "
                f"queries, C = {C}, margin² = {float(m2):.4f}")
        # the blocks whose query rows hold a probe point
        hit = torch.zeros(nb, dtype=torch.bool, device="cuda")
        for i in range(0, len(probe), 64):
            q = probe[i:i + 64]
            hit |= ((qx[None, :, 0, :] == q[:, 0, None, None])
                    & (qy[None, :, 0, :] == q[:, 1, None, None])
                    & (qz[None, :, 0, :] == q[:, 2, None, None])).any(
                        dim=2).any(dim=0)
        ids = torch.nonzero(hit).squeeze(1)
        sub_cand = cand.view(4, nb, C)[:, ids].reshape(4, -1).contiguous()
        sub_q = [a[ids].contiguous() for a in (qx, qy, qz, qs)]
        args = (m2, sub_cand, *sub_q, kk, thr, Bt, C)
        with capture() as rec:
            got = fm._mad_eval(*args)
        want = fm._mad_eval_plain(*args)
        torch.cuda.synchronize()
        errs.append(_compare_mad(torch, got, want,
                                 rec.counters()["kernel2.overflow"],
                                 f"k={k}, {len(ids)} blocks "
                                 f"with the 8 corners and "
                                 f"{len(outliers)} planted outliers"))
        full = (m2, cand, qx, qy, qz, qs, kk, thr, Bt, C)
        with capture() as rec:
            got = fm._mad_eval(*full)
        want = fm._mad_eval_plain(*full)
        torch.cuda.synchronize()
        errs.append(_compare_mad(torch, got, want,
                                 rec.counters()["kernel2.overflow"],
                                 f"k={k}, full production panel"))
        if k == 30:
            full30 = full
    full = full30
    ms = _cuda_ms(torch, lambda: fm._mad_eval(*full), reps=5)
    plain_ms = _cuda_ms(torch, lambda: fm._mad_eval_plain(*full), reps=1)
    # the bound: every real query against the candidates within the
    # margin; the panel, the queries (x, y, z, speed) and the output once
    m2, cand, qx, qy, qz = full[:5]
    Bt, C = full[8], full[9]
    nb = cand.shape[1] // C
    pairs = _pairs_within(torch, float(m2), cand[:3].view(3, nb, C),
                          torch.stack([qx, qy, qz]).view(3, nb, Bt))
    bound_ms, bound_by = _bound(pairs, 4 * (4 * nb * C + 4 * nb * Bt
                                            + 8 * nb * Bt))
    n_real = int((qx < REAL).sum())
    log(f"  full panel, k=30: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}; {pairs / n_real:.1f} "
        f"candidates within the margin per real query)")
    return max(errs), ms, plain_ms, bound_ms, bound_by


def phase_pipeline(torch, fluid, pts, vals, thr_idx, mad_idx):
    import dataclasses
    import tempfile
    from scipy.spatial import cKDTree
    from bench import scipy_reference_values
    from ptv_interpolation_tpu_torch import filtering, pipeline
    from ptv_interpolation_tpu_torch.io import (PointCloud,
                                                load_velocity_field,
                                                save_ptv_data)
    from ptv_interpolation_tpu_torch.io.tiff import write_tiff
    from ptv_interpolation_tpu_torch.utils import StageTimings
    log("== 6. pipeline: run_pipeline on cuda at the production shape")
    config = pipeline_config()

    # warm-up through files: CSV tracks, a TIFF of the solid (inverted on
    # load, as a scan's mask arrives), the NPZ read back
    with tempfile.TemporaryDirectory() as tmp:
        csv, tif, npz = (os.path.join(tmp, f) for f in
                         ("tracks.csv", "solid.tif", "field.npz"))
        t0 = time.perf_counter()
        save_ptv_data(csv, PointCloud(pts, vals))
        write_tiff(tif, ~fluid)
        log(f"  wrote {len(pts)} tracks to CSV and the {fluid.shape} solid "
            f"mask to TIFF in {time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(dataclasses.replace(
            config, input=csv, mask=tif, invert_mask=True, output_npz=npz),
            device="cuda")
        torch.cuda.synchronize()
        log(f"  warm-up run through files: {time.perf_counter() - t0:.4f} s")
        back = load_velocity_field(npz)
        for f in ("x", "y", "z", "u", "v", "w", "mask"):
            if not np.array_equal(getattr(back, f), getattr(res, f)):
                raise AssertionError(f"NPZ field {f} differs from the result")
        log("  NPZ read back: identical to the returned FieldResult")

    # the timed runs, on arrays; decisions and the final cloud captured
    seen = {}
    scatter, interp = filtering.knn_mad_mask_scatter, pipeline.interpolate_field

    def grab_scatter(points, values, **kw):
        keep, radius = scatter(points, values, **kw)
        seen["keep"] = keep
        return keep, radius

    def grab_interp(points, values, grid, **kw):
        seen["cloud"] = (np.asarray(points), np.asarray(values))
        return interp(points, values, grid, **kw)

    filtering.knn_mad_mask_scatter = grab_scatter
    pipeline.interpolate_field = grab_interp
    walls, launches, all_stages = [], [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(3):
            timings = StageTimings()
            torch.cuda.synchronize()
            with capture() as rec:
                t0 = time.perf_counter()
                res = pipeline.run_pipeline(config,
                                            cloud=PointCloud(pts, vals),
                                            mask_raw=fluid, timings=timings,
                                            device="cuda")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            counts = rec.counters()
            launches.append((counts.get("kernel2.launches", 0),
                             counts.get("kernel1.launches", 0)))
            all_stages.append(dict(timings.stages))
            log(f"  run {i + 1}: {walls[-1]:.4f} s; launches: fused_mad "
                f"{launches[-1][0]}, fused_grid_knn {launches[-1][1]}; "
                + ", ".join(f"{n} {t:.4f}" for n, t in timings.stages.items()))
            if min(launches[-1]) <= 0:
                raise AssertionError("the pipeline run did not launch both "
                                     "kernels")
        branch = next(k.rsplit(".", 1)[1] for k in counts
                      if k.startswith("filter.branch."))
        branch = (branch, counts["filter.uncovered"])
        ladder = {k: v for k, v in counts.items() if k.startswith("repair.")}
    finally:
        filtering.knn_mad_mask_scatter = scatter
        pipeline.interpolate_field = interp
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls))
    med_run = int(np.argsort(walls)[1])
    log(f"  median wall {wall:.4f} s (stages of that run: "
        + ", ".join(f"{n} {t:.4f}" for n, t in all_stages[med_run].items())
        + f"); peak device memory {peak / 2**30:.3f} GiB")
    log(f"  filter branch for the uncovered points: {branch[0]}, "
        f"{branch[1]} points")
    log(f"  repair ladder, nodes served by stage: {ladder}")

    # decisions against an independent f64 reference on the filter's input
    cloud, rows = _filter_input(fluid, pts, vals)
    keep = seen["keep"]
    p = cloud.points.astype(np.float64)
    s = np.sqrt((cloud.values.astype(np.float64) ** 2).sum(axis=-1))
    _, idx = cKDTree(p).query(p, k=31, workers=-1)
    neigh = s[idx[:, 1:]]
    med = np.median(neigh, axis=1)
    mad = np.median(np.abs(neigh - med[:, None]), axis=1)
    ref = np.abs(s - med) / (mad + 1e-6) <= 4.0
    agree = float((keep == ref).mean())
    planted = np.isin(rows, mad_idx)
    log(f"  decisions: {int((keep != ref).sum())} of {len(ref)} disagree "
        f"with the f64 cKDTree reference (agreement {agree:.6f}, limit "
        f"{AGREE_LIMIT}); {int((~keep).sum())} removed, "
        f"{int(planted.sum())} planted MAD outliers, "
        f"{int(keep[planted].sum())} of them kept")
    if agree < AGREE_LIMIT or keep[planted].any():
        raise AssertionError("MAD decisions fail the reference check")

    # the field against f64 scipy sibson k=50 on the final cloud
    fpts, fvals = seen["cloud"]
    mask = res.mask
    rng = np.random.default_rng(1)
    fl = np.flatnonzero(mask.reshape(-1))
    nodes = np.unravel_index(
        rng.choice(fl, min(20_000, len(fl)), replace=False), mask.shape)
    iz, iy, ix = nodes
    queries = np.stack([res.x[ix], res.y[iy], res.z[iz]],
                       axis=-1).astype(np.float32)
    want = scipy_reference_values(fpts, fvals, queries)
    ours = np.stack([res.u[nodes], res.v[nodes], res.w[nodes]],
                    axis=-1).astype(np.float64)
    l2 = float(np.linalg.norm(ours - want) / np.linalg.norm(want))
    log(f"  field: relative L2 vs f64 scipy sibson k=50 on {len(iz)} fluid "
        f"nodes {l2:.3e} (limit {PIPE_L2_LIMIT:.0e}); final cloud "
        f"{len(fpts)} tracks incl. boundary particles; grid {mask.shape}")
    if not l2 <= PIPE_L2_LIMIT:
        raise AssertionError(f"relative L2 {l2:.3e} exceeds {PIPE_L2_LIMIT}")
    solid = ~mask
    n_bad = sum(int(np.count_nonzero(getattr(res, f)[solid]))
                for f in "uvw")
    log(f"  solid: {int(solid.sum())} nodes, {n_bad} nonzero values")
    if n_bad:
        raise AssertionError("solid nodes are not exactly 0")
    if not all(np.isfinite(getattr(res, f)).all() for f in "uvw"):
        raise AssertionError("non-finite values in the field")
    return (sum(n for n, _ in launches), sum(n for _, n in launches)), res


# ---------------------------------------------------------------------------
# The one-phase kernel of backend='pallas' and the other grid routes
# (phases 7-9)
# ---------------------------------------------------------------------------

PALLAS_BLOCK = (2, 8, 8)
PALLAS_ITERS = 14
SLICE_BLOCKS = 1024                # the fixed slice both versions are timed on


def _pallas_slice(full):
    """Kernel 3's arguments over every block cut to the fixed slice of
    SLICE_BLOCKS blocks from the middle of the grid."""
    starts, ids = full[:2]
    s0 = starts.shape[0] // 2
    return (starts[s0:s0 + SLICE_BLOCKS].contiguous(),
            ids[s0:s0 + SLICE_BLOCKS].contiguous()) + tuple(full[2:])


def _compare_pallas(torch, got, want, what):
    """τ² (column 3) bit-equal; the values within RTOL/ATOL; nodes whose
    windows hold no point exactly 0 in both."""
    if not torch.equal(got[..., 3], want[..., 3]):
        n = int((got[..., 3] != want[..., 3]).sum())
        raise AssertionError(f"{what}: τ² differs at {n} nodes")
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        bad = ~torch.isclose(got, want, rtol=RTOL, atol=ATOL)
        raise AssertionError(f"{what}: {int(bad.sum())} values outside "
                             f"rtol {RTOL} atol {ATOL}")
    empty = (want[..., :3] == 0).all(dim=-1)
    if not bool((got[..., :3][empty] == 0).all()):
        raise AssertionError(f"{what}: empty windows are not exactly 0")
    err = float((got - want).abs().max())
    log(f"  {what}: τ² bit-equal, {int(empty.sum())} nodes with empty "
        f"windows, max |kernel - plain| = {err:.3e}")
    return err


def phase_pallas_kernel(torch, pts, vals, grid, k):
    from ptv_interpolation_tpu_torch.ops import pallas_grid_knn as pg
    log("== 7. one-phase kernel (backend='pallas') against its plain version")
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    starts, axes, store, dims, L = pg._pallas_setup(pts, vals, grid, k,
                                                    PALLAS_BLOCK, 1.45, dev)
    torch.cuda.synchronize()
    n_blocks, R = starts.shape
    store_w = store.shape[1]
    B = int(np.prod(PALLAS_BLOCK))
    log(f"  headline: {n_blocks} blocks of {B} "
        f"nodes, R = {R} windows × L = {L} (C = {R * L}), store (8, "
        f"{store_w}); setup {time.perf_counter() - t0:.3f} s")
    S, chunk, smem = pg._list_plan(R * L, B, k)
    log(f"  shared memory per CTA: {smem - 2 * S * B} bytes of "
        f"staged x, y, z ({chunk} slots) + shortlists of S = {S} u16 "
        f"entries × {B} nodes = {smem} bytes; the list is written after "
        f"{pg._LIST_AFTER} halvings on the panel")

    # corners, edges, blocks with windows outside the cell grid, interior
    nbz, nby, nbx = dims
    corners = [(z * nby + y) * nbx + x for z in (0, nbz - 1)
               for y in (0, nby - 1) for x in (0, nbx - 1)]
    edges = ([x for x in range(nbx)]
             + [(z * nby + nby - 1) * nbx for z in range(nbz)]
             + [((nbz - 1) * nby + y) * nbx + nbx - 1 for y in range(nby)])
    outside = torch.nonzero((starts == store_w - L).any(dim=1)).squeeze(1)
    outside = outside.cpu().numpy()
    rng = np.random.default_rng(7)
    ids = np.unique(np.concatenate([corners, edges, outside[:100],
                                    outside[-100:],
                                    rng.integers(0, n_blocks, 300)]))
    ids_t = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    sub = (starts[ids_t.long()].contiguous(), ids_t, axes, store,
           PALLAS_BLOCK, dims, L, k)
    errs = []
    for mode, power in (("sibson", 2.0), ("idw", 2.0), ("idw", 3.0)):
        args = sub + (mode, power, PALLAS_ITERS)
        with capture() as rec:
            got = pg._pallas_eval(*args)
        want = pg._pallas_eval_plain(*args)
        torch.cuda.synchronize()
        errs.append(_compare_pallas(
            torch, got, want, f"{mode} p={power:g}, {len(ids)} blocks incl. "
            f"corners/edges/{len(outside)} outside the cell grid"))
        _log_overflow(rec, got, f"{mode} p={power:g} subset")

    # one fixed slice of blocks for both versions, then every block
    all_ids = torch.arange(n_blocks, dtype=torch.int32, device=dev)
    full = (starts, all_ids, axes, store, PALLAS_BLOCK, dims, L, k,
            "sibson", 2.0, PALLAS_ITERS)
    args = _pallas_slice(full)
    ms = _cuda_ms(torch, lambda: pg._pallas_eval(*args), reps=5)
    plain_ms = _cuda_ms(torch, lambda: pg._pallas_eval_plain(*args), reps=1)
    with capture() as rec:
        got = pg._pallas_eval(*args)
    want = pg._pallas_eval_plain(*args)
    torch.cuda.synchronize()
    errs.append(_compare_pallas(torch, got, want,
                                f"sibson, slice of {SLICE_BLOCKS} blocks"))
    _log_overflow(rec, got, f"slice of {SLICE_BLOCKS} blocks")
    # the slice's work: 128 nodes against every real point of its windows
    # (each d² can move the bisection's upper bound, the farthest one);
    # the store columns the windows cover (x, y, z, u, v, w), the starts
    # and the output moved once
    n_sl, R = args[0].shape
    cols = (args[0].long()[:, :, None]
            + torch.arange(L, device=dev)[None, None, :])     # (n, R, L)
    real = int((store[0][cols] < 0.5 * pg._BIG).sum())
    n_bytes = (4 * 6 * int(torch.unique(cols).numel()) + 4 * n_sl * R
               + 4 * got.numel())
    bound_ms, bound_by = _bound(real * int(np.prod(PALLAS_BLOCK)), n_bytes)
    log(f"  slice of {SLICE_BLOCKS} blocks, sibson: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
    full_ms = _cuda_ms(torch, lambda: pg._pallas_eval(*full), reps=2)
    log(f"  every block ({n_blocks}), sibson: kernel {full_ms:.3f} ms")
    with capture() as rec:
        got = pg._pallas_eval(*full)
    _log_overflow(rec, got, f"every block ({n_blocks})")
    return max(errs), ms, plain_ms, bound_ms, bound_by


def _log_overflow(rec, out, what):
    """Kernel 3's count of nodes that ran over the whole panel in the launch
    that gave ``out``, the one launch of the capture ``rec``."""
    log(f"  {what}: {rec.counters()['kernel3.overflow']} of "
        f"{out.shape[0] * out.shape[1]} nodes overflowed their shortlist")


def _interior_l2(torch, out, pts, vals, grid, n_nodes=20_000, seed=1):
    from bench import scipy_reference_values
    n = grid.shape[0]
    rng = np.random.default_rng(seed)
    iz, iy, ix = rng.integers(1, n - 1, (n_nodes, 3)).T
    queries = np.stack([grid.x[ix], grid.y[iy], grid.z[iz]],
                       axis=-1).astype(np.float32)
    ref = scipy_reference_values(pts, vals, queries)
    ours = out[torch.as_tensor(iz), torch.as_tensor(iy),
               torch.as_tensor(ix)].cpu().numpy().astype(np.float64)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


def phase_pallas_path(torch, pts, vals, grid, k):
    from ptv_interpolation_tpu_torch.interpolate import (
        sibson_grid_interpolate)
    from ptv_interpolation_tpu_torch.ops import grid_knn as gk
    from ptv_interpolation_tpu_torch.ops import pallas_grid_knn as pg
    log("== 8. route: sibson_grid_interpolate(backend='pallas') on cuda")

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sibson_grid_interpolate(pts, vals, grid, k=k, backend="pallas",
                                      device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out, first = run()
    log(f"  warm-up run: {first:.4f} s")
    torch.cuda.reset_peak_memory_stats()
    walls = []
    with capture() as rec:
        for i in range(3):
            out, wall = run()
            walls.append(wall)
            log(f"  run {i + 1}: {wall:.4f} s")
    launches = rec.counters().get("kernel3.launches", 0)
    peak = torch.cuda.max_memory_allocated()
    log(f"  median wall {float(np.median(walls)):.4f} s; peak device memory "
        f"{peak / 2**30:.3f} GiB; kernel launches {launches} (3 runs)")
    if launches <= 0:
        raise AssertionError("the pallas route did not launch its kernel")
    if tuple(out.shape) != grid.shape + (vals.shape[1],):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite values in the interpolated field")

    # the same route stage by stage, synchronised per stage
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return res

    starts, axes, store, dims, L = stage("setup", lambda: pg._pallas_setup(
        pts, vals, grid, k, PALLAS_BLOCK, 1.45, "cuda"))
    ids = torch.arange(starts.shape[0], dtype=torch.int32, device="cuda")
    raw = stage("kernel", lambda: pg._pallas_eval(
        starts, ids, axes, store, PALLAS_BLOCK, dims, L, k, "sibson", 2.0,
        PALLAS_ITERS))
    field = stage("reassemble", lambda: gk._reassemble_blocks(
        raw[..., :3], PALLAS_BLOCK, grid.shape))
    log("  stages (s): " + ", ".join(f"{n} {s:.4f}"
                                     for n, s in stages.items()))
    if not torch.equal(field, out):
        raise AssertionError("the stage-by-stage run differs from the route")
    l2 = _interior_l2(torch, out, pts, vals, grid)
    log(f"  relative L2 vs the f64 scipy reference on 20000 interior nodes: "
        f"{l2:.3e} (reported, not gated: {PALLAS_ITERS} halvings)")
    return launches


SMALL_N, SMALL_POINTS = 128, 125_000


def phase_other_routes(torch, k):
    from ptv_interpolation_tpu_torch.interpolate import (
        sibson_grid_interpolate)
    log(f"== 9. streaming and exact top-k routes, {SMALL_POINTS} points → "
        f"{SMALL_N}³")
    pts, vals, grid = uniform_problem()
    for name, kw in (("backend='xla'", dict(backend="xla")),
                     ("exact_topk=True", dict(exact_topk=True))):
        torch.cuda.synchronize()
        with capture() as rec:
            t0 = time.perf_counter()
            out = sibson_grid_interpolate(pts, vals, grid, k=k,
                                          device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = rec.counters()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite values")
        l2 = _interior_l2(torch, out, pts, vals, grid)
        log(f"  {name}: {wall:.4f} s (first call), repair ladder "
            f"{ {k: v for k, v in counts.items() if 'repair.' in k} }, "
            f"grid-kernel launches {counts.get('kernel1.launches', 0)}; "
            f"relative L2 vs f64 "
            f"scipy on 20000 interior nodes {l2:.3e} (limit "
            f"{L2_LIMIT:.0e})")
        if not l2 <= L2_LIMIT:
            raise AssertionError(f"{name}: relative L2 {l2:.3e} exceeds "
                                 f"{L2_LIMIT:.0e}")


# ---------------------------------------------------------------------------
# The production configuration: the pipeline with variational cleaning
# (phase 10)
# ---------------------------------------------------------------------------

CLEAN_LAMBDA = 200.0               # examples/porous_glass.py
DIRECT_L2_LIMIT = 1e-4             # Woodbury against the direct oracle
CROP = 12                          # the f64 dense check's crop (12³)
CROP_RTOL, CROP_ATOL = 2e-3, 2e-4


def _np_operator_divergence(u, v, w, mask, dx, dy, dz):
    """An f64 numpy copy of the 'operator' divergence (both solid faces 0,
    own-cell value at the domain edges), over any leading batch axes."""
    def face(vel, axis, h):
        last = [slice(None)] * vel.ndim
        first = list(last)
        last[axis], first[axis] = -1, 0
        f_next = np.where(np.roll(mask, -1, axis),
                          (vel + np.roll(vel, -1, axis)) / 2.0, 0.0)
        f_next[tuple(last)] = vel[tuple(last)]
        f_prev = np.where(np.roll(mask, 1, axis),
                          (vel + np.roll(vel, 1, axis)) / 2.0, 0.0)
        f_prev[tuple(first)] = vel[tuple(first)]
        return (f_next - f_prev) / h
    return face(u, -1, dx) + face(v, -2, dy) + face(w, -3, dz)


def _dense_variational_f64(u, v, w, mask, dx, dy, dz, lam):
    """``(I + λ D̃ᵀD̃) U = U0`` solved densely in f64 on the fluid cells,
    ``D̃`` probed one unit vector per fluid cell and component through
    :func:`_np_operator_divergence`. Returns ``U`` at the fluid cells,
    u then v then w."""
    idx = np.argwhere(mask)
    n = len(idx)
    probes = np.zeros((n,) + mask.shape)
    probes[np.arange(n), idx[:, 0], idx[:, 1], idx[:, 2]] = 1.0
    zero = np.zeros_like(probes)
    cols = []
    for c in range(3):
        fields = [zero, zero, zero]
        fields[c] = probes
        cols.append(_np_operator_divergence(*fields, mask, dx, dy, dz)[
            :, mask].T)                                # (n rows, n columns)
    D = np.concatenate(cols, axis=1)
    rhs = np.concatenate([a[mask] for a in (u, v, w)]).astype(np.float64)
    return np.linalg.solve(np.eye(3 * n) + lam * (D.T @ D), rhs), n


def _crop_where_fluid_meets_solid(mask, size):
    """Slices of the ``size``³ window (on a stride of ``size``/2) whose
    fluid share is closest to 75%: fluid touching solid."""
    step = size // 2
    best = None
    for z in range(0, mask.shape[0] - size + 1, step):
        for y in range(0, mask.shape[1] - size + 1, step):
            for x in range(0, mask.shape[2] - size + 1, step):
                share = mask[z:z + size, y:y + size, x:x + size].mean()
                if best is None or abs(share - 0.75) < best[0]:
                    best = (abs(share - 0.75), (z, y, x))
    z, y, x = best[1]
    return (slice(z, z + size), slice(y, y + size), slice(x, x + size))


def _crop_check(torch, u, v, w, mask, spacing, dev):
    """The port's Woodbury solve (tol 1e-10) on a 12³ crop of the field,
    treated as its own domain, against the dense f64 solve."""
    from ptv_interpolation_tpu_torch import physics
    sl = _crop_where_fluid_meets_solid(mask, CROP)
    m = np.ascontiguousarray(mask[sl])
    crop = [np.ascontiguousarray(a[sl]) * m for a in (u, v, w)]
    t0 = time.perf_counter()
    want, n = _dense_variational_f64(*crop, m, *spacing, CLEAN_LAMBDA)
    dense_s = time.perf_counter() - t0
    res = physics.clean_divergence_variational(
        *crop, m, *spacing, lambda_reg=CLEAN_LAMBDA, tol=1e-10, device=dev)
    mt = torch.as_tensor(m, device=dev)
    got = np.concatenate([a[mt].cpu().numpy() for a in res[:3]])
    err = np.abs(got - want)
    ok = err <= CROP_ATOL + CROP_RTOL * np.abs(want)
    log(f"  f64 dense check on the {CROP}³ crop at "
        f"{tuple(s.start for s in sl)} ({n} fluid cells, D̃ {n} × {3 * n}, "
        f"dense solve {dense_s:.2f} s): Woodbury tol 1e-10 in "
        f"{res.cg_iterations} iterations, max |port − f64| = "
        f"{err.max():.3e}, {int((~ok).sum())} of {3 * n} values outside "
        f"rtol {CROP_RTOL} / atol {CROP_ATOL}")
    if not ok.all():
        raise AssertionError("the crop's Woodbury solve disagrees with the "
                             "dense f64 solve")


def _device_launches(torch, fn):
    """``(launches, device_ms)``: the device operations (kernels, copies)
    ``fn()`` issues and their summed device time, from ``torch.profiler``;
    ``(None, None)`` when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    n = sum(e.count for e in events)
    if not n:
        return None, None
    return n, sum(e.self_device_time_total for e in events) / 1e3


def _cleaning_breakdown(torch, u, v, w, mask, spacing, dev):
    """One more Woodbury cleaning call taken apart: set-up (parity masks,
    MG hierarchy, right-hand side) and the CG loop, timed plain; then the
    same CG with a synchronisation around each layer, for the shares of
    the S operator (``div_op``/``div_op_T``), the V-cycle and the dot
    products; the launches of each layer and of one whole iteration, and
    the device's busy share of an iteration (``torch.profiler``)."""
    from ptv_interpolation_tpu_torch import physics
    from ptv_interpolation_tpu_torch.ops import solvers
    mask_t = torch.as_tensor(mask, device=dev)
    maskf = mask_t.float()
    example = tuple(torch.as_tensor(a, device=dev) * maskf for a in (u, v, w))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S, m_inv, div_op, div_op_T = physics._woodbury_operators(
        mask_t, *spacing, CLEAN_LAMBDA)
    b = div_op(example)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    res = solvers.pcg(S, b, M_inv=m_inv, tol=1e-8, maxiter=2000)
    torch.cuda.synchronize()
    cg_ms = (time.perf_counter() - t0) * 1e3
    its = max(res.iterations, 1)
    per_iter = cg_ms / its
    log(f"  breakdown of one more cleaning call: set-up {setup_ms:.2f} ms, "
        f"CG {res.iterations} iterations × {per_iter:.3f} ms = "
        f"{cg_ms:.1f} ms")

    spent = {"S operator": 0.0, "V-cycle": 0.0, "dots": 0.0}

    def synced(name, fn):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            spent[name] += (time.perf_counter() - t) * 1e3
            return out
        return run

    dot = solvers._dot
    solvers._dot = synced("dots", dot)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solvers.pcg(synced("S operator", S), b,
                    M_inv=synced("V-cycle", m_inv), tol=1e-8, maxiter=its)
        torch.cuda.synchronize()
        synced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        solvers._dot = dot
    log(f"    with a synchronisation around each layer ({synced_ms:.1f} ms "
        f"for the same {its} iterations): "
        + ", ".join(f"{name} {ms / its:.3f} ms per iteration "
                    f"({ms / synced_ms:.1%})" for name, ms in spent.items())
        + f", the rest (vector updates, host work, the one read of rr) "
        f"{(synced_ms - sum(spent.values())) / its:.3f} ms")

    q = res.x
    alpha = solvers._dot(q, q)
    for name, fn, per in (("S operator", lambda: S(q), 1),
                          ("V-cycle", lambda: m_inv(q), 1),
                          ("dots", lambda: solvers._dot(q, q), 3),
                          ("vector updates",
                           lambda: solvers._axpy(alpha, q, q), 3)):
        n, dev_ms = _device_launches(torch, fn)
        log(f"    {name}: " + (f"{n * per} launches, device busy "
                               f"{dev_ms * per:.3f} ms per iteration"
                               if n else "launches not measured"))

    def iterations(k):
        return lambda: solvers.pcg(S, b, M_inv=m_inv, tol=1e-8, maxiter=k)

    (n1, d1), (n3, d3) = (_device_launches(torch, iterations(k))
                          for k in (1, 3))
    if n1 and n3:
        busy = (d3 - d1) / 2
        log(f"    per CG iteration: {(n3 - n1) / 2:.0f} launches, device "
            f"busy {busy:.3f} ms of {per_iter:.3f} ms ({busy / per_iter:.1%};"
            f" idle {1 - busy / per_iter:.1%})")
    else:
        log("    per CG iteration: launches and device time not measured")


def phase_cleaning(torch, fluid, pts, vals, uncleaned, save_dir):
    from ptv_interpolation_tpu_torch import physics, pipeline
    from ptv_interpolation_tpu_torch.io import PointCloud
    from ptv_interpolation_tpu_torch.utils import StageTimings
    log("== 10. production configuration: run_pipeline with variational "
        "cleaning on cuda")
    config = pipeline_config(divergence_free=True,
                             cleaning_method="variational",
                             cleaning_lambda=CLEAN_LAMBDA, iterations=5)
    cloud = PointCloud(pts, vals)
    calls = []
    variational = physics.clean_divergence_variational

    def grab(*a, **kw):
        calls.append((a, variational(*a, **kw)))
        return calls[-1][1]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(config, cloud=cloud, mask_raw=fluid,
                                    timings=timings, device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    physics.clean_divergence_variational = grab
    try:
        timings = StageTimings()
        res, wall = run()
        log(f"  warm-up run: {wall:.4f} s")
        args = calls[0][0]
        u0, v0, w0, mask = args[:4]
        spacing = args[4:7]

        # the field before cleaning is phase 6's (same inputs, same kernels)
        for f in "uvw":
            if not np.allclose(getattr(res, f + "_init"),
                               getattr(uncleaned, f), rtol=1e-5, atol=1e-6):
                raise AssertionError(f"{f}_init differs from phase 6's field")
        log("  u_init, v_init, w_init equal phase 6's field (rtol 1e-5, "
            "atol 1e-6)")

        # Woodbury against the direct 3n CG oracle on the same U_init
        direct = variational(u0, v0, w0, mask, *spacing,
                             lambda_reg=CLEAN_LAMBDA, solver="direct",
                             device="cuda")
        rels = []
        for f, d in zip("uvw", direct[:3]):
            ref = d.cpu().numpy().astype(np.float64)
            got = getattr(res, f).astype(np.float64)
            rels.append(float(np.linalg.norm(got - ref)
                              / np.linalg.norm(ref)))
        log(f"  Woodbury ({calls[0][1].cg_iterations} iterations) against "
            f"the direct oracle ({direct.cg_iterations} iterations, "
            f"converged {direct.converged}): relative L2 u {rels[0]:.3e}, "
            f"v {rels[1]:.3e}, w {rels[2]:.3e} (limit {DIRECT_L2_LIMIT:.0e})")
        if not (direct.converged and max(rels) < DIRECT_L2_LIMIT):
            raise AssertionError("Woodbury disagrees with the direct oracle")
        del direct
        torch.cuda.empty_cache()

        walls, launches, all_stages = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(3):
            timings = StageTimings()
            with capture() as rec:
                res, wall = run()
            walls.append(wall)
            counts = rec.counters()
            launches.append((counts.get("kernel2.launches", 0),
                             counts.get("kernel1.launches", 0)))
            all_stages.append(dict(timings.stages))
            log(f"  run {i + 1}: {wall:.4f} s; launches: fused_mad "
                f"{launches[-1][0]}, fused_grid_knn {launches[-1][1]}; "
                + ", ".join(f"{n} {t:.4f}"
                            for n, t in timings.stages.items()))
            if min(launches[-1]) <= 0:
                raise AssertionError("the pipeline run did not launch both "
                                     "kernels")
    finally:
        physics.clean_divergence_variational = variational
    peak = torch.cuda.max_memory_allocated()
    clean = calls[-1][1]
    save_cleaning(save_dir, calls[0][0], clean)     # phase 14's reference
    init, final = (float(clean.mean_abs_div_initial),
                   float(clean.mean_abs_div_final))
    med_run = int(np.argsort(walls)[1])
    log(f"  median wall {float(np.median(walls)):.4f} s (stages of that run: "
        + ", ".join(f"{n} {t:.4f}" for n, t in all_stages[med_run].items())
        + f"); peak device memory {peak / 2**30:.3f} GiB")
    log(f"  cleaning: {clean.cg_iterations} CG iterations, converged "
        f"{clean.converged}; mean |div| {init:.6e} → {final:.6e}, "
        f"reduction {init / final:.2f}x")
    if not clean.converged or not init / final > 1:
        raise AssertionError("the cleaning did not converge or did not "
                             "reduce the divergence")
    solid = ~res.mask
    n_bad = sum(int(np.count_nonzero(getattr(res, f)[solid]))
                for f in ("u", "v", "w", "u_init", "v_init", "w_init"))
    if n_bad or not all(np.isfinite(getattr(res, f)).all() for f in
                        ("u", "v", "w", "u_init", "v_init", "w_init")):
        raise AssertionError(f"{n_bad} nonzero solid values, or non-finite "
                             f"values, in the cleaned result")
    log(f"  solid: {int(solid.sum())} nodes, 0 nonzero values in u, v, w "
        f"and u_init, v_init, w_init; every value finite")

    _crop_check(torch, u0, v0, w0, mask, spacing, "cuda")

    # the projection method once, MG-preconditioned, on the same field
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proj = physics.clean_divergence_projection(u0, v0, w0, mask, *spacing,
                                               iterations=3, device="cuda")
    torch.cuda.synchronize()
    p_init, p_final = (float(proj.mean_abs_div_initial),
                       float(proj.mean_abs_div_final))
    log(f"  projection (3 loops, MG-PCG): {proj.cg_iterations} CG "
        f"iterations, converged {proj.converged}, {time.perf_counter() - t0:.3f}"
        f" s; mean |div| {p_init:.6e} → {p_final:.6e}, reduction "
        f"{p_init / p_final:.2f}x")
    if not p_init / p_final > 1:
        raise AssertionError("projection cleaning did not reduce the "
                             "divergence")
    del proj

    _cleaning_breakdown(torch, u0, v0, w0, mask, spacing, "cuda")
    return (sum(n for n, _ in launches), sum(n for _, n in launches))


# ---------------------------------------------------------------------------
# The other interpolation methods (phase 11): PyTorch ops, no kernel
# ---------------------------------------------------------------------------

RBF_MEDIAN_LIMIT, RBF_P99_LIMIT = 2e-3, 3e-2   # tests/test_interpolate.py
CYL_ERR_LIMIT = 0.02                           # scenario 2's accuracy bar
PCG_DENSE_LIMIT, PCG_FIELD_LIMIT = 2e-3, 5e-2  # tests/test_rbf_global_pcg.py
FLAT_CPU_LIMIT = 1e-4
LINEAR_L2_LIMIT = 1e-6
# 11e's track count: Qhull on the production cloud (650 000 tracks and the
# boundary particles, 668 827 points) took 72-86 s on the H100's host, over
# the 60 s this phase allows it, so 11e triangulates 400 000 tracks
LINEAR_TRACKS = 400_000


def porous_problem(n_points=1_000_000, n=256, seed=0):
    """``benchmarks/scenarios.py::porous_problem``: tracks inside a porous
    (gyroid-like) solid at n³. Returns ``(pts, vals, fluid)``."""
    rng = np.random.default_rng(seed)
    ax = np.arange(n) - n / 2
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    solid = (np.sin(X * 0.1) * np.sin(Y * 0.13) * np.sin(Z * 0.07)) > 0.55
    fluid = ~solid
    pts = rng.uniform(0, n, size=(int(n_points * 1.2), 3)).astype(np.float32)
    idx = np.clip(pts.astype(int), 0, n - 1)
    keep = fluid[idx[:, 2], idx[:, 1], idx[:, 0]]
    pts = pts[keep][:n_points]
    vals = np.stack([
        0.05 * np.sin(pts[:, 0] * 0.05),
        0.05 * np.cos(pts[:, 1] * 0.04),
        1.0 + 0.1 * np.sin(pts[:, 2] * 0.03),
    ], axis=-1).astype(np.float32)
    return pts, vals, fluid


def _synced(torch, fn):
    """``(result, seconds)`` of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _tile_launches(torch, fn, n_tiles, what):
    """Device launches and wall of ``fn()`` over ``n_tiles`` query tiles,
    printed per tile (the generic paths run one Python loop step per
    tile)."""
    n, dev_ms = _device_launches(torch, fn)
    _, wall = _synced(torch, fn)
    per = (f"{n / n_tiles:.0f} launches, device busy "
           f"{dev_ms / n_tiles:.3f} ms" if n else "launches not measured")
    log(f"  {what}: {per} and {wall / n_tiles * 1e3:.3f} ms of wall per "
        f"tile ({n_tiles} tiles)")


def phase_local_rbf(torch, n_points=500_000, n=128):
    from scipy.interpolate import RBFInterpolator
    from ptv_interpolation_tpu_torch.grid import create_grid
    from ptv_interpolation_tpu_torch.interpolate import rbf_local as rl
    from ptv_interpolation_tpu_torch.interpolate.dispatch import (
        interpolate_field)
    log("== 11a. local RBF on the grid route (scenarios 3/4: 500 000 "
        "tracks → 128³, thin-plate, k = 20)")
    pts, vals, fluid = porous_problem(n_points, n)
    grid = create_grid(((0, n + 1),) * 3, n)

    def run():
        return interpolate_field(pts, vals, grid, method="rbf",
                                 rbf_neighbors=20, use_grid_kernel="always",
                                 device="cuda")

    _, first = _synced(torch, run)
    log(f"  {len(pts)} tracks; warm-up run {first:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        out, wall = _synced(torch, run)
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated()
    solve = rl._rbf_solve_flat
    spent = {}

    def timed_solve(*a, **kw):
        res, spent["solve"] = _synced(torch, lambda: solve(*a, **kw))
        return res

    rl._rbf_solve_flat = timed_solve
    try:
        _, whole = _synced(torch, run)
    finally:
        rl._rbf_solve_flat = solve
    log(f"  median wall {float(np.median(walls)):.4f} s over 3 runs "
        f"({', '.join(f'{w:.4f}' for w in walls)}); selection "
        f"{whole - spent['solve']:.4f} s + solve {spent['solve']:.4f} s in "
        f"one more run; peak device memory {peak / 2**30:.3f} GiB")
    U, V, W = (a.cpu().numpy() for a in out)
    if not all(np.isfinite(a).all() for a in (U, V, W)):
        raise AssertionError("non-finite values in the local RBF field")

    # against f64 scipy RBFInterpolator(neighbors=20) on 2 000 fluid nodes
    rng = np.random.default_rng(2)
    fl = np.flatnonzero(fluid.reshape(-1))
    iz, iy, ix = np.unravel_index(rng.choice(fl, 2000, replace=False),
                                  fluid.shape)
    q = np.stack([grid.x[ix], grid.y[iy], grid.z[iz]], axis=-1)
    t0 = time.perf_counter()
    want = RBFInterpolator(pts.astype(np.float64), vals.astype(np.float64),
                           neighbors=20, kernel="thin_plate_spline")(q)
    got = np.stack([U[iz, iy, ix], V[iz, iy, ix], W[iz, iy, ix]], axis=-1)
    err = np.abs(got - want) / (np.abs(want).max() + 1e-9)
    med, p99 = float(np.median(err)), float(np.percentile(err, 99))
    log(f"  vs f64 scipy RBFInterpolator on 2000 fluid nodes "
        f"({time.perf_counter() - t0:.1f} s): median {med:.3e} (limit "
        f"{RBF_MEDIAN_LIMIT:.0e}), 99th percentile {p99:.3e} (limit "
        f"{RBF_P99_LIMIT:.0e})")
    if not (med < RBF_MEDIAN_LIMIT and p99 < RBF_P99_LIMIT):
        raise AssertionError("local RBF misses scipy's accuracy bars")

    # the library yardstick: torch.linalg.solve on one chunk of systems
    k, m = 20, 4
    args = {}

    def grab(a, rhs):
        args.setdefault("A", (a, rhs))
        return gauss(a, rhs)

    gauss = rl._gauss_solve_t
    rl._gauss_solve_t = grab
    try:
        run()
    finally:
        rl._gauss_solve_t = gauss
    A, rhs = args["A"]
    B = A.shape[2]
    A_b = A.permute(2, 0, 1).contiguous()
    rhs_b = rhs.permute(2, 0, 1).contiguous()
    gj_ms = _cuda_ms(torch, lambda: gauss(A, rhs), reps=3)
    lib_ms = _cuda_ms(torch, lambda: torch.linalg.solve_ex(A_b, rhs_b),
                      reps=3)
    x_gj = gauss(A, rhs).permute(2, 0, 1)
    x_lib = torch.linalg.solve_ex(A_b, rhs_b)[0]
    ok = torch.isfinite(x_gj).all(dim=(1, 2)) & torch.isfinite(x_lib).all(
        dim=(1, 2))
    diff = float(((x_gj - x_lib)[ok].norm() / x_lib[ok].norm()))
    log(f"  one chunk of {B} saddle systems ({k + m}×{k + m}, 3 right-hand "
        f"sides): _gauss_solve_t {gj_ms:.3f} ms, torch.linalg.solve "
        f"{lib_ms:.3f} ms (difference {gj_ms - lib_ms:+.3f} ms); solutions "
        f"{diff:.3e} apart (relative L2, {int(ok.sum())} finite systems)")

    # the flat solve on the card against the same function on the CPU
    ids = torch.as_tensor(rng.choice(n ** 3, 4096, replace=False))
    cap = {}
    flat = rl._rbf_solve_flat

    def grab_flat(*a, **kw):
        cap["args"] = a
        return flat(*a, **kw)

    rl._rbf_solve_flat = grab_flat
    try:
        run()
    finally:
        rl._rbf_solve_flat = flat
    p_, v_, q_, sq_, idx_ = cap["args"][:5]
    rest = cap["args"][5:]
    sub = (p_, v_, q_[ids.cuda()], sq_[ids.cuda()], idx_[ids.cuda()])
    dev_out = flat(*sub, *rest).cpu().double()
    cpu_out = flat(*(a.cpu() for a in sub), *rest).double()
    rel = float((dev_out - cpu_out).norm() / cpu_out.norm())
    log(f"  _rbf_solve_flat on 4096 nodes, card against CPU: relative L2 "
        f"{rel:.3e} (limit {FLAT_CPU_LIMIT:.0e})")
    if not rel <= FLAT_CPU_LIMIT:
        raise AssertionError("the flat solve differs between card and CPU")

    # the scattered route's per-tile loop (query_tile 256), for the record
    qs = torch.as_tensor(q[:1024].astype(np.float32), device="cuda")
    _tile_launches(torch, lambda: rl.rbf_local_interpolate(
        pts[:50_000], vals[:50_000], qs, k=20, device="cuda"), 4,
        "rbf_local_interpolate (brute force over 50 000 points)")
    return float(np.median(walls))


def phase_global_rbf(torch, n_cyl=5000, n_pcg=30_000):
    from ptv_interpolation_tpu_torch.datasets import cylinders
    from ptv_interpolation_tpu_torch.grid import create_grid
    from ptv_interpolation_tpu_torch.interpolate import (
        rbf_global as rg, rbf_global_pcg as rp)
    log("== 11b. global RBF, dense Cholesky (scenario 2: cylinders, 5 000 "
        "points, gaussian ε = 2, smoothing 1e-3 → 64×32×16)")
    cloud, _, bounds = cylinders.generate(n_points=n_cyl)
    grid = create_grid(bounds, (64, 32, 16))
    queries = grid.flat_coords("cuda")

    def run():
        return rg.rbf_global_interpolate(
            cloud.points, cloud.values, queries, solver="dense",
            kernel="gaussian", epsilon=2.0, smoothing=1e-3, degree=-1,
            device="cuda")

    _, first = _synced(torch, run)
    out, wall = _synced(torch, run)
    q = queries.cpu().numpy()
    u_true, _ = cylinders.analytic_velocity(q[:, 0], q[:, 1])
    interior = ((np.abs(q[:, 0]) > 0.5) & (np.abs(q[:, 0] - 3) > 0.5)
                & (np.abs(q[:, 1]) < 1.5))
    err = float(np.abs(out.cpu().numpy()[interior, 0]
                       - u_true[interior]).mean())
    log(f"  {len(cloud)} points: first call {first:.3f} s, warm {wall:.4f} "
        f"s; mean |u − analytic| on {int(interior.sum())} interior nodes "
        f"{err:.4f} (limit {CYL_ERR_LIMIT})")
    if not err <= CYL_ERR_LIMIT:
        raise AssertionError("global RBF misses scenario 2's accuracy")

    log("== 11c. global RBF through PCG (30 000 points of "
        "tests/test_rbf_global_pcg.py's field, thin-plate ε = 1)")
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 10, size=(n_pcg, 3)).astype(np.float32)
    field = _pcg_field
    vals = field(pts).astype(np.float32)
    qp = rng.uniform(1, 9, size=(1500, 3)).astype(np.float32)
    pcg, wall = _synced(torch, lambda: rg.rbf_global_interpolate(
        pts, vals, qp, kernel="thin_plate_spline", device="cuda"))
    iters, res = rp.rbf_global_fit_pcg.last_solve
    dense, dense_s = _synced(torch, lambda: rg.rbf_global_evaluate(
        rg.rbf_global_fit(pts, vals, kernel="thin_plate_spline",
                          device="cuda"), qp))
    pcg, dense = pcg.cpu().double().numpy(), dense.cpu().double().numpy()
    truth = field(qp.astype(np.float64))
    vs_dense = float(np.linalg.norm(pcg - dense) / np.linalg.norm(dense))
    vs_truth = float(np.linalg.norm(pcg - truth) / np.linalg.norm(truth))
    log(f"  solver='auto' → PCG: {iters} iterations, relres {res:.2e}, "
        f"{wall:.3f} s (dense LU fit and evaluation {dense_s:.3f} s); "
        f"relative L2 vs dense {vs_dense:.3e} (limit {PCG_DENSE_LIMIT:.0e}),"
        f" vs the analytic field {vs_truth:.3e} (limit "
        f"{PCG_FIELD_LIMIT:.0e})")
    if not (vs_dense < PCG_DENSE_LIMIT and vs_truth < PCG_FIELD_LIMIT):
        raise AssertionError("the PCG fit misses its bars")
    return wall


def _pcg_field(p):
    """``tests/test_rbf_global_pcg.py::_field``."""
    return np.stack([np.sin(p[:, 0] * 0.7),
                     np.cos(p[:, 1] * 0.5) + 0.3 * p[:, 2],
                     p[:, 0] * p[:, 1] * 0.1], axis=-1)


def phase_nearest(torch):
    from scipy.spatial import cKDTree
    from ptv_interpolation_tpu_torch.grid import create_grid
    from ptv_interpolation_tpu_torch.interpolate import knn_weights as kw
    from ptv_interpolation_tpu_torch.interpolate.dispatch import (
        interpolate_field)
    from ptv_interpolation_tpu_torch.ops.neighbors import build_cell_list
    log(f"== 11d. nearest, {SMALL_POINTS} points → {SMALL_N}³ (Q·N > 2³¹: "
        f"the cell-list search)")
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, SMALL_N, size=(SMALL_POINTS, 3)).astype(np.float32)
    vals = rng.normal(size=(SMALL_POINTS, 3)).astype(np.float32)
    grid = create_grid(((0, SMALL_N + 1),) * 3, SMALL_N)

    def run():
        return interpolate_field(pts, vals, grid, method="nearest",
                                 device="cuda")

    _, first = _synced(torch, run)
    (U, V, W), wall = _synced(torch, run)
    out = torch.stack([U, V, W], dim=-1).reshape(-1, 3)
    nodes = rng.choice(grid.n_points, 20_000, replace=False)
    q = grid.flat_coords("cpu")[torch.as_tensor(nodes)]
    cpu = kw.nearest_interpolate(pts, vals, q, cells=build_cell_list(
        pts, k_hint=1, device="cpu"), device="cpu")
    card = out[torch.as_tensor(nodes, device="cuda")].cpu()
    if not torch.equal(card, cpu):
        n_off = int((card != cpu).any(dim=1).sum())
        raise AssertionError(f"nearest: {n_off} of 20000 nodes differ "
                             f"between card and CPU")
    exact = cKDTree(pts.astype(np.float64)).query(q.double().numpy())[1]
    agree = float((card.numpy() == vals[exact]).all(axis=1).mean())
    log(f"  first call {first:.3f} s, warm {wall:.4f} s; 20000 nodes bit "
        f"for bit equal to the port on the CPU; {agree:.4%} pick the f64 "
        f"cKDTree's point (the search is exact within its ring radius)")
    qs = grid.flat_coords("cuda")[:4096]
    cells = build_cell_list(pts, k_hint=1, device="cuda")
    _tile_launches(torch, lambda: kw.nearest_interpolate(
        pts, vals, qs, cells=cells, device="cuda"), 4,
        "nearest_interpolate over the cell list")
    return wall


def phase_linear(torch, fluid, pts, vals):
    import dataclasses
    from ptv_interpolation_tpu_torch import pipeline
    from ptv_interpolation_tpu_torch.interpolate import delaunay
    from ptv_interpolation_tpu_torch.io import PointCloud
    from ptv_interpolation_tpu_torch.utils import StageTimings
    log(f"== 11e. linear through run_pipeline at the production shape "
        f"(phase 6's mask and flags, method='linear', {len(pts)} tracks)")
    config = dataclasses.replace(pipeline_config(), method="linear")
    seen = {}
    interp = pipeline.interpolate_field
    tri_fn = delaunay.get_cached_triangulation

    def grab_interp(points, values, grid, **kw):
        seen["cloud"] = (np.asarray(points), np.asarray(values))
        return interp(points, values, grid, **kw)

    def timed_tri(points, **kw):
        hit = delaunay._points_digest(delaunay._host(
            points, np.float64)) in delaunay._TRI_CACHE
        t0 = time.perf_counter()
        tri = tri_fn(points, **kw)
        if not hit:
            seen["qhull"] = time.perf_counter() - t0
        return tri

    pipeline.interpolate_field = grab_interp
    delaunay.get_cached_triangulation = timed_tri
    walls, stages = [], []
    try:
        delaunay._TRI_CACHE.clear()
        for i in range(3):
            timings = StageTimings()
            res, wall = _synced(torch, lambda: pipeline.run_pipeline(
                config, cloud=PointCloud(pts, vals), mask_raw=fluid,
                timings=timings, device="cuda"))
            walls.append(wall)
            stages.append(dict(timings.stages))
            log(f"  {'cold' if i == 0 else 'warm'} run {i + 1}: {wall:.4f} "
                "s; " + ", ".join(f"{n} {t:.4f}"
                                  for n, t in timings.stages.items()))
    finally:
        pipeline.interpolate_field = interp
        delaunay.get_cached_triangulation = tri_fn
    fpts, fvals = seen["cloud"]
    log(f"  Qhull on {len(fpts)} points (tracks and boundary particles): "
        f"{seen['qhull']:.2f} s of the cold run; warm runs hit the cache")
    solid = ~res.mask
    n_bad = sum(int(np.count_nonzero(getattr(res, f)[solid])) for f in "uvw")
    if n_bad:
        raise AssertionError("linear: solid nodes are not exactly 0")
    rng = np.random.default_rng(1)
    fl = np.flatnonzero(res.mask.reshape(-1))
    iz, iy, ix = np.unravel_index(
        rng.choice(fl, min(20_000, len(fl)), replace=False), res.mask.shape)
    q = np.stack([res.x[ix], res.y[iy], res.z[iz]], axis=-1)
    ref = delaunay.linear_interpolate(fpts, fvals, q, device="cuda")
    ref = ref.cpu().double().numpy()
    got = np.stack([res.u[iz, iy, ix], res.v[iz, iy, ix],
                    res.w[iz, iy, ix]], axis=-1).astype(np.float64)
    l2 = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    log(f"  field vs the device linear_interpolate on {len(iz)} fluid nodes: "
        f"relative L2 {l2:.3e} (limit {LINEAR_L2_LIMIT:.0e}); solid "
        f"{int(solid.sum())} nodes, 0 nonzero")
    if not l2 <= LINEAR_L2_LIMIT:
        raise AssertionError("linear: the host walk and the device blend "
                             "disagree")
    return walls


def phase_other_methods(torch):
    log("== 11. the other interpolation methods (PyTorch ops with no "
        "kernel of their own)")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on: the global RBF sums need full f32")
    log("  TF32 off, float32 matmul precision 'highest'")
    phase_local_rbf(torch)
    torch.cuda.empty_cache()
    phase_global_rbf(torch)
    torch.cuda.empty_cache()
    phase_nearest(torch)
    torch.cuda.empty_cache()
    fluid, pts, vals = make_pipeline_problem(n_tracks=LINEAR_TRACKS)[:3]
    phase_linear(torch, fluid, pts, vals)


# ---------------------------------------------------------------------------
# Flow analysis (phase 12): the two CLIs, run_analysis at 256³ and the
# reference's analytic validations; PyTorch ops, no kernel of their own
# ---------------------------------------------------------------------------

ANALYSIS_N = 256
DERIV_LIMIT = 1e-4       # strain, vorticity vs f64 np.gradient, of max|field|
MESH_AREA_RTOL = 1e-4    # device mesh area vs the host extractor's
SAMPLE_RTOL = 1e-5       # map_coordinates order 3, card vs CPU
N_CENTROIDS = 100_000
STOKES_LIMIT = 0.20      # tests/test_drag.py's bars
POISEUILLE_LIMIT = 0.10  # tests/test_analysis.py's bar


def _cli_flags(csv, tif, npz):
    """The pipeline CLI's flags for ``examples/porous_glass.py``'s
    ``PipelineConfig``."""
    return ["--input", csv, "--mask", tif, "--invert-mask",
            "--method", "sibson", "--sibson-neighbors", "50",
            "--downscale", "2", "--divergence-free",
            "--cleaning-method", "variational", "--cleaning-lambda", "200",
            "--iter", "5", "--boundary-particles", "--boundary-sampling", "50",
            "--boundary-thickness", "2", "--filter-outliers",
            "--filter-neighbors", "30", "--filter-threshold", "4",
            "--filter-max-speed", "5", "--output-npz", npz, "--no-plot"]


class _Recorder:
    """Wraps ``module.<name>`` for the ``with`` block and keeps what
    ``keep(result)`` returns for every call."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.keep, self.seen = module, name, keep, []

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            self.seen.append(self.keep(out))
            return out

        setattr(self.module, self.name, wrapped)
        return self.seen

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _solves():
    """Records ``(iterations, converged)`` of every Poisson solve."""
    from ptv_interpolation_tpu_torch import physics
    return _Recorder(physics, "_solve_poisson_impl",
                     lambda out: (int(out[1]), bool(out[2])))


def _stage_line(stages):
    return ", ".join(f"{n} {t:.4f}" for n, t in stages.items())


def _check_solid_zero(results, fluid, what):
    for k in ("strain_rate", "dissipation", "vorticity_magnitude"):
        if np.count_nonzero(results[k][~fluid]):
            raise AssertionError(f"{what}: {k} is not 0 on solid nodes")
    bad = [k for k, a in results.items()
           if isinstance(a, np.ndarray) and not np.isfinite(a).all()]
    if bad:
        raise AssertionError(f"{what}: non-finite values in {bad}")


def phase_cli(torch, fluid, pts, vals, tmp, dev="cuda"):
    """Phase 12a in the directory ``tmp``, where it leaves ``tracks.csv``,
    ``solid.tif`` and ``field.npz`` for phase 13."""
    import contextlib
    import io
    from ptv_interpolation_tpu_torch.cli import analyze_flow
    from ptv_interpolation_tpu_torch.cli import main as cli_main
    from ptv_interpolation_tpu_torch.io import PointCloud, save_ptv_data
    from ptv_interpolation_tpu_torch.io.tiff import write_tiff
    from ptv_interpolation_tpu_torch.utils import StageTimings
    log("== 12a. the two CLIs at the production configuration: "
        "cli.main (porous_glass flags) then cli.analyze_flow (defaults)")
    extra = [] if dev == "cuda" else ["--device", dev]
    run_analysis = analyze_flow.run_analysis
    seen = {}

    def timed_analysis(config, **kw):
        seen["timings"] = StageTimings()
        seen["out"] = run_analysis(config, timings=seen["timings"], **kw)
        return seen["out"]

    cwd = os.getcwd()
    t0 = time.perf_counter()
    save_ptv_data(os.path.join(tmp, "tracks.csv"), PointCloud(pts, vals))
    write_tiff(os.path.join(tmp, "solid.tif"), ~fluid)
    log(f"  wrote {len(pts)} tracks to CSV and the solid mask to TIFF "
        f"in {time.perf_counter() - t0:.2f} s")
    os.chdir(tmp)
    analyze_flow.run_analysis = timed_analysis
    try:
        printed = io.StringIO()
        with capture() as rec, contextlib.redirect_stdout(printed):
            _, wall_main = _synced(torch, lambda: cli_main.main(
                _cli_flags("tracks.csv", "solid.tif", "field.npz")
                + extra))
        counts = rec.counters()
        launches = (counts.get("kernel2.launches", 0),
                    counts.get("kernel1.launches", 0))
        with _solves() as solves, contextlib.redirect_stdout(printed):
            _, wall_an = _synced(torch, lambda: analyze_flow.main(
                ["--input", "field.npz", "--no-interactive"] + extra))
    finally:
        analyze_flow.run_analysis = run_analysis
        os.chdir(cwd)
    names = ["field.npz", "field_analysis.npz", "field_strain.tif",
             "field_dissipation.tif", "field_vorticity.tif",
             "field_pressure.tif", "field_stats.txt"]
    missing = [f for f in names if not os.path.exists(os.path.join(tmp, f))]
    with np.load(os.path.join(tmp, "field_analysis.npz")) as npz:
        npz_fields = {k: npz[k] for k in npz.files}
    results, stats = seen["out"]
    log(f"  cli.main: {wall_main:.4f} s; launches: fused_mad {launches[0]}, "
        f"fused_grid_knn {launches[1]}")
    log(f"  cli.analyze_flow: {wall_an:.4f} s; stages: "
        + _stage_line(seen["timings"].stages))
    log(f"  pressure solve: {solves[-1][0]} MG-PCG iterations, converged "
        f"{solves[-1][1]}")
    log("  stats log:")
    for line in stats:
        for part in line.splitlines():
            log(f"    | {part}")
    if missing:
        raise AssertionError(f"12a: files not written: {missing}")
    mask = npz_fields["mask"]
    _check_solid_zero(results, mask, "12a")
    if not all(np.isfinite(a).all() for a in npz_fields.values()):
        raise AssertionError("12a: non-finite values in the analysis NPZ")
    if not solves[-1][1]:
        raise AssertionError("12a: the pressure solve did not converge")
    if not results["drag"][1]["Area"] > 0:
        raise AssertionError("12a: drag label 1 has no area")
    if dev == "cuda" and min(launches) <= 0:
        raise AssertionError("12a: the pipeline CLI did not launch both "
                             "kernels")
    log(f"  gates: {len(names)} files written, every field finite, strain, "
        f"dissipation and vorticity 0 on {int((~mask).sum())} solid nodes, "
        f"pressure converged, drag label 1 area "
        f"{results['drag'][1]['Area']:.6e}")
    return launches


# ---------------------------------------------------------------------------
# The serving daemon against cold processes, and approximate selection
# (phase 15)
# ---------------------------------------------------------------------------

N_COLD = 3


def _card_processes():
    """``(lines, MiB used)``: the card's compute processes as nvidia-smi
    lists them (``pid, used_memory``) and its memory in use. In a
    container nvidia-smi may not map the pids into its namespace, so the
    daemon is told apart by the count of processes and the memory that
    goes with it when it stops."""
    def smi(*args):
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=60,
                              check=True).stdout.strip()
    apps = [line.strip() for line in smi(
        "--query-compute-apps=pid,used_memory",
        "--format=csv,noheader").splitlines() if line.strip()]
    used = float(smi("--query-gpu=memory.used",
                     "--format=csv,noheader,nounits").splitlines()[0])
    return apps, used


def _npz_fields(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _same_fields(got, want):
    return sorted(got) == sorted(want) and all(
        np.array_equal(got[k], want[k]) for k in want)


def phase_daemon(torch, tmp, dev="cuda"):
    """Phase 15a in 12a's directory ``tmp``: ``cli.main`` with
    ``_cli_flags`` as fresh processes and through the daemon, then
    ``cli.analyze_flow`` likewise. ``dev="cpu"`` rehearses it on the CPU
    (the daemon without its CUDA warm-up, no device memory read)."""
    import contextlib
    import io
    from ptv_interpolation_tpu_torch import daemon
    log("== 15a. cold processes against the serving daemon: cli.main "
        "(porous_glass flags), then cli.analyze_flow")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("PTV_DAEMON_PLATFORM", "PTV_IN_DAEMON", "PTV_DAEMON"):
        env.pop(name, None)
    extra = []
    if dev != "cuda":
        env["PTV_DAEMON_PLATFORM"] = "cpu"
        extra = ["--device", dev]
    sock_dir = tempfile.mkdtemp(prefix="ptvd")
    if len(sock_dir) > 80:          # a Unix socket's path has ~107 bytes
        sock_dir = tempfile.mkdtemp(prefix="ptvd", dir="/tmp")
    env["PTV_DAEMON_DIR"] = sock_dir
    ref = _npz_fields(os.path.join(tmp, "field.npz"))
    saved_env, cwd = dict(os.environ), os.getcwd()
    os.environ.clear()
    os.environ.update(env)
    os.chdir(tmp)

    def cold(module, argv):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", module, *argv], env=env,
                             capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"15a: {module} exited {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
        return wall

    def served(entry, argv):
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = daemon.dispatch(entry, argv)
        wall = time.perf_counter() - t0
        if rc is None:
            raise AssertionError("15a: the daemon is unavailable")
        if rc != 0:
            raise AssertionError(f"15a: the daemon's {entry} returned rc "
                                 f"{rc}: {printed.getvalue()[-2000:]}")
        return wall

    def analyze_argv(tag):
        return ["--input", "field.npz", "--no-interactive", "--output-npz",
                f"analysis_{tag}.npz"] + extra

    started = False
    if dev == "cuda":
        apps0, _ = _card_processes()
    try:
        cold_walls = [cold("ptv_interpolation_tpu_torch.cli.main",
                           _cli_flags("tracks.csv", "solid.tif",
                                      f"cold{i}.npz") + extra)
                      for i in range(N_COLD)]
        log("  cold cli.main processes: "
            + ", ".join(f"{w:.4f}" for w in cold_walls)
            + f" s; median {float(np.median(cold_walls)):.4f} s")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = daemon.main(["start"])
        start_wall = time.perf_counter() - t0
        started = rc == 0
        if not started:
            raise AssertionError("15a: the daemon did not start")
        sock = daemon.socket_path()
        log(f"  daemon start (spawn, torch import, CUDA context, three "
            f"kernel libraries): {start_wall:.4f} s")
        warm = [served("interpolate", _cli_flags(
            "tracks.csv", "solid.tif", f"daemon{i}.npz") + extra)
            for i in range(3)]
        log("  daemon cli.main requests: "
            + ", ".join(f"{w:.4f}" for w in warm) + " s (first, then two "
            f"warm); median of the warm two {float(np.median(warm[1:])):.4f}"
            f" s")
        an_cold = cold("ptv_interpolation_tpu_torch.cli.analyze_flow",
                       analyze_argv("cold"))
        an_warm = [served("analyze", analyze_argv(f"daemon{i}"))
                   for i in range(2)]
        log(f"  cli.analyze_flow: cold process {an_cold:.4f} s; daemon "
            f"requests " + ", ".join(f"{w:.4f}" for w in an_warm) + " s")
        if dev == "cuda":
            apps1, used1 = _card_processes()
            log(f"  processes on the card (nvidia-smi pid, memory): before "
                f"the daemon {apps0}; daemon idle {apps1}")

        outputs = {f"daemon{i}": _npz_fields(f"daemon{i}.npz")
                   for i in range(3)}
        outputs.update({f"cold{i}": _npz_fields(f"cold{i}.npz")
                        for i in range(N_COLD)})
        equal = {tag: _same_fields(f, ref) for tag, f in outputs.items()}
        log("  NPZ bit for bit equal to 12a's field.npz: "
            + ", ".join(f"{t} {e}" for t, e in equal.items()))
        if not all(equal[f"daemon{i}"] for i in range(3)):
            raise AssertionError("15a: the daemon's NPZ differs from 12a's")
        an = [_npz_fields(f"analysis_{t}.npz")
              for t in ("cold", "daemon0", "daemon1")]
        log(f"  analysis NPZ of the daemon equal to the cold process's: "
            f"{_same_fields(an[1], an[0])}, {_same_fields(an[2], an[0])}")

        with contextlib.redirect_stdout(io.StringIO()):
            bad = daemon.dispatch("interpolate", ["--definitely-not-a-flag"])
            up = daemon.main(["status"]) == 0
        log(f"  bad argv: rc {bad}; server still up: {up}")
        if bad in (0, None) or not up:
            raise AssertionError("15a: a bad argv must return a nonzero rc "
                                 "and leave the server up")
    finally:
        if started:
            with contextlib.redirect_stdout(io.StringIO()):
                daemon.main(["stop"])
        os.environ.clear()
        os.environ.update(saved_env)
        os.chdir(cwd)
    with contextlib.redirect_stdout(io.StringIO()):
        status = daemon.main(["status", sock])
    gone = not os.path.exists(sock)
    shutil.rmtree(sock_dir, ignore_errors=True)
    log(f"  after stop: status {status}, socket removed {gone}")
    if status != 1 or not gone:
        raise AssertionError("15a: the daemon did not stop")
    if dev == "cuda":
        deadline = time.time() + 30
        while True:             # the process lets go of the card on exit
            apps2, used2 = _card_processes()
            if len(apps2) < len(apps1) or time.time() > deadline:
                break
            time.sleep(0.5)
        log(f"  idle daemon's device memory (nvidia-smi memory.used, daemon "
            f"idle − stopped): {used1 - used2:.0f} MiB; processes after "
            f"stop {apps2}")
        if not (len(apps1) == len(apps0) + 1 and len(apps2) == len(apps0)):
            raise AssertionError("15a: the daemon was not one process on "
                                 "the card while it served")


def phase_approx(torch, k):
    """Phase 15b: ``tau_mode='approx'`` against ``'exact'`` on phase 9's
    problem."""
    from ptv_interpolation_tpu_torch.interpolate import (
        sibson_grid_interpolate)
    log(f"== 15b. tau_mode='approx' (served by exact selection) against "
        f"'exact', {SMALL_POINTS} points → {SMALL_N}³")
    pts, vals, grid = uniform_problem()
    outs = {}
    for mode in ("approx", "exact"):
        with capture() as rec:
            out, wall = _synced(torch, lambda: sibson_grid_interpolate(
                pts, vals, grid, k=k, tau_mode=mode, device="cuda"))
        outs[mode] = out
        log(f"  tau_mode={mode!r}: {wall:.4f} s, repair ladder "
            f"{ {n: v for n, v in rec.counters().items() if 'repair.' in n} }")
    same = torch.equal(outs["approx"], outs["exact"])
    l2 = _interior_l2(torch, outs["approx"], pts, vals, grid)
    log(f"  approx bit for bit equal to exact: {same}; relative L2 vs f64 "
        f"scipy on 20000 interior nodes {l2:.3e} (limit {L2_LIMIT:.0e})")
    if not same:
        raise AssertionError("15b: tau_mode='approx' differs from 'exact'")
    if not l2 <= L2_LIMIT:
        raise AssertionError(f"15b: relative L2 {l2:.3e} exceeds "
                             f"{L2_LIMIT:.0e}")


def analysis_field(n=ANALYSIS_N):
    """``tools/profile_analysis.py::make_field``: a gyroid-like solid and
    a smooth analytic velocity at n³. Returns ``(u, v, w, x, y, z,
    fluid)``."""
    ax = np.arange(n) - n / 2
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    solid = (np.sin(X * 0.1) * np.sin(Y * 0.13) * np.sin(Z * 0.07)) > 0.55
    fluid = ~solid
    u = 0.05 * np.sin(X * 0.05) * fluid
    v = 0.05 * np.cos(Y * 0.04) * fluid
    w = (1.0 + 0.1 * np.sin(Z * 0.03)) * fluid
    x = y = z = np.arange(n, dtype=np.float64)
    return u, v, w, x, y, z, fluid


def _f64_derivatives(u, v, w, fluid):
    """Strain rate and vorticity magnitude in f64 with ``np.gradient``
    (unit spacing), the formulas of ``analysis.py``, masked."""
    gu, gv, gw = (np.gradient(a) for a in (u, v, w))     # (d/dz, d/dy, d/dx)
    e = (2 * gu[2], 2 * gv[1], 2 * gw[0])
    gamma = np.sqrt(0.5 * (e[0] ** 2 + e[1] ** 2 + e[2] ** 2)
                    + (gu[1] + gv[2]) ** 2 + (gu[0] + gw[2]) ** 2
                    + (gv[0] + gw[1]) ** 2)
    vort = np.sqrt((gw[1] - gv[0]) ** 2 + (gu[0] - gw[2]) ** 2
                   + (gv[2] - gu[1]) ** 2)
    return gamma * fluid, vort * fluid


def phase_analysis(torch, n=ANALYSIS_N, dev="cuda", n_centroids=N_CENTROIDS):
    import tempfile
    from ptv_interpolation_tpu_torch import drag
    from ptv_interpolation_tpu_torch.analysis import compute_pressure_field
    from ptv_interpolation_tpu_torch.analyze import AnalyzeConfig, run_analysis
    from ptv_interpolation_tpu_torch.io import FieldResult
    from ptv_interpolation_tpu_torch.ops.sampling import map_coordinates
    from ptv_interpolation_tpu_torch.surface import (marching_tetrahedra,
                                                     mesh_geometry_device,
                                                     triangle_geometry)
    from ptv_interpolation_tpu_torch.utils import StageTimings
    log(f"== 12b. run_analysis at {n}³ (tools/profile_analysis.py's field; "
        f"flow type, pressure, mesh drag)")
    u, v, w, x, y, z, fluid = analysis_field(n)
    field = FieldResult(x=x, y=y, z=z, u=u, v=v, w=w, mask=fluid)
    geos = _Recorder(drag, "mesh_geometry_device", lambda out: out)
    walls, stages = [], []
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, _solves() as solves, \
            geos as meshes:
        for i in range(4):
            timings = StageTimings()
            cfg = AnalyzeConfig(input="field.npz", flow_type=True,
                                basename=os.path.join(tmp, "f"),
                                verbose=False)
            (results, _), wall = _synced(torch, lambda: run_analysis(
                cfg, field=field, timings=timings, device=dev))
            log(f"  {'warm-up' if i == 0 else f'run {i}'}: {wall:.4f} s; "
                + _stage_line(timings.stages))
            if i:
                walls.append(wall)
                stages.append(dict(timings.stages))
    peak = torch.cuda.max_memory_allocated()
    geo, n_tri = meshes[-1]
    med = int(np.argsort(walls)[1])
    log(f"  median wall {walls[med]:.4f} s (stages of that run: "
        f"{_stage_line(stages[med])}); peak device memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"  pressure: {solves[-1][0]} MG-PCG iterations, converged "
        f"{solves[-1][1]}; mesh: {n_tri} triangles (label 1, the fluid)")
    if not solves[-1][1]:
        raise AssertionError("12b: the pressure solve did not converge")
    _check_solid_zero(results, fluid, "12b")

    # the split of the drag stage: extraction + geometry, then tractions
    u_d, v_d, w_d = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (u, v, w))
    p_d = torch.as_tensor(results["pressure"], device=dev)
    label = torch.as_tensor(fluid, device=dev)
    (geo2, _), t_mesh = _synced(torch, lambda: mesh_geometry_device(
        label, 0.5, device=dev))
    _, t_trac = _synced(torch, lambda: drag._mesh_tractions_t(
        u_d, v_d, w_d, p_d, None, geo2["cz"], geo2["cy"], geo2["cx"],
        geo2["nzp"], geo2["nyp"], geo2["nxp"], geo2["areas"],
        (1.0, 1.0, 1.0), 0.001, False))
    log(f"  drag split (synchronised): mesh extraction and geometry "
        f"{t_mesh:.4f} s, tractions {t_trac:.4f} s")
    launches, dev_ms = _device_launches(torch, lambda: compute_pressure_field(
        u_d, v_d, w_d, 1.0, 1.0, 1.0, 0.001, mask=label, verbose=False,
        device=dev))
    if launches:
        log(f"  pressure solve under the profiler: {launches} device "
            f"launches, {dev_ms:.1f} ms busy; {launches / solves[-1][0]:.0f}"
            f" launches per CG iteration")

    # strain and vorticity against f64 np.gradient on the same f32 inputs
    f64 = [np.asarray(a, np.float32).astype(np.float64) for a in (u, v, w)]
    errs = []
    for got, want in zip((results["strain_rate"],
                          results["vorticity_magnitude"]),
                         _f64_derivatives(*f64, fluid)):
        errs.append(float(np.abs(got - want).max() / np.abs(want).max()))
    log(f"  strain rate, vorticity against f64 np.gradient: max |Δ| / "
        f"max |field| {errs[0]:.3e}, {errs[1]:.3e} (limit {DERIV_LIMIT:.0e})")
    if max(errs) > DERIV_LIMIT:
        raise AssertionError("12b: derivative fields disagree with f64")

    # the device mesh against the port's host extractor
    t0 = time.perf_counter()
    host = marching_tetrahedra(fluid.astype(np.float64), 0.5)
    t_host = time.perf_counter() - t0
    a_host = float(triangle_geometry(host)[1].sum())
    a_dev = float(geo["areas"].double().sum())
    rel = abs(a_dev - a_host) / a_host
    log(f"  mesh: device {n_tri} triangles, host extractor {len(host)} "
        f"({t_host:.2f} s on the host); area {a_dev:.6e} vs {a_host:.6e}, "
        f"relative {rel:.3e} (limit {MESH_AREA_RTOL:.0e})")
    if n_tri != len(host) or rel > MESH_AREA_RTOL:
        raise AssertionError("12b: device mesh differs from the host's")

    # Catmull-Rom sampling at triangle centroids, card against CPU
    rng = np.random.default_rng(2)
    sel = torch.as_tensor(rng.choice(n_tri, min(n_centroids, n_tri),
                                     replace=False), device=geo["cz"].device)
    coords = torch.stack([geo[c][sel] for c in ("cz", "cy", "cx")])
    got = map_coordinates(w_d, coords, order=3).cpu().numpy()
    want = map_coordinates(w_d.cpu(), coords.cpu(), order=3).numpy()
    err = float(np.abs(got - want).max())
    log(f"  map_coordinates order 3 at {len(want)} centroids, card vs CPU: "
        f"max |Δ| {err:.3e}")
    if not np.allclose(got, want, rtol=SAMPLE_RTOL,
                       atol=SAMPLE_RTOL * np.abs(want).max()):
        raise AssertionError("12b: map_coordinates differs from the CPU's")
    return walls[med]


def _stokes_sphere(nn, radius_vox):
    """``tests/test_drag.py::stokes_sphere`` at ``nn``³, radius
    ``radius_vox`` voxels."""
    d, U_inf, mu = 1e-5, 0.1, 1e-3
    radius = radius_vox * d
    ax = (np.arange(nn) - nn / 2) * d
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    r = np.where(r == 0, 1e-20, r)
    r_safe = np.maximum(r, radius * 0.5)
    t1 = 0.75 * radius / r_safe
    t2 = 0.25 * radius ** 3 / r_safe ** 3
    w = U_inf * (1 - t1 * (1 + z ** 2 / r_safe ** 2)
                 - t2 * (1 - 3 * z ** 2 / r_safe ** 2))
    u = U_inf * (-t1 * (x * z / r_safe ** 2) + t2 * (3 * x * z / r_safe ** 2))
    v = U_inf * (-t1 * (y * z / r_safe ** 2) + t2 * (3 * y * z / r_safe ** 2))
    p = -1.5 * mu * radius * U_inf * z / r ** 3
    return u, v, w, p, (r > radius).astype(int), d, mu, radius, U_inf


def phase_validations(torch, dev="cuda", sizes=((80, 15), (160, 30)),
                      pipe_n=96):
    from ptv_interpolation_tpu_torch.analysis import compute_pressure_field
    from ptv_interpolation_tpu_torch.drag import compute_interface_drag
    log("== 12c. the reference's analytic validations on the card")
    for nn, rv in sizes:
        u, v, w, p, mask, d, mu, radius, U = _stokes_sphere(nn, rv)
        res, wall = _synced(torch, lambda: compute_interface_drag(
            u, v, w, p, mu, d, d, d, mask, method="mesh", device=dev))
        r = res[1]
        tv, tp = -4 * np.pi * mu * radius * U, -2 * np.pi * mu * radius * U
        ev, ep = abs(r["Fz_v"] - tv) / abs(tv), abs(r["Fz_p"] - tp) / abs(tp)
        ratio = abs(r["Fz_p"] / r["Fz_v"])
        log(f"  Stokes sphere {nn}³, radius {rv} voxels: viscous force error "
            f"{ev:.2%}, pressure force error {ep:.2%}, P/V {ratio:.3f} "
            f"(limits {STOKES_LIMIT:.0%}, [0.4, 0.6]); {wall:.3f} s")
        if ev >= STOKES_LIMIT or ep >= STOKES_LIMIT or not 0.4 < ratio < 0.6:
            raise AssertionError("12c: Stokes sphere drag outside its bars")
    d, mu, U_max = 20e-6, 1e-3, 1e-3
    coords = np.arange(pipe_n) * d
    z, y, x = np.meshgrid(coords, coords, coords, indexing="ij")
    c = coords.mean()
    radius = 15 * d * pipe_n / 40            # the test's 15 of 40 voxels
    r2 = (y - c) ** 2 + (x - c) ** 2
    mask = r2 < radius ** 2
    w = np.where(mask, U_max * (1 - r2 / radius ** 2), 0.0)
    zeros = np.zeros_like(w)
    with _solves() as solves:
        p, wall = _synced(torch, lambda: compute_pressure_field(
            zeros, zeros, w, d, d, d, mu, mask=mask, wall_bc="inhomogeneous",
            verbose=False, tol=1e-10, device=dev))
    expected = -4 * mu * U_max / radius ** 2
    dp_dz = np.gradient(p.cpu().numpy(), d, axis=0)
    core = ((r2 < (0.5 * radius) ** 2) & (z > 5 * d * pipe_n / 40)
            & (z < 35 * d * pipe_n / 40))
    err = abs((dp_dz[core].mean() - expected) / expected)
    log(f"  Poiseuille pipe {pipe_n}³: ∇P error {err:.3e} (limit "
        f"{POISEUILLE_LIMIT:.0%}); {solves[-1][0]} CG iterations, converged "
        f"{solves[-1][1]}; {wall:.3f} s")
    if not err < POISEUILLE_LIMIT:
        raise AssertionError("12c: Poiseuille pressure gradient outside 10%")



# ---------------------------------------------------------------------------
# The post-hoc tools, alignment and checkpoints (phase 13) and the sharded
# grid path over ranks on the one card (phase 14)
# ---------------------------------------------------------------------------

TOOL_RTOL = 1e-4          # view_divergence (f32 on the card) vs f64 numpy
COMPARE_L2_LIMIT = 1e-5   # tests/test_pipeline_e2e.py's bar
ALIGN_SHIFT = np.asarray([3.0, -2.0, 4.0], np.float32)
ALIGN_TRACKS = 5000
ALIGN_ATOL = 2.0          # voxels, tests/test_pipeline_e2e.py's bar
SHARD_CLOSE = 0.999       # share within rtol 1e-3 / atol 1e-4 (JAX tests)
SHARD_MEM_SLACK = 1.35    # ±35% density fluctuation, tests/test_sharding.py
SHARD_WORLD_TIMEOUT = 300


def _np_roll_divergence(u, v, w, mask, dx, dy, dz):
    """An f64 numpy copy of the diagnostics' 'roll' divergence
    (``ops/stencils.py::consistent_divergence``): a face takes the mean of
    its two cells where the upper one is fluid, else 0; the domain edges
    take the own cell's value."""
    def face(vel, axis, h):
        n = vel.shape[axis]
        lo = np.take(vel, np.arange(n - 1), axis)
        hi = np.take(vel, np.arange(1, n), axis)
        g = np.where(np.take(mask, np.arange(1, n), axis), (lo + hi) * 0.5,
                     0.0)
        f_next = np.concatenate([g, np.take(vel, [n - 1], axis)], axis)
        f_prev = np.concatenate([np.take(vel, [0], axis), g], axis)
        return (f_next - f_prev) / h
    return face(u, 2, dx) + face(v, 1, dy) + face(w, 0, dz)


def phase_tools(torch, tmp, pts, vals, dev="cuda"):
    """Phase 13 on the files phase 12a left in ``tmp``."""
    import contextlib
    import importlib.util
    import io
    from ptv_interpolation_tpu_torch.cli import auto_align, tools
    from ptv_interpolation_tpu_torch.io import (FieldResult, PointCloud,
                                                load_velocity_field,
                                                save_ptv_data)
    from ptv_interpolation_tpu_torch.io.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
    from ptv_interpolation_tpu_torch.io.tiff import write_tiff
    log("== 13. the post-hoc tools on phase 12a's NPZ, auto_align on phase "
        "6's mask, a checkpoint round trip")
    npz = os.path.join(tmp, "field.npz")
    extra = [] if dev == "cuda" else ["--device", dev]

    def run(fn, argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return _synced(torch, lambda: fn(argv))

    f = load_velocity_field(npz)
    (m_init, m_clean), wall = run(tools.view_divergence,
                                  [npz, "--no-plot"] + extra)
    dx, dy, dz = f.spacing
    ref = [float(np.abs(_np_roll_divergence(
        *(np.asarray(a, np.float64) for a in uvw), f.mask, dx, dy,
        dz)[f.mask]).mean()) for uvw in ((f.u_init, f.v_init, f.w_init),
                                         (f.u, f.v, f.w))]
    rel = max(abs(float(m_init) - ref[0]) / ref[0],
              abs(float(m_clean) - ref[1]) / ref[1])
    log(f"  view_divergence --no-plot: {wall:.4f} s; mean |div| "
        f"{float(m_init):.6e} → {float(m_clean):.6e} (f64 numpy "
        f"{ref[0]:.6e} → {ref[1]:.6e}; largest relative gap {rel:.2e}, "
        f"limit {TOOL_RTOL:.0e})")
    if not (rel <= TOOL_RTOL and m_clean < m_init):
        raise AssertionError("13: view_divergence disagrees with f64 numpy "
                             "or cleaning did not lower the divergence")

    if importlib.util.find_spec("matplotlib") is not None:
        png = os.path.join(tmp, "flux.png")
        stats, wall = run(tools.plot_flux,
                          [npz, "--no-show", "-o", png] + extra)
        size = os.path.getsize(png) if os.path.exists(png) else 0
        log(f"  plot_flux --no-show (Agg): {wall:.4f} s; flux.png {size} "
            f"bytes; " + ", ".join(f"{k} mean {m:.4e} std {sd:.4e}"
                                   for k, (m, sd) in stats.items()))
        if size <= 0:
            raise AssertionError("13: plot_flux wrote no PNG")
    # the fluxes plot_flux plots, on the card, against f64 numpy
    worst = 0.0
    _sync(torch, dev)
    t0 = time.perf_counter()
    for func, field, axes, (h1, h2) in (
            (tools.calculate_flux_xy, f.w, (1, 2), (dx, dy)),
            (tools.calculate_flux_xz, f.v, (0, 2), (dx, dz)),
            (tools.calculate_flux_yz, f.u, (0, 1), (dy, dz))):
        got = func(field, h1, h2, device=dev)
        want = np.asarray(field, np.float64).sum(axis=axes) * h1 * h2
        worst = max(worst, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
    wall = time.perf_counter() - t0
    log(f"  plot_flux's fluxes (calculate_flux_xy/xz/yz on {dev}): "
        f"{wall:.4f} s; largest gap to f64 numpy {worst:.2e} of the "
        f"largest |flux| (limit {TOOL_RTOL:.0e})"
        + ("" if importlib.util.find_spec("matplotlib") else
           "; matplotlib is not installed here, so plot_flux's PNG is "
           "not drawn"))
    if not worst <= TOOL_RTOL:
        raise AssertionError("13: plot_flux's fluxes disagree with f64")

    refs = []
    for name, arr in (("u", f.u), ("v", f.v), ("w", f.w)):
        refs.append(os.path.join(tmp, f"ref_{name}.tif"))
        write_tiff(refs[-1], np.pad(np.asarray(arr, np.float32) * 2.0,
                                    ((0, 2), (0, 2), (0, 2))))
    l2, wall = run(tools.compare_results,
                   ["--ptv", npz, "--ref-u", refs[0], "--ref-v", refs[1],
                    "--ref-w", refs[2], "--no-plot"] + extra)
    log(f"  compare_results against the twice-scaled, padded field: "
        f"{wall:.4f} s; L2 {l2:.3e} (limit {COMPARE_L2_LIMIT:.0e})")
    if not l2 < COMPARE_L2_LIMIT:
        raise AssertionError(f"13: compare_results L2 {l2:.3e}")

    rng = np.random.default_rng(2)
    sel = rng.choice(len(pts), min(ALIGN_TRACKS, len(pts)), replace=False)
    csv = os.path.join(tmp, "shifted.csv")
    save_ptv_data(csv, PointCloud(pts[sel] + ALIGN_SHIFT, vals[sel]))
    (best, score), wall = run(auto_align.main, [
        "-i", csv, "-m", os.path.join(tmp, "solid.tif"), "--invert-mask"])
    err = float(np.abs(np.asarray(best) + ALIGN_SHIFT).max())
    log(f"  auto_align ({len(sel)} tracks shifted by "
        f"{tuple(ALIGN_SHIFT.tolist())}, host scipy): {wall:.4f} s; offset "
        f"{np.round(np.asarray(best), 3).tolist()}, score {score:.2f}; "
        f"largest error {err:.3f} voxels (limit {ALIGN_ATOL})")
    if not err <= ALIGN_ATOL:
        raise AssertionError("13: auto_align did not recover the shift")

    dev_t = torch.device(dev)
    res = FieldResult(
        x=f.x, y=f.y, z=f.z,
        mask=torch.as_tensor(f.mask, device=dev_t),
        **{n: torch.as_tensor(getattr(f, n), device=dev_t)
           for n in ("u", "v", "w", "u_init", "v_init", "w_init")})
    ckpt = os.path.join(tmp, "field.pt")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, res)
    back = load_checkpoint(ckpt, device=dev)
    wall = time.perf_counter() - t0
    names = ("u", "v", "w", "mask", "u_init", "v_init", "w_init")
    same = all(torch.equal(getattr(back, n), getattr(res, n))
               and getattr(back, n).device == getattr(res, n).device
               for n in names) and all(
        np.array_equal(getattr(back, a), getattr(f, a)) for a in "xyz")
    log(f"  checkpoint of the cleaned field and its initial field "
        f"({os.path.getsize(ckpt) / 2**20:.1f} MiB): save and load on {dev} "
        f"{wall:.4f} s, bit for bit {same}")
    if not same:
        raise AssertionError("13: the checkpoint round trip changed a field")


def uniform_problem(n_points=SMALL_POINTS, n=SMALL_N):
    """``bench.make_problem``'s cloud and values with ``n_points`` points
    in [0, n)³, and the n³ grid: phase 9's problem by default (125 000
    points → 128³, the headline's density), the headline itself at 1M →
    256³. Returns ``(pts, vals, grid)``."""
    from ptv_interpolation_tpu_torch.grid import create_grid
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, n, size=(n_points, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.05), np.cos(pts[:, 1] * 0.04),
                     1.0 + 0.1 * np.sin(pts[:, 2] * 0.03)],
                    axis=-1).astype(np.float32)
    return pts, vals, create_grid(((0, n + 1),) * 3, n)


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


SHARD_CLEAN_L2 = 1e-4     # Woodbury against the direct oracle (phase 10)
SHARD_CLEAN_ITERS = 2     # MG-PCG counts against the one-device solve
CLEAN_FILES = ("u0", "v0", "w0", "mask", "u", "v", "w")
# make_pipeline_step's grid at phase 9's density: 64³, since its brute
# force takes over 40 s a run at phase 9's 128³ on an NVIDIA H100 80GB HBM3
# at 700 W (tools/chip_phase14.py --step-n 128)
STEP_N = 64
STEP_K = 16


def save_cleaning(workdir, args, clean):
    """Phase 10's input to ``clean_divergence_variational`` and its
    one-device result, for phase 14: ``clean_*.npy`` and ``clean.json``
    (the spacing and the CG count)."""
    arrays = tuple(args[:4]) + tuple(clean[:3])
    for name, a in zip(CLEAN_FILES, arrays):
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        np.save(os.path.join(workdir, f"clean_{name}.npy"), a)
    with open(os.path.join(workdir, "clean.json"), "w") as fh:
        json.dump({"spacing": [float(h) for h in args[4:7]],
                   "iterations": int(clean.cg_iterations)}, fh)


def _grid_job(torch, mesh, workdir, timed):
    """The sharded headline path: a warm-up and 3 timed runs; rank 0
    saves the field."""
    from bench import GRID_N, N_POINTS, K
    from ptv_interpolation_tpu_torch.parallel.mesh import all_gather_cat
    from ptv_interpolation_tpu_torch.parallel.sharding import (
        sharded_grid_interpolate)
    pts, vals, grid = uniform_problem(N_POINTS, GRID_N)

    def run():
        return sharded_grid_interpolate(pts, vals, grid, mesh,
                                        method="sibson", k=K, block=BLOCK)

    out, first = timed(run)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    walls = []
    with capture() as rec:
        for _ in range(3):
            out, wall = timed(run)
            walls.append(wall)
    res = dict(first=first, walls=walls,
               launches=rec.counters().get("kernel1.launches", 0),
               peak=torch.cuda.max_memory_allocated(mesh.device),
               stats=sharded_grid_interpolate.last_stats)
    # the slabs' all-gather alone, as the path runs it (values + den)
    rows = -(-(-(-grid.nz // mesh.size)) // BLOCK[0]) * BLOCK[0]
    slab = out.new_empty((rows,) + out.shape[1:3] + (out.shape[3] + 1,))
    res["gather"] = float(np.median([timed(
        lambda: all_gather_cat(mesh, slab))[1] for _ in range(3)]))
    if mesh.rank == 0:
        np.save(os.path.join(workdir, f"grid{mesh.size}.npy"),
                out.cpu().numpy())
    return res


def _clean_job(torch, mesh, workdir, timed):
    """The z-sharded cleaners on phase 10's input at the production
    shape: variational (λ = 200) and projection (2 iterations), a warm-up
    and 3 timed runs each, with the halo exchanges and all-reduces of the
    last run counted; rank 0 saves the fields. A 1-rank world times the
    one-device solve in the same process, in turns with the sharded runs."""
    from ptv_interpolation_tpu_torch import physics
    from ptv_interpolation_tpu_torch.parallel import halo
    u0, v0, w0, mask = (np.load(os.path.join(workdir, f"clean_{n}.npy"))
                        for n in CLEAN_FILES[:4])
    with open(os.path.join(workdir, "clean.json")) as fh:
        spacing = json.load(fh)["spacing"]
    solves = {
        "variational": lambda: physics.clean_divergence_variational(
            u0, v0, w0, mask, *spacing, lambda_reg=CLEAN_LAMBDA, mesh=mesh),
        "projection": lambda: physics.clean_divergence_projection(
            u0, v0, w0, mask, *spacing, iterations=2, mesh=mesh)}
    one_device = {
        "variational": lambda: physics.clean_divergence_variational(
            u0, v0, w0, mask, *spacing, lambda_reg=CLEAN_LAMBDA,
            device=mesh.device),
        "projection": lambda: physics.clean_divergence_projection(
            u0, v0, w0, mask, *spacing, iterations=2, device=mesh.device)}
    out = {}
    with _Recorder(halo, "halo_exchange", lambda _: 1) as halos, \
            _Recorder(halo, "allreduce_sum", lambda _: 1) as sums:
        for method, solve in solves.items():
            res, first = timed(solve)
            walls, peaks, single = [], [], []
            for _ in range(3):
                halos.clear()
                sums.clear()
                torch.cuda.reset_peak_memory_stats(mesh.device)
                res, wall = timed(solve)
                walls.append(wall)
                peaks.append(torch.cuda.max_memory_allocated(mesh.device))
                if mesh.size == 1:     # in turns with the sharded runs
                    single.append(timed(one_device[method])[1])
            out[method] = dict(
                first=first, walls=walls, iterations=res.cg_iterations,
                converged=res.converged, halos=len(halos), sums=len(sums),
                peak=max(peaks), div=(float(res.mean_abs_div_initial),
                                      float(res.mean_abs_div_final)))
            if single:
                out[method]["one_device"] = single
            if mesh.rank == 0:
                np.save(os.path.join(workdir, f"{method}{mesh.size}.npy"),
                        torch.stack(res[:3]).cpu().numpy())
            del res
    if mesh.size > 1:
        # one exchange of a fine-level slab's plane, and one all-reduce of
        # the two dots of an iteration, alone: 50 back to back
        slab = torch.zeros((-(-mask.shape[0] // mesh.size),)
                           + mask.shape[1:], device=mesh.device)
        dots = torch.zeros(2, device=mesh.device)
        for name, fn in (("halo_ms", lambda: halo.halo_exchange(mesh, slab)),
                         ("sum_ms", lambda: halo.allreduce_sum(mesh, dots))):
            timed(fn)
            out[name] = timed(lambda: [fn() for _ in range(50)])[1] * 20.0
    return out


def _step_job(torch, mesh, timed, n):
    """``make_pipeline_step`` on phase 9's density at n³ with a solid
    block, k = 16: a warm-up and 3 timed runs."""
    from ptv_interpolation_tpu_torch.parallel import make_pipeline_step
    pts, vals, grid = uniform_problem(SMALL_POINTS * n ** 3 // SMALL_N ** 3,
                                      n)
    mask = np.ones(grid.shape, bool)
    mask[:, :n // 4, :n // 4] = False
    step = make_pipeline_step(grid, mesh=mesh, k=STEP_K, iterations=1)
    out, first = timed(lambda: step(pts, vals, mask))
    walls = [timed(lambda: step(pts, vals, mask))[1] for _ in range(3)]
    u = torch.stack(out[:3])
    return dict(n=n, first=first, walls=walls, div=float(out[3]),
                finite=bool(torch.isfinite(u).all()),
                solid=int(torch.count_nonzero(u[:, ~torch.as_tensor(
                    mask, device=u.device)])), n_points=len(pts))


def _phase14_rank(rank, world, init, workdir, jobs, step_n):
    """One rank of a phase-14 world, in a process of its own (spawned, so
    it imports no JAX), running ``jobs``: ``grid`` the sharded headline
    path, ``clean`` the z-sharded cleaners at the production shape,
    ``values`` the sharded query path on phase 9's problem, ``step``
    ``make_pipeline_step`` at ``step_n``³. Rank 0 saves the outputs;
    every rank pickles its numbers."""
    import pickle

    import torch
    import torch.distributed as dist
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from ptv_interpolation_tpu_torch.ops.neighbors import bounded_cell_list
    from ptv_interpolation_tpu_torch.parallel import (
        initialize_distributed, make_mesh, sharded_interpolate_values)

    initialize_distributed(init, world, rank)
    try:
        mesh = make_mesh()

        def timed(fn):
            if mesh.size > 1:
                dist.barrier(group=mesh.group)
            torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize(mesh.device)
            return out, time.perf_counter() - t0

        res = dict(backend=mesh.backend, device=str(mesh.device))
        if "grid" in jobs:
            res["grid"] = _grid_job(torch, mesh, workdir, timed)
            torch.cuda.empty_cache()
        if "clean" in jobs:
            res["clean"] = _clean_job(torch, mesh, workdir, timed)
            torch.cuda.empty_cache()
        if "values" in jobs:
            spts, svals, sgrid = uniform_problem()
            cells = bounded_cell_list(spts, 12, 1, device=mesh.device)
            vout, res["values_wall"] = timed(
                lambda: sharded_interpolate_values(
                    spts, svals, sgrid.flat_coords(mesh.device), mesh,
                    method="idw", k=12, cells=cells))
            if rank == 0:
                np.save(os.path.join(workdir, "values.npy"),
                        vout.cpu().numpy())
            del vout
        if "step" in jobs:
            res["step"] = _step_job(torch, mesh, timed, step_n)
        with open(os.path.join(workdir, f"rank{rank}-{world}.pkl"),
                  "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


def _run_world(world, workdir, jobs, step_n=STEP_N):
    """Spawn a phase-14 world and wait for it; a rank that fails or a
    world that runs over its time ends the phase (every rank stopped)."""
    import pickle

    import torch.multiprocessing as mp
    init = "file://" + os.path.join(workdir, f"store{world}")
    ctx = mp.start_processes(_phase14_rank,
                             args=(world, init, workdir, jobs, step_n),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + SHARD_WORLD_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise AssertionError(f"14: the {world}-rank world ran over "
                                     f"{SHARD_WORLD_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}-{world}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    return ranks


def _report_grid(ranks, world, workdir, single_wall, single_out,
                 interior_ref):
    """Phase 14's grid lines and gates for one world; returns kernel 1's
    launches over its ranks."""
    from bench import GRID_N, N_POINTS
    interior, ref = interior_ref
    iz, iy, ix = interior.T
    grid = [r["grid"] for r in ranks]
    got = np.load(os.path.join(workdir, f"grid{world}.npy"))
    walls = [float(np.median(r["walls"])) for r in grid]
    log(f"  median wall of 3 warm runs per rank "
        f"{[round(w, 4) for w in walls]} s (first runs "
        f"{[round(r['first'], 4) for r in grid]} s); phase 4's "
        f"single-device wall {single_wall:.4f} s; the slabs' "
        f"all-gather alone {[round(r['gather'], 4) for r in grid]} s")
    st = [r["stats"] for r in grid]
    log(f"  store per rank {[s['store_bytes'] for s in st]} bytes "
        f"of the whole store's {st[0]['whole_bytes']}; window rows "
        f"{st[0]['n_loc']}, halo {st[0]['halo']:.4f}")
    log(f"  kernel 1 launches per rank (3 runs) "
        f"{[r['launches'] for r in grid]}; uncovered "
        f"{st[0]['uncovered']}, repaired per slab "
        f"{st[0]['repaired']}, n_left {st[0]['n_left']}; peak device "
        f"memory per rank "
        f"{[round(r['peak'] / 2**30, 3) for r in grid]} GiB")
    diff = np.abs(got - single_out)
    close = float(np.isclose(got, single_out, rtol=1e-3, atol=1e-4).mean())
    n_diff = int((diff > 0).any(axis=-1).sum())
    ours = got[iz, iy, ix].astype(np.float64)
    l2 = float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))
    bound = N_POINTS * (1.0 / world + 2.0 * st[0]["halo"] / GRID_N) \
        * SHARD_MEM_SLACK
    log(f"  against the single-device output: largest |Δ| "
        f"{diff.max():.3e}, {n_diff} nodes differ, {close:.6f} of "
        f"values within rtol 1e-3 / atol 1e-4 (limit {SHARD_CLOSE}); "
        f"relative L2 vs f64 scipy on {len(interior)} interior "
        f"nodes {l2:.3e} (limit {L2_LIMIT:.0e}); largest window "
        f"{max(st[0]['n_loc'])} rows (limit {bound:.0f})")
    if not (close >= SHARD_CLOSE and l2 <= L2_LIMIT
            and max(st[0]["n_loc"]) < bound
            and min(r["launches"] for r in grid) > 0):
        raise AssertionError(f"14: the {world}-rank world failed a gate")
    return sum(r["launches"] for r in grid)


def _report_clean(ranks, world, workdir, single):
    """Phase 14's cleaning lines and gates for one world against the
    one-device solves (``single``: method → (fields, iterations))."""
    fluid = np.load(os.path.join(workdir, "clean_mask.npy"))
    no_ops = ", no-ops on one rank" if world == 1 else ""
    if world > 1:
        log(f"  one halo exchange alone (a {fluid.shape[1]}×"
            f"{fluid.shape[2]} plane each way) "
            f"{[round(r['clean']['halo_ms'], 4) for r in ranks]} ms, one "
            f"all-reduce of 2 dots "
            f"{[round(r['clean']['sum_ms'], 4) for r in ranks]} ms per rank")
    for method, (want, want_iters) in single.items():
        cl = [r["clean"][method] for r in ranks]
        got = np.load(os.path.join(workdir, f"{method}{world}.npy"))
        rels = [float(np.linalg.norm(g.astype(np.float64) - w)
                      / np.linalg.norm(w)) for g, w in zip(got, want)]
        iters = cl[0]["iterations"]
        per_it = max(iters, 1)
        n_solid = int(np.count_nonzero(got[:, ~fluid]))
        log(f"  {method}: median wall of 3 warm runs per rank "
            f"{[round(float(np.median(c['walls'])), 4) for c in cl]} s "
            f"(first runs {[round(c['first'], 4) for c in cl]} s); {iters} "
            f"CG iterations (one device "
            f"{want_iters}), converged {cl[0]['converged']}; per CG "
            f"iteration {cl[0]['halos'] / per_it:.1f} halo exchanges and "
            f"{cl[0]['sums'] / per_it:.1f} all-reduces ({cl[0]['halos']} and "
            f"{cl[0]['sums']} in the run{no_ops}); "
            f"peak device memory per rank "
            f"{[round(c['peak'] / 2**30, 3) for c in cl]} GiB")
        log(f"    mean |div| {cl[0]['div'][0]:.6e} → {cl[0]['div'][1]:.6e}; "
            f"relative L2 against the one-device fields u {rels[0]:.3e}, "
            f"v {rels[1]:.3e}, w {rels[2]:.3e} (limit {SHARD_CLEAN_L2:.0e}); "
            f"{n_solid} nonzero solid values")
        if "one_device" in cl[0]:
            log(f"    one device in the rank's process, in turns: median of 3 "
                f"{float(np.median(cl[0]['one_device'])):.4f} s")
        if any(c["iterations"] != iters or c["div"] != cl[0]["div"]
               for c in cl):
            raise AssertionError(f"14: the ranks disagree on {method}")
        if not (cl[0]["converged"] and max(rels) <= SHARD_CLEAN_L2
                and abs(iters - want_iters) <= SHARD_CLEAN_ITERS
                and n_solid == 0 and np.isfinite(got).all()):
            raise AssertionError(f"14: {method} cleaning on {world} ranks "
                                 f"failed a gate")


def _single_cleaning(torch, workdir):
    """The one-device references of phase 14's cleaning, ``method →
    (fields, CG iterations)``: phase 10's variational result (saved), and
    one projection solve (2 iterations) run here."""
    from ptv_interpolation_tpu_torch import physics
    arrays = {n: np.load(os.path.join(workdir, f"clean_{n}.npy"))
              for n in CLEAN_FILES}
    with open(os.path.join(workdir, "clean.json")) as fh:
        meta = json.load(fh)
    proj = physics.clean_divergence_projection(
        *[arrays[n] for n in CLEAN_FILES[:4]], *meta["spacing"],
        iterations=2, device="cuda")
    single = {
        "variational": (np.stack([arrays[n] for n in "uvw"]).astype(
            np.float64), meta["iterations"]),
        "projection": (torch.stack(proj[:3]).cpu().numpy().astype(np.float64),
                       proj.cg_iterations)}
    del proj
    torch.cuda.empty_cache()
    return single


def phase_sharded(torch, single_wall, single_out, interior_ref, workdir,
                  worlds=(1, 2), step_n=STEP_N):
    """Phase 14 in worlds of ``worlds`` ranks — on one card a 1-rank
    world (NCCL) and a 2-rank world (gloo, both ranks on cuda:0); with a
    card per rank, NCCL: ``sharded_grid_interpolate`` on the headline
    problem, and the z-sharded cleaners on phase 10's input (saved in
    ``workdir``); then ``sharded_interpolate_values`` with cells over the
    last world's ranks, ``make_pipeline_step`` at ``step_n``³ in the
    1-rank world, and ``entry.dryrun_multichip(2)``. Returns kernel 1's
    launches summed over every rank's 3 timed runs."""
    from bench import GRID_N, N_POINTS, K
    from ptv_interpolation_tpu_torch.entry import dryrun_multichip
    from ptv_interpolation_tpu_torch.interpolate import interpolate_values
    n_cards = torch.cuda.device_count()
    log(f"== 14. sharded paths over ranks on {n_cards} card(s): "
        f"sharded_grid_interpolate, {N_POINTS} points → {GRID_N}³, sibson "
        f"k={K}, block {BLOCK}; z-sharded cleaning of phase 10's input; "
        f"worlds of {', '.join(map(str, worlds))} ranks (NCCL where each "
        f"rank has a card, else gloo staged through host memory)")
    single = _single_cleaning(torch, workdir)
    launches = 0
    for world in worlds:
        jobs = ("grid", "clean") + (("values",) if world == worlds[-1]
                                    else ()) + (("step",) if world == 1
                                                else ())
        t0 = time.perf_counter()
        ranks = _run_world(world, workdir, jobs, step_n)
        log(f"  {world}-rank world: {time.perf_counter() - t0:.1f} s "
            f"with process start-up; backend {ranks[0]['backend']}, "
            f"devices {[r['device'] for r in ranks]}")
        want = ("nccl" if world <= n_cards else "gloo", "cuda")
        if any((r["backend"], r["device"].split(":")[0]) != want
               for r in ranks):
            raise AssertionError(f"14: the {world}-rank world ran on "
                                 f"{ranks[0]['backend']}, "
                                 f"{ranks[0]['device']}; wanted {want}")
        launches += _report_grid(ranks, world, workdir, single_wall,
                                 single_out, interior_ref)
        _report_clean(ranks, world, workdir, single)
        if "step" in jobs:
            st = ranks[0]["step"]
            log(f"  make_pipeline_step ({st['n_points']} points → "
                f"{st['n']}³, IDW k={STEP_K}, one projection iteration, 1 "
                f"rank): first run {st['first']:.4f} s, median of 3 "
                f"{float(np.median(st['walls'])):.4f} s; mean |div| "
                f"{st['div']:.4e}, every value finite {st['finite']}, "
                f"{st['solid']} nonzero solid values")
            if not (st["finite"] and st["solid"] == 0):
                raise AssertionError("14: make_pipeline_step failed a gate")

    spts, svals, sgrid = uniform_problem()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = interpolate_values(spts, svals, sgrid.flat_coords("cuda"),
                              method="idw", idw_neighbors=12, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = np.load(os.path.join(workdir, "values.npy"))
    same = np.array_equal(got, want.cpu().numpy())
    log(f"  sharded_interpolate_values with cells, {SMALL_POINTS} points "
        f"→ {SMALL_N}³, idw k=12, {worlds[-1]} ranks: "
        f"{[round(r['values_wall'], 4) for r in ranks]} s per rank "
        f"(single device {wall:.4f} s); bit for bit {same}")
    if not same:
        raise AssertionError("14: sharded_interpolate_values differs "
                             "from the single-device result")
    del want
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun_multichip(2)
    log(f"  entry.dryrun_multichip(2) on the card: "
        f"{time.perf_counter() - t0:.1f} s with process start-up")
    return launches


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from bench import GRID_N, K, make_problem
    from ptv_interpolation_tpu_torch.grid import create_grid

    smi = phase_environment(torch)
    phase_build()
    pts, vals = make_problem()
    grid = create_grid(((0, GRID_N + 1),) * 3, GRID_N)
    max_err, ms, plain_ms, bound_ms, bound_by = phase_kernel(
        torch, pts, vals, grid, K)
    launches, single_wall, single_out, interior_ref = phase_main_path(
        torch, pts, vals, grid, K)
    del pts, vals
    problem = make_pipeline_problem()
    mad_err, mad_ms, mad_plain_ms, mad_bound_ms, mad_bound_by = \
        phase_mad_kernel(torch, *problem)
    (mad_launches, grid_launches), uncleaned = phase_pipeline(torch,
                                                              *problem)
    pts, vals = make_problem()
    pl_err, pl_ms, pl_plain_ms, pl_bound_ms, pl_bound_by = \
        phase_pallas_kernel(torch, pts, vals, grid, K)
    pl_launches = phase_pallas_path(torch, pts, vals, grid, K)
    del pts, vals
    phase_other_routes(torch, K)
    fluid, pts, vals = problem[:3]
    shard_dir = tempfile.TemporaryDirectory()      # phase 10 → phase 14
    clean_mad, clean_grid = phase_cleaning(torch, fluid, pts, vals, uncleaned,
                                           shard_dir.name)
    del problem, uncleaned
    torch.cuda.empty_cache()
    phase_other_methods(torch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:    # 12a's files, for 13
        cli_mad, cli_grid = phase_cli(torch, fluid, pts, vals, tmp)
        torch.cuda.empty_cache()
        phase_analysis(torch)
        torch.cuda.empty_cache()
        phase_validations(torch)
        torch.cuda.empty_cache()
        phase_tools(torch, tmp, pts, vals)
        torch.cuda.empty_cache()
        phase_daemon(torch, tmp)
        phase_approx(torch, K)
    del fluid, pts, vals
    torch.cuda.empty_cache()
    with shard_dir:
        shard_launches = phase_sharded(torch, single_wall, single_out,
                                       interior_ref, shard_dir.name)
    log(f"launches: fused_grid_knn {launches} (phase 4) + {grid_launches} "
        f"(phase 6) + {clean_grid} (phase 10) + {cli_grid} (phase 12a) + "
        f"{shard_launches} (phase 14, every rank); "
        f"fused_mad {mad_launches} (phase 6) + {clean_mad} (phase 10) + "
        f"{cli_mad} (phase 12a); pallas_grid_knn {pl_launches} (phase 8)")
    log(smi)                     # the card again, for a log read from its tail
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": [{
        "name": "fused_grid_knn",
        "route": "cuda",
        "source": "ptv_interpolation_tpu_torch/ops/csrc/fused_grid_knn.cu",
        "replaces": "ptv_interpolation_tpu/ops/fused_grid_knn.py:175",
        "launches": (launches + grid_launches + clean_grid + cli_grid
                     + shard_launches),
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "fused_mad",
        "route": "cuda",
        "source": "ptv_interpolation_tpu_torch/ops/csrc/fused_mad.cu",
        "replaces": "ptv_interpolation_tpu/ops/fused_mad.py:93",
        "launches": mad_launches + clean_mad + cli_mad,
        "max_abs_err": mad_err,
        "ms": mad_ms,
        "plain_ms": mad_plain_ms,
        "bound_ms": mad_bound_ms,
        "bound_by": mad_bound_by,
        "library_ms": None,
    }, {
        "name": "pallas_grid_knn",
        "route": "cuda",
        "source": "ptv_interpolation_tpu_torch/ops/csrc/pallas_grid_knn.cu",
        "replaces": "ptv_interpolation_tpu/ops/pallas_grid_knn.py:51",
        "launches": pl_launches,
        "max_abs_err": pl_err,
        "ms": pl_ms,
        "plain_ms": pl_plain_ms,
        "bound_ms": pl_bound_ms,
        "bound_by": pl_bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
