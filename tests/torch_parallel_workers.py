"""Rank workers for the port's multi-process tests: a gloo world on the CPU,
spawned once per test module. This module imports no JAX — a spawned
child imports the module of the function it runs, and the port must run
without JAX.

:func:`run_world` spawns ``world`` processes; each joins the group through
a ``file://`` store in the test's temporary directory (no fixed TCP port,
so test workers that run side by side cannot collide), builds a mesh of
the first ``n`` ranks for every ``n`` the cases name, runs every case on
the ranks of its mesh and pickles its results; the parent reads them back
as ``{(case name, rank): result}``."""

import os
import pickle
import time

import numpy as np
import torch


def problem():
    """``tests/test_sharding.py``'s problem: 800 points in [0, 16)³, three
    channels, 700 queries."""
    rng = np.random.default_rng(11)
    points = rng.uniform(0, 16, size=(800, 3)).astype(np.float32)
    values = np.stack([np.sin(points[:, 0]), np.cos(points[:, 1]),
                       np.ones(800)], axis=-1).astype(np.float32)
    queries = rng.uniform(1, 15, size=(700, 3)).astype(np.float32)
    return points, values, queries


def void_cloud(seed):
    """``tests/test_sharding.py``'s void-region clouds: 600 points in
    z < 5 of a 16-voxel domain."""
    rng = np.random.default_rng(seed)
    points = rng.uniform([0, 0, 0], [16, 16, 5], size=(600, 3)).astype(
        np.float32)
    values = np.stack([np.sin(points[:, 0]), np.cos(points[:, 1]),
                       np.ones(600)], axis=-1).astype(np.float32)
    return points, values


def many_queries(n_q=3000, seed=5):
    """Queries over three default tiles of 1 024, for the comparison with
    the single-device ``interpolate_values``."""
    rng = np.random.default_rng(seed)
    return rng.uniform(1, 15, size=(n_q, 3)).astype(np.float32)


def _grid():
    from ptv_interpolation_tpu_torch.grid import create_grid
    return create_grid(((0, 17), (0, 17), (0, 17)), 16)


def _case_values(mesh, method):
    """Sharded IDW / sibson: JAX's call (query_tile 32), and the default
    tiles against the single-device ``interpolate_values``, by brute
    force and through the cell list."""
    from ptv_interpolation_tpu_torch.interpolate import (idw_interpolate,
                                                         interpolate_values,
                                                         sibson_interpolate)
    from ptv_interpolation_tpu_torch.ops.neighbors import bounded_cell_list
    from ptv_interpolation_tpu_torch.parallel import (
        sharded_interpolate_values)
    points, values, queries = problem()
    got = sharded_interpolate_values(points, values, queries, mesh,
                                     method=method, k=12, query_tile=32)
    single = (idw_interpolate if method == "idw" else sibson_interpolate)(
        points, values, queries, k=12, query_tile=32, device="cpu")
    q2 = many_queries()
    got2 = sharded_interpolate_values(points, values, q2, mesh,
                                      method=method, k=12)
    want2 = interpolate_values(points, values, q2, method=method,
                               idw_neighbors=12, sibson_neighbors=12,
                               device="cpu")
    cells = bounded_cell_list(points, 12, 1, device="cpu")
    got3 = sharded_interpolate_values(points, values, q2, mesh,
                                      method=method, k=12, cells=cells)
    want3 = interpolate_values(points, values, q2, method=method,
                               idw_neighbors=12, sibson_neighbors=12,
                               neighbor_method="celllist", device="cpu")
    return {"got": got.numpy(), "single": single.numpy(),
            "got_default": got2.numpy(), "single_default": want2.numpy(),
            "got_cells": got3.numpy(), "single_cells": want3.numpy()}


def _case_grid(mesh, cloud, backend):
    from ptv_interpolation_tpu_torch.parallel.sharding import (
        sharded_grid_interpolate)
    points, values = problem()[:2] if cloud == "problem" else void_cloud(
        {"void21": 21, "void23": 23}[cloud])
    got = sharded_grid_interpolate(points, values, _grid(), mesh,
                                   method="sibson", k=12, block=(2, 8, 8),
                                   backend=backend)
    return {"got": got.numpy(),
            "stats": sharded_grid_interpolate.last_stats}


def _case_checkpoint(mesh, path):
    from ptv_interpolation_tpu_torch.io.checkpoint import load_checkpoint
    back = load_checkpoint(path, device="cpu", mesh=mesh)
    return {name: (getattr(back, name).numpy() if torch.is_tensor(
        getattr(back, name)) else getattr(back, name))
        for name in ("x", "y", "z", "u", "v", "w", "mask")}


def clean_problem(shape=(16, 16, 16)):
    """``tests/test_sharding.py``'s cleaning problem: a mask with a solid
    column ``[:, :4, :4]`` and seeded normal fields, zero on solid."""
    rng = np.random.default_rng(12)
    mask = np.ones(shape, bool)
    mask[:, :4, :4] = False
    u, v, w = (rng.normal(size=shape).astype(np.float32) * mask
               for _ in range(3))
    return mask, u, v, w


def clean(mask, u, v, w, method, mesh=None, device="cpu"):
    """The mirror's two solves: projection (2 iterations) and variational
    at λ = 50, unit spacing."""
    from ptv_interpolation_tpu_torch.physics import (
        clean_divergence_projection, clean_divergence_variational)
    if method == "projection":
        return clean_divergence_projection(u, v, w, mask, 1., 1., 1.,
                                           iterations=2, device=device,
                                           mesh=mesh)
    return clean_divergence_variational(u, v, w, mask, 1., 1., 1.,
                                        lambda_reg=50.0, device=device,
                                        mesh=mesh)


def stencil_problem(shape=(19, 10, 12)):
    """A mask whose fluid touches all six faces (70% fluid at random),
    three fields, a potential and the anisotropic spacing."""
    rng = np.random.default_rng(31)
    mask = rng.random(shape) > 0.3
    u, v, w, phi = (rng.normal(size=shape).astype(np.float32)
                    for _ in range(4))
    return mask, (u, v, w), phi, (1.0, 0.9, 1.2)


# the slab operators of ``physics._SlabGrid`` and the rule itself applied
# to ``consistent_divergence``'s 'operator' variant: name → the plan's
# unit (2 for the variational cleaner's operators)
STENCIL_UNITS = {"divergence": 1, "divergence_operator": 1, "neg_lap": 1,
                 "jacobi": 1, "correction": 1, "div_op": 2, "div_op_T": 2,
                 "woodbury_S": 2, "direct_A": 2, "dtd_diag": 2}
STENCIL_LAMBDA = 50.0


def slab_stencil(g, name, fields, phi):
    """The slab operator ``name`` on this rank's slabs, as a tuple."""
    from ptv_interpolation_tpu_torch.ops.stencils import consistent_divergence
    sl = g.slabs
    u, v, w = (g.slabs.take(f) for f in fields)
    q = sl.take(phi)
    if name == "divergence":
        return (g.divergence(u, v, w),)
    if name == "divergence_operator":
        return (sl.crop(consistent_divergence(
            sl.extend(u), sl.extend(v), sl.extend(w), g.mask_e[0], *g.h,
            variant="operator")),)
    if name == "neg_lap":
        return (g.neg_lap(q),)
    if name == "jacobi":
        return (g.jacobi(),)
    if name == "correction":
        return g.correction(u, v, w, q)
    if name == "div_op":
        return (g.div_op((u, v, w)),)
    if name == "div_op_T":
        return g.div_op_T(q)
    if name == "woodbury_S":
        return (g.woodbury_S(q, STENCIL_LAMBDA),)
    if name == "direct_A":
        return g.direct_A((u, v, w), STENCIL_LAMBDA)
    if name == "dtd_diag":
        return g.dtd_diag()
    raise ValueError(name)


def _case_stencils(mesh):
    from ptv_interpolation_tpu_torch.physics import _SlabGrid
    mask, fields, phi, h = stencil_problem()
    out = {}
    for name, unit in STENCIL_UNITS.items():
        g = _SlabGrid(mask, mesh, 1, unit, h)
        out[name] = ((g.slabs.z0, g.slabs.z1),
                     [t.numpy() for t in slab_stencil(g, name, fields, phi)])
    return out


# V-cycle cases: (mask shape, parity-batched with screening)
VCYCLE_CASES = {"poisson24": ((24, 20, 22), False),
                "poisson37": ((37, 20, 18), False),
                "parity37": ((37, 20, 18), True)}


def vcycle_problem(name):
    """The mask (8 parity sublattices for a parity case), a residual on
    it, and ``make_mg_preconditioner``'s keywords."""
    from ptv_interpolation_tpu_torch.physics import _parity_maps
    shape, parity = VCYCLE_CASES[name]
    rng = np.random.default_rng(41)
    mask = torch.as_tensor(rng.random(shape) > 0.25)
    mask[:, :5, :5] = False
    r = torch.as_tensor(rng.normal(size=shape).astype(np.float32)) * mask
    kw = dict(dx=1.0, dy=0.9, dz=1.2)
    if parity:
        to_parity = _parity_maps(shape)[0]
        mask, r = to_parity(mask), to_parity(r)
        kw = dict(dx=2.0, dy=1.8, dz=2.4, screening=1.0 / 200.0)
    return mask, r, kw


def _case_vcycle(mesh):
    from ptv_interpolation_tpu_torch.ops.multigrid import (
        make_mg_preconditioner, mg_level_count)
    from ptv_interpolation_tpu_torch.parallel.halo import (ZSlabs,
                                                           mg_slab_plan)
    out = {}
    for name in VCYCLE_CASES:
        mask, r, kw = vcycle_problem(name)
        bounds, n_sharded = mg_slab_plan(mask.shape[-3], mesh,
                                         mg_level_count(mask.shape))
        slabs = ZSlabs(mesh, bounds)
        m_inv = make_mg_preconditioner(mask, slabs=slabs,
                                       n_sharded=n_sharded, **kw)
        out[name] = (bounds[mesh.rank], n_sharded,
                     m_inv(slabs.take(r)).numpy())
    return out


def _case_clean(mesh, shape, method):
    res = clean(*clean_problem(shape), method, mesh=mesh)
    return {"uvw": np.stack([t.numpy() for t in res[:3]]),
            "div": (float(res.mean_abs_div_initial),
                    float(res.mean_abs_div_final)),
            "iterations": res.cg_iterations, "converged": res.converged}


def _case_step(mesh):
    from ptv_interpolation_tpu_torch.entry import _tiny_problem
    from ptv_interpolation_tpu_torch.parallel import make_pipeline_step
    grid, points, values, mask = _tiny_problem()
    out = make_pipeline_step(grid, mesh=mesh, k=8, iterations=1,
                             query_tile=64)(points, values, mask)
    return {"uvw": np.stack([t.numpy() for t in out[:3]]),
            "div": float(out[3])}


def _run_case(mesh, case):
    kind = case["kind"]
    if kind == "values":
        return _case_values(mesh, case["method"])
    if kind == "grid":
        return _case_grid(mesh, case["cloud"], case["backend"])
    if kind == "checkpoint":
        return _case_checkpoint(mesh, case["path"])
    if kind == "clean":
        return _case_clean(mesh, case["shape"], case["method"])
    if kind == "stencils":
        return _case_stencils(mesh)
    if kind == "vcycle":
        return _case_vcycle(mesh)
    if kind == "step":
        return _case_step(mesh)
    raise ValueError(f"unknown case kind {kind!r}")


def _rank_main(rank, world, workdir, cases):
    torch.set_num_threads(1)
    from ptv_interpolation_tpu_torch.parallel import (initialize_distributed,
                                                      make_mesh)
    import torch.distributed as dist
    store = os.path.join(workdir, "store")
    initialize_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        meshes = {n: make_mesh(n, device="cpu")
                  for n in sorted({c["n"] for c in cases})}
        results = {}
        for case in cases:
            mesh = meshes[case["n"]]
            if mesh is not None:
                results[case["name"]] = _run_case(mesh, case)
            dist.barrier()
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_world(world, workdir, cases, timeout=300):
    """Spawn ``world`` ranks that run ``cases`` (dicts with ``name``,
    ``kind``, ``n`` and the kind's arguments); returns ``{(name, rank):
    result}``."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, workdir, cases),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {world}-rank world ran over {timeout} s")
    out = {}
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            for name, res in pickle.load(f).items():
                out[(name, rank)] = res
    return out
