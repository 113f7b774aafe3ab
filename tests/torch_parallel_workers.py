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


def _run_case(mesh, case):
    kind = case["kind"]
    if kind == "values":
        return _case_values(mesh, case["method"])
    if kind == "grid":
        return _case_grid(mesh, case["cloud"], case["backend"])
    if kind == "checkpoint":
        return _case_checkpoint(mesh, case["path"])
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
