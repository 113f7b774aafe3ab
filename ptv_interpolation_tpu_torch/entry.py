"""Entry points of the pipeline step: a one-device forward step and a
multi-rank dry run.

Counterpart of the repository's ``__graft_entry__.py``, which jits the JAX
step on one chip (``entry``) and over a virtual CPU mesh
(``dryrun_multichip``). Here :func:`entry` builds the step on one device
and :func:`dryrun_multichip` spawns one process per rank — NCCL where every
rank has a card, gloo otherwise (``device="cpu"``, or more ranks than
cards) — and runs the sharded paths on the ranks.

Run on the card: ``python -m ptv_interpolation_tpu_torch.entry [n_ranks]``.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import resolve_device

# seconds the ranks of dryrun_multichip may take, process start-up included
_DRYRUN_TIMEOUT = 600.0


def _tiny_problem(grid_res=16, n_points=512, seed=0):
    """``__graft_entry__.py``'s problem: 512 points in [0, 16)³ with smooth
    values, the 16³ grid, and a fluid mask with a solid block."""
    from ptv_interpolation_tpu_torch.grid import create_grid

    rng = np.random.default_rng(seed)
    points = rng.uniform(0.0, float(grid_res),
                         size=(n_points, 3)).astype(np.float32)
    u = np.sin(points[:, 0] * 0.3).astype(np.float32)
    v = np.cos(points[:, 1] * 0.2).astype(np.float32)
    w = np.ones(n_points, np.float32)
    values = np.stack([u, v, w], axis=-1)
    grid = create_grid(((0, grid_res), (0, grid_res), (0, grid_res)), grid_res)
    mask = np.ones(grid.shape, bool)
    mask[:, : grid_res // 4, : grid_res // 4] = False  # a solid block
    return grid, points, values, mask


def entry(device="cuda"):
    """``(fn, example_args)``: the pipeline step (IDW onto the grid, mask
    zeroing, one projection-cleaning iteration; k = 8) on one device, and
    its arguments as tensors there. ``fn(*example_args)`` returns ``(u,
    v, w, mean_abs_div_final)``."""
    from ptv_interpolation_tpu_torch.parallel.sharding import (
        make_pipeline_step)

    dev = resolve_device(device)
    grid, points, values, mask = _tiny_problem()
    fn = make_pipeline_step(grid, mesh=None, k=8, iterations=1, device=dev)
    example_args = tuple(torch.as_tensor(a, device=dev)
                         for a in (points, values, mask))
    return fn, example_args


def _check_finite(what, t):
    if not bool(torch.isfinite(torch.as_tensor(t)).all()):
        raise AssertionError(f"dryrun_multichip: {what} is not finite")


def _dryrun_rank(rank, world, init, device_type):
    """One rank of :func:`dryrun_multichip`, in a process of its own."""
    import torch.distributed as dist

    from ptv_interpolation_tpu_torch.parallel import (
        initialize_distributed, make_mesh, make_pipeline_step,
        sharded_interpolate_values)
    from ptv_interpolation_tpu_torch.parallel.sharding import (
        sharded_grid_interpolate)
    from ptv_interpolation_tpu_torch.physics import (
        clean_divergence_variational)

    initialize_distributed(init, world, rank, device=device_type)
    try:
        mesh = make_mesh(device=device_type)
        grid, points, values, mask = _tiny_problem()
        # the whole step: queries sharded, cleaning on z-slabs
        step = make_pipeline_step(grid, mesh=mesh, k=8, iterations=1,
                                  query_tile=64)
        u, v, w, div = step(points, values, mask)
        _check_finite("the step's mean |div|", div)
        # the variational solve on z-slabs
        res = clean_divergence_variational(u, v, w, mask, *grid.spacing,
                                           lambda_reg=10.0, maxiter=50,
                                           mesh=mesh)
        _check_finite("the variational cleaning", torch.stack(res[:3]))
        # the query-sharded path with sibson weights
        out = sharded_interpolate_values(
            points, values, grid.flat_coords(mesh.device)[:1000], mesh,
            method="sibson", k=8, query_tile=64)
        _check_finite("sharded_interpolate_values", out)
        # the block-centric grid path over z-slabs, streaming and fused
        for backend in ("xla", "fused"):
            out = sharded_grid_interpolate(points, values, grid, mesh,
                                           method="sibson", k=8,
                                           block=(2, 8, 8), backend=backend)
            _check_finite(f"sharded_grid_interpolate({backend!r})", out)
        if rank == 0:
            print(f"dryrun_multichip: OK on {world} ranks ({mesh.backend}, "
                  f"{mesh.device.type}; mean |div| after cleaning = "
                  f"{float(div):.3e})", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda"):
    """Run the pipeline step and the sharded paths over ``n_devices``
    ranks on tiny shapes: the step on the mesh, variational cleaning on
    the mesh (λ = 10, ``maxiter=50``), ``sharded_interpolate_values``
    (sibson, k = 8, ``query_tile=64``) and ``sharded_grid_interpolate``
    with ``backend='xla'`` and ``'fused'`` (block (2, 8, 8)), each checked
    finite. One spawned process per rank; raises if any rank fails or the
    world runs over ``_DRYRUN_TIMEOUT`` seconds (every rank is stopped)."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as workdir:
        init = "file://" + os.path.join(workdir, "store")
        ctx = mp.start_processes(_dryrun_rank,
                                 args=(n_devices, init, dev.type),
                                 nprocs=n_devices, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + _DRYRUN_TIMEOUT
        try:
            # join() raises when a rank exits with an error
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dryrun_multichip: {n_devices} "
                                       f"ranks ran over {_DRYRUN_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    _check_finite("the step's mean |div|", out[3])
    print("entry OK:", [tuple(o.shape) for o in out[:3]], float(out[3]))
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
