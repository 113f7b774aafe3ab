"""What the checks share: the reference's answers for a dataset, worked
out once per dataset and dtype, and the numbers that hold the program's
answers against them.

Every number is computed in float64 on the run's device. A relative L2
is ``‖got − want‖ / ‖want‖`` over the three components at the nodes of a
region; a gap is ``max |got − want| / max |want|`` over them. A NaN in
the program's answer gives a NaN number, which no limit admits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import porous
from perfbench.reference.sibson import sibson


def as_field(arrays, device):
    """(3, …) float64 tensor on ``device`` from three arrays or tensors."""
    return torch.stack([torch.as_tensor(np.asarray(a) if not
                                        torch.is_tensor(a) else a)
                        .to(device=device, dtype=torch.float64)
                        for a in arrays])


def rel_l2(got, want, region):
    if not bool(region.any()):
        return 0.0
    d, w = (got - want)[:, region], want[:, region]
    return float(d.norm() / w.norm())


def gap(got, want, region):
    if not bool(region.any()):
        return 0.0
    d, w = (got - want)[:, region], want[:, region]
    return float(d.abs().max() / w.abs().max())


def face_nodes(shape, device):
    """Nodes on any face of a (nz, ny, nx) grid."""
    face = torch.zeros(shape, dtype=torch.bool, device=device)
    for dim in range(3):
        face.narrow(dim, 0, 1).fill_(True)
        face.narrow(dim, shape[dim] - 1, 1).fill_(True)
    return face


def wall_nodes(mask):
    """Fluid nodes with a solid face neighbour inside the grid."""
    solid = ~mask
    near = torch.zeros_like(mask)
    for dim in range(3):
        n = mask.shape[dim]
        near.narrow(dim, 1, n - 1).logical_or_(solid.narrow(dim, 0, n - 1))
        near.narrow(dim, 0, n - 1).logical_or_(solid.narrow(dim, 1, n - 1))
    return mask & near


def porous_reference(ctx, dataset, dtype=torch.float64):
    """The reference pipeline on ``dataset`` with the flags the program
    ran with, cached per dataset and dtype (cleaned where the flags say
    ``divergence_free``)."""
    key = ("porous", dataset["index"], dtype)
    if key not in ctx.cache:
        flags = dataclasses.asdict(ctx.states["run_pipeline"])
        ctx.cache[key] = porous.run(
            flags, dataset["points"], dataset["values"], dataset["fluid"],
            dtype, ctx.device, clean=bool(flags["divergence_free"]))
    return ctx.cache[key]


def grid_axes(config):
    """x, y, z node coordinates of a configuration's grid, float64."""
    (bx, by, bz), n = config["grid_bounds"], config["grid_n"]
    return [porous.axis(lo, hi, n) for lo, hi in (bx, by, bz)]


def grid_reference(ctx, dataset, dtype=torch.float64):
    """The reference sibson field (3, nz, ny, nx) at every node of the
    configuration's grid, cached per dataset and dtype."""
    key = ("grid", dataset["index"], dtype)
    if key not in ctx.cache:
        cfg = ctx.config
        xs, ys, zs = (torch.as_tensor(a, device=ctx.device)
                      for a in grid_axes(cfg))
        Z, Y, X = torch.meshgrid(zs, ys, xs, indexing="ij")
        nodes = torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], 1)
        p = torch.as_tensor(np.asarray(dataset["points"], np.float64),
                            device=ctx.device).to(dtype)
        v = torch.as_tensor(np.asarray(dataset["values"], np.float64),
                            device=ctx.device).to(dtype)
        k = min(int(cfg["sibson_neighbors"]), len(p))
        extent = [hi - lo for lo, hi in cfg["grid_bounds"]]
        vals = sibson(p, v, nodes.to(dtype), k,
                      porous.knn_cell(len(p), extent, k))
        ctx.cache[key] = vals.T.reshape((3,) + Z.shape)
    return ctx.cache[key]
