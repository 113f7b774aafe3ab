"""The reference local-RBF field of a grid configuration, worked out
once per dataset and dtype (``reference/rbf_local.py``)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.lib.checking import grid_axes
from perfbench.reference import porous
from perfbench.reference.rbf_local import rbf_local


def reference(ctx, dataset, dtype=torch.float64):
    """The reference field (3, nz, ny, nx) at every node of the
    configuration's grid, with its flags, computed in ``dtype`` on the
    run's device."""
    key = ("rbf_grid", dataset["index"], dtype)
    if key not in ctx.cache:
        cfg = ctx.config
        xs, ys, zs = (torch.as_tensor(a, device=ctx.device)
                      for a in grid_axes(cfg))
        Z, Y, X = torch.meshgrid(zs, ys, xs, indexing="ij")
        nodes = torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], 1)
        p, v = (torch.as_tensor(np.asarray(dataset[key_], np.float64),
                                device=ctx.device).to(dtype)
                for key_ in ("points", "values"))
        k = int(cfg["rbf_neighbors"])
        extent = [hi - lo for lo, hi in cfg["grid_bounds"]]
        vals = rbf_local(p, v, nodes.to(dtype), k,
                         porous.knn_cell(len(p), extent, k),
                         kernel=cfg["rbf_kernel"],
                         epsilon=float(cfg["epsilon"]),
                         smoothing=float(cfg["smoothing"]),
                         degree=int(cfg["degree"]))
        ctx.cache[key] = vals.T.reshape((3,) + Z.shape)
    return ctx.cache[key]
