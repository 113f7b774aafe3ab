"""Datasets of the porous-glass deployment, made from the seed.

The solid is the formula of the repository's production-shape problem,
``sin(0.08 z) · sin(0.14 y) · sin(0.11 x) > 0.55`` evaluated at half the
raw-voxel offsets from the crop's centre (about 92% fluid), on the crop of
the upstream's scan, ``raw_shape_zyx`` = 486 × 337 × 322 (y 160-497 is 337
rows). It is separable, so it is one outer product, and the same for every
seed. Each dataset then draws ``n_tracks`` tracks uniform in the fluid,
gives them the production-shape field at half their raw coordinates, and
scales a share of them (``outliers``) to plant speed-threshold and MAD
outliers. Dataset ``i`` of seed ``s`` comes from the generator seeded with
``(s, i)``, so every seed gives the same sizes."""

import numpy as np


def fluid_mask(config):
    nz, ny, nx = config["raw_shape_zyx"]
    a, b = config["solid_formula"]["rates_zyx"], config["solid_formula"]["level"]
    az, ay, ax = ((np.arange(n) - n / 2) / 2 for n in (nz, ny, nx))
    solid = ((np.sin(az * a[0])[:, None, None] * np.sin(ay * a[1])[None, :, None])
             * np.sin(ax * a[2])[None, None, :]) > b
    return ~solid


def make_dataset(config, fluid, seed, index):
    nz, ny, nx = fluid.shape
    n = int(config["n_tracks"])
    rng = np.random.default_rng([seed % 2**64, index])
    pts = rng.uniform((0, 0, 0), (nx, ny, nz),
                      size=(int(n * 1.3), 3)).astype(np.float32)
    idx = np.clip(pts.astype(int), 0, (nx - 1, ny - 1, nz - 1))
    pts = pts[fluid[idx[:, 2], idx[:, 1], idx[:, 0]]]
    if len(pts) < n:
        raise RuntimeError(f"only {len(pts)} of {n} tracks fell in the fluid")
    pts = np.ascontiguousarray(pts[:n])
    half = pts / 2
    vals = np.stack([0.05 * np.sin(half[:, 0] * 0.05),
                     0.05 * np.cos(half[:, 1] * 0.04),
                     1.0 + 0.1 * np.sin(half[:, 2] * 0.03)],
                    axis=-1).astype(np.float32)
    planted = {}
    chosen = rng.permutation(n)
    at = 0
    for kind in ("threshold", "mad"):
        share, scale = config["outliers"][kind]
        m = int(round(share * n))
        rows = np.sort(chosen[at:at + m])
        at += m
        vals[rows] *= np.float32(scale)
        planted[kind] = rows
    return {"index": index, "points": pts, "values": vals, "fluid": fluid,
            "planted": planted}


def make_pool(config, seed, size):
    fluid = fluid_mask(config)
    return [make_dataset(config, fluid, seed, i) for i in range(size)]


def sizes(ctx, dataset):
    """The work kernels 1 and 2 have to do on ``dataset``, from the
    problem's sizes: the fluid nodes, the tracks the speed threshold
    keeps, and the boundary particles."""
    from perfbench.reference import porous
    key = ("porous_sizes",)
    if key not in ctx.cache:
        fluid = dataset["fluid"]
        cfg = ctx.config
        res = porous.resolution(fluid.shape, float(cfg["downscale"]))
        nodes = int(porous.mask_on_grid(fluid, res).sum())
        nb = len(porous.boundary_voxels(fluid, cfg["boundary_thickness"],
                                        cfg["boundary_sampling"], ctx.device))
        ctx.cache[key] = (nodes, nb)
    nodes, nb = ctx.cache[key]
    v = dataset["values"].astype(np.float64)
    kept = int((np.sqrt((v * v).sum(axis=1)) <= ctx.config["filter_max_speed"])
               .sum())
    return {"k1_nodes": nodes, "k1_k": int(ctx.config["sibson_neighbors"]),
            "k1_points": kept + nb, "k2_points": kept,
            "k2_k": int(ctx.config["filter_neighbors"])}
