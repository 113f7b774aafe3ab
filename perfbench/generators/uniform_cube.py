"""Datasets of the uniform-cube deployment, made from the seed:
``n_points`` tracks uniform in ``[0, extent)³`` carrying the field of the
repository's headline problem. Dataset ``i`` of seed ``s`` comes from the
generator seeded with ``(s, i)``."""

import numpy as np


def make_dataset(config, seed, index):
    rng = np.random.default_rng([seed % 2**64, index])
    n, e = int(config["n_points"]), float(config["extent"])
    pts = rng.uniform(0, e, size=(n, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.05), np.cos(pts[:, 1] * 0.04),
                     1.0 + 0.1 * np.sin(pts[:, 2] * 0.03)],
                    axis=-1).astype(np.float32)
    return {"index": index, "points": pts, "values": vals}


def make_pool(config, seed, size):
    return [make_dataset(config, seed, i) for i in range(size)]


def sizes(ctx, dataset):
    """Kernel 1's work: every node of the grid weighs its k neighbours."""
    return {"k1_nodes": int(ctx.config["grid_n"]) ** 3,
            "k1_k": int(ctx.config["sibson_neighbors"]),
            "k1_points": len(dataset["points"])}
