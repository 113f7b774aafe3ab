"""The uniform-cube datasets (``uniform_cube``'s: the same seed and index
give the same tracks) and the work of one local-RBF grid call."""

from pathlib import Path

from perfbench.lib.manifest import load_module

_CUBE = load_module(Path(__file__).resolve().parent, "uniform_cube")
make_pool = _CUBE.make_pool


def sizes(ctx, dataset):
    """Every node of the grid fits and evaluates one local model of its
    k neighbours and the m terms of the polynomial."""
    from perfbench.reference.rbf_local import monomial_powers
    cfg = ctx.config
    return {"rbf_nodes": int(cfg["grid_n"]) ** 3,
            "rbf_k": int(cfg["rbf_neighbors"]),
            "rbf_m": len(monomial_powers(int(cfg["degree"]))),
            "rbf_points": len(dataset["points"]),
            "rbf_channels": int(dataset["values"].shape[1])}
