"""The port's local RBF on a grid (``interpolate_field(method="rbf")``,
the two-stage grid route) against the benchmark's plain reference
(``perfbench/reference/rbf_local.py``), the reference against scipy's
``RBFInterpolator(neighbors=k)``, and the route's spans and counters.

The grid case is the benchmark cell's density (1M tracks per 256³) on a
40³ grid: 3815 tracks uniform in [0, 40)³ onto nodes over [0, 40]³. Its
seed leaves two face nodes whose k-set reaches past their block's region
and misses a nearer track."""

import numpy as np
import pytest
import torch
from scipy.interpolate import RBFInterpolator

from perfbench.reference import porous
from perfbench.reference.knn import knn
from perfbench.reference.rbf_local import rbf_local
from ptv_interpolation_tpu_torch.grid import create_grid
import torch_port_fixtures as fx

torch.set_num_threads(2)

K = 20
BLOCK = (4, 8, 16)            # the grid route's default block
# Interior nodes: the port solves in f32 (Gauss–Jordan, systems of
# condition up to ~1e4) with 1e-6·max|K| on the kernel's diagonal, and
# reads 6.8e-7. Face nodes also hold the nodes whose k-set reaches past
# the region (here two, 1.5e-5 in all).
TOL = {"interior": 1e-5, "face": 1e-4}


def reference(pts, vals, grid, dtype=torch.float64):
    p, v, q = (torch.tensor(a, dtype=torch.float64).to(dtype)
               for a in (pts, vals, fx.grid_nodes(grid)))
    cell = porous.knn_cell(len(pts), [hi - lo for lo, hi in grid.bounds], K)
    return rbf_local(p, v, q, K, cell).double()


@pytest.fixture(scope="module")
def route():
    pts, vals, bounds, n = fx.cell_density_cube()
    grid = create_grid(bounds, n)
    out = fx.rbf_grid_route(pts, vals, grid, K, "cpu")
    out.update(pts=pts, vals=vals, grid=grid, n=n)
    return out


@pytest.fixture(scope="module")
def want(route):
    return reference(route["pts"], route["vals"], route["grid"])


def rel_l2(got, want, rows):
    return float((got - want)[rows].norm() / want[rows].norm())


@pytest.mark.parametrize("smoothing", [0.0, 5.0])
def test_reference_matches_scipy(smoothing):
    """scipy's local RBF in f64, queries inside and just outside the
    cloud: the same values to 1e-10 of the largest (the same systems,
    solved by LU in both)."""
    rng = np.random.default_rng(7)
    p = rng.uniform(0, 40, (3000, 3))
    v = np.stack([np.sin(p[:, 0] * 0.2), np.cos(p[:, 1] * 0.15),
                  p[:, 2] * 0.01], -1)
    q = rng.uniform(-1, 41, (500, 3))
    expect = RBFInterpolator(p, v, neighbors=K, kernel="thin_plate_spline",
                             smoothing=smoothing)(q)
    got = rbf_local(torch.tensor(p), torch.tensor(v), torch.tensor(q), K,
                    6.0, smoothing=smoothing).numpy()
    assert np.abs(got - expect).max() <= 1e-10 * np.abs(expect).max()


@pytest.mark.parametrize("region", ["interior", "face"])
def test_port_matches_reference(route, want, region):
    face = fx.face_rows(route["grid"].shape)
    rows = face if region == "face" else ~face
    assert rel_l2(route["field"], want, rows) <= TOL[region]


def test_bfloat16_reference_fails_a_tolerance(route, want):
    """The reference computed one precision below the port's f32 fails
    the tolerances above, so they tell the precision apart."""
    bf16 = reference(route["pts"], route["vals"], route["grid"],
                     torch.bfloat16)
    face = fx.face_rows(route["grid"].shape)
    readings = {"interior": rel_l2(bf16, want, ~face),
                "face": rel_l2(bf16, want, face)}
    assert any(not readings[r] <= TOL[r] for r in TOL), readings


def test_spans_once_per_call(route):
    by_name = {}
    for r in route["spans"]:
        by_name.setdefault(r["name"], []).append(r)
    (root,) = by_name["ptv.grid"]
    (select,) = by_name["ptv.grid.rbf.select"]
    (solve,) = by_name["ptv.grid.rbf.solve"]
    assert select["parent"] == solve["parent"] == root["id"]
    assert select["end_ns"] <= solve["start_ns"]
    assert select["attrs"] == {"k": K, "block": BLOCK,
                               "nodes": route["grid"].n_points}
    assert solve["attrs"] == {"m": 4, "chunks": 1}


def test_every_system_is_solved_and_finite(route):
    assert route["counters"]["rbf.systems"] == route["grid"].n_points
    assert route["counters"]["rbf.nonfinite"] == 0
    assert torch.isfinite(route["field"]).all()


def test_uncovered_counts_every_node_the_region_does_not_certify(route):
    """``knn.uncovered`` is the number of nodes whose selected k-th d²
    exceeds margin², and every node whose selected d² differ from the
    exact k nearest d² (the same f32 arithmetic, so ties are no
    difference) is among them."""
    sq = route["selection"][:, :K]
    m32 = torch.tensor(np.float32(route["margin"]))
    uncovered = sq[:, K - 1] > m32 * m32
    assert route["counters"]["knn.uncovered"] == int(uncovered.sum()) > 0
    pts, grid = route["pts"], route["grid"]
    extent = [hi - lo for lo, hi in grid.bounds]
    exact, _, _ = knn(torch.from_numpy(pts),
                      torch.from_numpy(fx.grid_nodes(grid)).float(), K,
                      porous.knn_cell(len(pts), extent, K))
    missed = (sq != exact).any(dim=1)
    assert int(missed.sum()) == 2
    assert not (missed & ~uncovered).any()
    assert not (missed & ~fx.face_rows(grid.shape)).any()
