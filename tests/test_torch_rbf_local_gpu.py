"""The local-RBF grid route on the card against the benchmark's plain
reference (``perfbench/reference/rbf_local.py``, f64 on the card), and
its counters on the card against the CPU's. Needs an NVIDIA GPU (marker
``gpu``); skipped elsewhere.

This file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_rbf_local_gpu.py``
(``tests/conftest.py`` imports JAX)."""

import numpy as np
import pytest
import torch

from perfbench.reference import porous
from perfbench.reference.knn import knn
from perfbench.reference.rbf_local import rbf_local
from ptv_interpolation_tpu_torch.grid import create_grid
import torch_port_fixtures as fx

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

K = 20
# the CPU file's tolerances (tests/test_torch_rbf_local_reference.py):
# the f32 solve and its regulariser inside, uncovered k-sets at the faces
TOL = {"interior": 1e-5, "face": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel_l2(got, want, rows):
    return float((got - want)[rows].norm() / want[rows].norm())


def test_route_matches_reference_at_160(cuda):
    """250 000 tracks onto 160³ nodes (the benchmark cell's density):
    every system solved and finite, ``knn.uncovered`` the nodes whose
    k-th d² exceeds margin², each k-set that misses a nearer track among
    them, and the field within the CPU file's tolerances."""
    pts, vals, bounds, n = fx.cell_density_cube(160, seed=11)
    grid = create_grid(bounds, n)
    route = fx.rbf_grid_route(pts, vals, grid, K, cuda)
    c = route["counters"]
    assert c["rbf.systems"] == grid.n_points and c["rbf.nonfinite"] == 0
    sq = route["selection"][:, :K].to(cuda)
    m32 = torch.tensor(np.float32(route["margin"]), device=cuda)
    uncovered = sq[:, K - 1] > m32 * m32
    assert c["knn.uncovered"] == int(uncovered.sum()) > 0

    extent = [hi - lo for lo, hi in grid.bounds]
    cell = porous.knn_cell(len(pts), extent, K)
    p, v = (torch.tensor(a, dtype=torch.float64, device=cuda)
            for a in (pts, vals))
    q = torch.tensor(fx.grid_nodes(grid), device=cuda)
    exact, _, _ = knn(p.float(), q.float(), K, cell)
    missed = (sq != exact).any(dim=1)
    assert not (missed & ~uncovered).any()

    want = rbf_local(p, v, q, K, cell).cpu()
    face = fx.face_rows(grid.shape)
    for region, rows in (("interior", ~face), ("face", face)):
        assert rel_l2(route["field"], want, rows) <= TOL[region], region


def test_counters_match_the_cpu(cuda):
    """The same call on the card and on the CPU selects the same d² at
    every node, so the counters read the same."""
    pts, vals, bounds, n = fx.cell_density_cube()
    grid = create_grid(bounds, n)
    got = fx.rbf_grid_route(pts, vals, grid, K, cuda)
    want = fx.rbf_grid_route(pts, vals, grid, K, "cpu")
    assert got["counters"] == want["counters"]
    assert torch.equal(got["selection"][:, :K], want["selection"][:, :K])
    torch.testing.assert_close(got["field"], want["field"], rtol=1e-4,
                               atol=1e-5)
