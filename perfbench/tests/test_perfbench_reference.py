"""The plain reference on small hand cases, and against the port on the
CPU at a tiny size (the tests may import the port; the reference may
not)."""

import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from perfbench.reference import cleaning, porous
from perfbench.reference.knn import knn
from perfbench.reference.sibson import sibson


@pytest.mark.parametrize("cell", [1.5, 4.0, 50.0])
def test_knn_is_exact_for_any_cell(cell):
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 20, (3000, 3))
    q = rng.uniform(-3, 23, (700, 3))
    d2, idx, _ = knn(torch.tensor(p), torch.tensor(q), 13, cell)
    want_d, want_i = cKDTree(p).query(q, k=13)
    np.testing.assert_allclose(np.sqrt(d2.numpy()), want_d, rtol=1e-12)
    assert (idx.numpy() == want_i).all()


def test_knn_falls_back_where_the_block_cannot_certify():
    p = torch.tensor([[0.0, 0, 0], [10, 0, 0], [20, 0, 0], [30, 0, 0]],
                     dtype=torch.float64)
    d2, idx, n_open = knn(p, torch.tensor([[0.5, 0, 0]], dtype=torch.float64),
                          3, 1.0)
    assert n_open == 1 and idx.tolist() == [[0, 1, 2]]
    assert d2.tolist() == [[0.25, 9.5 ** 2, 19.5 ** 2]]


def test_sibson_weights_by_hand():
    p = torch.tensor([[1.0, 0, 0], [0, 2, 0], [0, 0, 4]], dtype=torch.float64)
    v = torch.tensor([[1.0], [2.0], [3.0]], dtype=torch.float64)
    got = sibson(p, v, torch.zeros(1, 3, dtype=torch.float64), 3, 10.0)
    d = np.array([1.0, 2.0, 4.0])
    w = (1 / (d + 1e-10)) / (1 / (d + 1e-10)).sum()
    w = w * np.exp(-d / (d.std() + 1e-10))
    w /= w.sum()
    assert float(got) == pytest.approx(float(w @ [1.0, 2.0, 3.0]), rel=1e-14)


def test_mad_keep_by_hand():
    # nine tracks on a line, the middle one five times faster
    p = torch.tensor([[float(i), 0, 0] for i in range(9)], dtype=torch.float64)
    s = torch.tensor([1.0, 1.1, 0.9, 1.0, 5.0, 1.05, 0.95, 1.0, 1.1],
                     dtype=torch.float64)
    keep = porous.mad_keep(p, s, 4, 4.0, 3.0)
    assert keep.tolist() == [True] * 4 + [False] + [True] * 4


def test_nearest_index_rounds_half_to_even():
    # 486 raw rows onto 243 nodes: node 121 sits at 242.5 exactly
    idx = porous.nearest_index(486, 243)
    assert idx[121] == 242 and idx[0] == 0 and idx[-1] == 485
    assert (porous.nearest_index(5, 3) == [0, 2, 4]).all()


def test_boundary_voxels_match_scipy():
    rng = np.random.default_rng(1)
    fluid = rng.uniform(size=(9, 8, 7)) < 0.7
    grown = ndimage.binary_dilation(
        fluid, ndimage.generate_binary_structure(3, 1), iterations=2)
    want = np.argwhere(grown & ~fluid)[::3]
    got = porous.boundary_voxels(fluid, 2, 3, "cpu").numpy()
    assert (got == want).all()


def _dense_operator(mask, spacing):
    """D̃ as a dense matrix, probed one unit vector at a time through an
    f64 numpy copy of the operator (np.roll and np.where)."""
    def div(u, v, w):
        def face(vel, axis, h):
            last = [slice(None)] * 3
            first = list(last)
            last[axis], first[axis] = -1, 0
            nxt = np.where(np.roll(mask, -1, axis),
                           (vel + np.roll(vel, -1, axis)) / 2, 0.0)
            nxt[tuple(last)] = vel[tuple(last)]
            prv = np.where(np.roll(mask, 1, axis),
                           (vel + np.roll(vel, 1, axis)) / 2, 0.0)
            prv[tuple(first)] = vel[tuple(first)]
            return (nxt - prv) / h
        return (face(u, 2, spacing[0]) + face(v, 1, spacing[1])
                + face(w, 0, spacing[2]))
    cells = np.argwhere(mask)
    cols = []
    for c in range(3):
        for z, y, x in cells:
            f = [np.zeros(mask.shape) for _ in range(3)]
            f[c][z, y, x] = 1.0
            cols.append(div(*f)[mask])
    return np.stack(cols, axis=1)


def test_cleaning_solves_the_variational_system():
    rng = np.random.default_rng(2)
    mask = rng.uniform(size=(5, 6, 4)) < 0.8
    spacing = (1.0, 1.5, 2.0)
    u0 = rng.normal(size=(3,) + mask.shape) * mask
    D = _dense_operator(mask, spacing)
    rhs = np.concatenate([u0[c][mask] for c in range(3)])
    want = np.linalg.solve(np.eye(D.shape[1]) + 200.0 * D.T @ D, rhs)
    got = cleaning.clean_variational(torch.tensor(u0), torch.tensor(mask),
                                      spacing, 200.0).numpy()
    got_flat = np.concatenate([got[c][mask] for c in range(3)])
    np.testing.assert_allclose(got_flat, want, rtol=1e-8, atol=1e-10)
    assert (got[:, ~mask] == 0).all()


def test_reference_pipeline_agrees_with_the_port_on_the_cpu():
    from ptv_interpolation_tpu_torch.io import PointCloud
    from ptv_interpolation_tpu_torch.pipeline import (PipelineConfig,
                                                      run_pipeline)
    rng = np.random.default_rng(3)
    nz, ny, nx = 40, 34, 30
    a = [(np.arange(n) - n / 2) / 2 for n in (nz, ny, nx)]
    fluid = ~(((np.sin(a[0] * 0.5)[:, None, None]
                * np.sin(a[1] * 0.6)[None, :, None])
               * np.sin(a[2] * 0.7)[None, None, :]) > 0.55)
    pts = rng.uniform((0, 0, 0), (nx, ny, nz), (4000, 3)).astype(np.float32)
    i = pts.astype(int)
    pts = pts[fluid[i[:, 2], i[:, 1], i[:, 0]]][:3000]
    vals = np.stack([0.05 * np.sin(pts[:, 0]), 0.05 * np.cos(pts[:, 1]),
                     1 + 0.1 * np.sin(pts[:, 2])], -1).astype(np.float32)
    vals[::97] *= 8
    vals[5::97] *= 2.5
    flags = dict(method="sibson", sibson_neighbors=50, downscale=2.0,
                 boundary_particles=True, boundary_sampling=5,
                 boundary_thickness=2, filter_outliers=True,
                 filter_neighbors=30, filter_threshold=4.0,
                 filter_max_speed=5.0, divergence_free=True,
                 cleaning_method="variational", cleaning_lambda=200.0,
                 verbose=False)
    res = run_pipeline(PipelineConfig(**flags), cloud=PointCloud(pts, vals),
                       mask_raw=fluid, device="cpu")
    ref = porous.run(flags, pts, vals, fluid, torch.float64, "cpu", True)
    m = ref["mask"]
    assert (res.mask == m).all()
    for got, want in ((np.stack([res.u_init, res.v_init, res.w_init]),
                       ref["field"].numpy()),
                      (np.stack([res.u, res.v, res.w]),
                       ref["cleaned"].numpy())):
        l2 = np.linalg.norm((got - want)[:, m]) / np.linalg.norm(want[:, m])
        assert l2 < 1e-6


def test_mask_resample_agrees_with_the_port():
    from ptv_interpolation_tpu_torch.grid import (create_grid,
                                                  sample_mask_on_grid)
    rng = np.random.default_rng(4)
    for shape in ((486, 337, 322), (40, 34, 30)):
        fluid = rng.uniform(size=shape) < 0.9
        res = porous.resolution(shape, 2.0)
        bounds = ((0, shape[2]), (0, shape[1]), (0, shape[0]))
        want = sample_mask_on_grid(fluid, create_grid(bounds, res), bounds)
        assert (porous.mask_on_grid(fluid, res) == want).all()
