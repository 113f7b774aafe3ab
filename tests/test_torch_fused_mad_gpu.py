"""The CUDA kernel of the fused kNN-MAD filter against its plain PyTorch
version, and the filter and pipeline on the GPU against the same on the
CPU. Needs an NVIDIA GPU and ``nvcc`` (marker ``gpu``); skipped elsewhere.

This file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_fused_mad_gpu.py``
(``tests/conftest.py`` imports JAX)."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu_torch import filtering as tf
from ptv_interpolation_tpu_torch.grid import extract_boundary_particles
from ptv_interpolation_tpu_torch.interpolate import dispatch as td
from ptv_interpolation_tpu_torch.io import PointCloud
from ptv_interpolation_tpu_torch.ops import fused_mad as tfm
from ptv_interpolation_tpu_torch.pipeline import PipelineConfig, run_pipeline
from ptv_interpolation_tpu_torch.utils import capture

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

# d², τ², the bisection midpoints and the decision bound are bit-equal
# between the kernel and the plain version; 1e-6 bounds the rest
RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(n, n_outliers, seed, coincident=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, size=(n, 3))
    vals = np.stack([0.1 * np.sin(pts[:, 0]), 0.1 * np.cos(pts[:, 1]),
                     np.ones(n)], axis=-1)
    vals[rng.choice(n, n_outliers, replace=False)] *= 8.0
    if coincident:
        twins = rng.choice(n, coincident, replace=False)
        pts = np.concatenate([pts, pts[twins]])
        vals = np.concatenate([vals, vals[twins] * 1.3])
    return pts.astype(np.float32), vals.astype(np.float32)


def _speed(vals):
    return np.sqrt((vals * vals).sum(axis=-1))


def _captured_eval(pts, speed, k, device):
    """The kernel's inputs and output from one fused_mad_filter call."""
    seen = {}
    orig = tfm._mad_eval

    def grab(*a):
        seen["args"] = a
        seen["out"] = orig(*a)
        return seen["out"]

    tfm._mad_eval = grab
    try:
        res = tfm.fused_mad_filter(pts, speed, k, 3.0, want_kth=True,
                                   device=device)
    finally:
        tfm._mad_eval = orig
    return res, seen["args"], seen["out"]


@pytest.mark.parametrize("k,coincident", [(25, 0), (30, 0), (30, 300),
                                          (25, 300)])
def test_mad_kernel_matches_plain_on_gpu(cuda_device, k, coincident):
    """keep|covered identical on every query slot, the corner blocks and
    coincident points included; √τ², med and mad within 1e-6."""
    pts, vals = _cloud(4000, 30, k + coincident, coincident)
    with capture() as rec:
        _, args, got = _captured_eval(pts, _speed(vals), k, cuda_device)
    assert rec.counters()["kernel2.launches"] == 1
    want = tfm._mad_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], want[:, 0])
    assert torch.equal(torch.isinf(got[:, 1]), torch.isinf(want[:, 1]))
    fin = torch.isfinite(want[:, 1])
    torch.testing.assert_close(got[:, 1][fin], want[:, 1][fin], rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(got[:, 2:], want[:, 2:], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [25, 30])
def test_fused_mad_filter_gpu_matches_cpu(cuda_device, k):
    pts, vals = _cloud(3000, 25, 5)
    g = tfm.fused_mad_filter(pts, _speed(vals), k, 3.0, want_kth=True,
                             device=cuda_device)
    c = tfm.fused_mad_filter(pts, _speed(vals), k, 3.0, want_kth=True,
                             device="cpu")
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[1], c[1])
    assert g[2] == pytest.approx(c[2], rel=RTOL)
    np.testing.assert_allclose(g[3], c[3], rtol=RTOL)


@pytest.mark.parametrize("k", [25, 30])
def test_knn_mad_mask_scatter_full_parity_on_gpu(cuda_device, k):
    """One extreme outlier among near-threshold decisions: 100% parity
    with an f64 KDTree reference, through the kernel and the exact
    re-decides on the GPU."""
    from scipy.spatial import cKDTree
    pts, vals = _cloud(5000, 0, 13)
    rng = np.random.default_rng(13)
    vals[:, 2] += 0.02 * rng.standard_normal(len(vals)).astype(np.float32)
    extreme = int(rng.integers(len(vals)))
    vals[extreme] *= 1e6
    with capture() as rec:
        keep, _ = tf.knn_mad_mask_scatter(pts, vals, k=k, threshold=3.0,
                                          device=cuda_device)
    assert rec.counters()["kernel2.launches"] == 1
    s = _speed(vals.astype(np.float64))
    _, idx = cKDTree(pts.astype(np.float64)).query(pts, k=k + 1)
    neigh = s[idx[:, 1:]]
    med = np.median(neigh, axis=1)
    mad = np.median(np.abs(neigh - med[:, None]), axis=1)
    ref = np.abs(s - med) / (mad + 1e-6) <= 3.0
    assert not keep[extreme]
    assert (keep == ref).mean() == 1.0


def test_boundary_particles_gpu_match_cpu(cuda_device):
    rng = np.random.default_rng(2)
    fluid = rng.random((20, 23, 17)) > 0.3
    bounds = ((0, 17), (0, 23), (0, 20))
    for step, thick in ((1, 1), (7, 2)):
        g = extract_boundary_particles(fluid, bounds, step, thick,
                                       device=cuda_device)
        c = extract_boundary_particles(fluid, bounds, step, thick,
                                       device="cpu")
        for a, b in zip(g, c):
            np.testing.assert_array_equal(a, b)


def test_pipeline_gpu_matches_cpu(cuda_device, monkeypatch):
    """A porous box with a solid block: the pipeline on the GPU, with the
    size switches lowered so that both kernels serve, launches each and
    agrees with the CPU run."""
    monkeypatch.setattr(tf, "_SCATTER_MIN_POINTS", 1000)
    monkeypatch.setattr(td, "_GRID_FASTPATH_MIN_WORK", 1)
    monkeypatch.setattr(td, "_GRID_FASTPATH_MIN_POINTS", 1000)
    n = 24
    fluid = np.ones((n, n, n), bool)
    fluid[8:16, 6:14, 10:18] = False
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, n, size=(6000, 3)).astype(np.float32)
    idx = np.clip(pts.astype(int), 0, n - 1)
    pts = pts[fluid[idx[:, 2], idx[:, 1], idx[:, 0]]]
    vals = np.stack([0.05 * np.sin(pts[:, 0] * 0.3), np.cos(pts[:, 1] * 0.2),
                     1.0 + 0.1 * pts[:, 2] / n], -1).astype(np.float32)
    vals[::97] *= 2.5
    config = PipelineConfig(method="sibson", sibson_neighbors=20,
                            filter_outliers=True, filter_neighbors=30,
                            filter_threshold=4.0, filter_max_speed=5.0,
                            boundary_particles=True, boundary_sampling=3,
                            verbose=False)
    with capture() as rec:
        g = run_pipeline(config, cloud=PointCloud(pts, vals),
                         mask_raw=fluid, device=cuda_device)
    counts = rec.counters()
    assert counts["kernel2.launches"] > 0 and counts["kernel1.launches"] > 0
    c = run_pipeline(config, cloud=PointCloud(pts, vals), mask_raw=fluid,
                     device="cpu")
    np.testing.assert_array_equal(g.mask, c.mask)
    for f in "uvw":
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=1e-4,
                                   atol=1e-5)
        assert np.all(getattr(g, f)[~g.mask] == 0.0)


def _check_mad(args):
    """The kernel against its plain version on ``args``: keep|covered
    identical and rows 1-3 (√τ², med, mad) bit-equal. Returns the number
    of real queries that ran over the whole panel."""
    with capture() as rec:
        got = tfm._mad_eval(*args)
    overflow = rec.counters()["kernel2.overflow"]
    want = tfm._mad_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], want[:, 0])
    assert torch.equal(got[:, 1:4], want[:, 1:4])
    return overflow


def _clustered_cloud(seed):
    """4 000 uniform points and 100 copies of one of them."""
    pts, vals = _cloud(4000, 30, seed)
    pts = np.concatenate([pts, np.repeat(pts[:1], 100, 0)])
    vals = np.concatenate([vals, np.repeat(vals[:1] * 1.1, 100, 0)])
    return pts, vals


@pytest.mark.parametrize("k", [1, 25, 30])
@pytest.mark.parametrize("cloud", ["uniform", "clustered"])
def test_mad_kernel_bit_equal_on_gpu(cuda_device, k, cloud):
    """k = 1, odd and even k; the clustered cloud's 101 coincident points
    overflow the shortlist (k1 + 32 entries) of the queries beside them."""
    pts, vals = (_cloud(4000, 30, 3) if cloud == "uniform"
                 else _clustered_cloud(3))
    _, args, _ = _captured_eval(pts, _speed(vals), k, cuda_device)
    overflow = _check_mad(args)
    n_real = int((args[2] < 1e18).sum())
    assert overflow < n_real
    if cloud == "clustered":
        assert overflow > 0


def _widened(args, C_new):
    """The same MAD panel padded with sentinel slots to C_new."""
    m2, cand, qx, qy, qz, qs, k, thr, Bt, C = args
    nb = cand.shape[1] // C
    wide = torch.zeros((4, nb, C_new), device=cand.device)
    wide[:3] = 1e19
    wide[:, :, :C] = cand.view(4, nb, C)
    return (m2, wide.reshape(4, -1), qx, qy, qz, qs, k, thr, Bt, C_new)


@pytest.mark.parametrize("k", [30, 300])
def test_mad_kernel_at_the_panel_cap_on_gpu(cuda_device, k):
    """C = 8 192, the cap: at k = 30 the shortlists fit beside the panel;
    at k = 300 they do not (S = 0), and every real query runs over the
    whole panel with the same result."""
    pts, vals = _cloud(4000, 30, 8)
    _, args, _ = _captured_eval(pts, _speed(vals), 30, cuda_device)
    args = _widened(args, 8192)
    args = args[:6] + (k,) + args[7:]
    Bt = args[8]
    sub = min(Bt, tfm._SUB_TILE)
    S = tfm._shortlist_plan(8192, sub, k + 1)[0]
    overflow = _check_mad(args)
    n_real = int((args[2] < 1e18).sum())      # padding slots are not counted
    if k == 300:
        assert S == 0 and overflow == n_real
    else:
        assert S == k + 33 and overflow < n_real
