"""The CUDA kernel of the fused grid kNN path against its plain PyTorch
version, and the slice on the GPU against the slice on the CPU. Needs an
NVIDIA GPU and ``nvcc`` (marker ``gpu``); skipped elsewhere.

This file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_fused_grid_knn_gpu.py``
(``tests/conftest.py`` imports JAX)."""

import ctypes

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import (idw_grid_interpolate,
                                                     sibson_grid_interpolate)
from ptv_interpolation_tpu_torch.ops import fused_grid_knn as tfg
from ptv_interpolation_tpu_torch.ops import grid_knn as tgk
from ptv_interpolation_tpu_torch.utils import capture
import torch_port_fixtures as fx

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

# summation order and expf differ between the kernel and the plain
# version; d² and τ² are bit-equal, so the den==0 pattern is identical
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _panel(cloud, block, k, device, C=None):
    """The kernel's inputs on ``cloud``; ``C`` widens the panel past the
    largest block's candidate count (the extra slots are sentinels)."""
    pts, vals, bounds, n = cloud
    grid = create_grid(bounds, n)
    cells, vs, axes, margin, mc, _, _ = tgk._host_setup(
        pts, vals, grid, k, block, 1.45, cell_divisor=3.0, device=device)
    C_raw = tfg._panel_width(tfg._block_total_capacity(cells, axes, margin,
                                                       block, grid.shape, mc))
    assert C is None or C >= C_raw
    C = C_raw if C is None else C
    dims = tuple((s + b - 1) // b for s, b in zip(grid.shape, block))
    sz = tfg._pick_sz(*block)
    cand = tfg._compact_gather(cells, vs, axes, margin, block, grid.shape, mc,
                               C)
    q = tfg._build_queries(axes, block, dims, sz, device=device)
    return np.float32(margin * margin), cand, q, sz, C


@pytest.mark.parametrize("mode,block", [
    ("sibson", (2, 4, 8)), ("idw", (2, 4, 8)), ("sibson", (4, 4, 8)),
    ("idw", (8, 8, 16)),
])
def test_fused_kernel_matches_plain_on_gpu(cuda_device, mode, block):
    """An identical den==0 pattern, floats within rtol 1e-5 / atol 1e-6."""
    k = 10
    m2, cand, q, sz, C = _panel(fx.corner_slab(), block, k, cuda_device)
    args = (m2, cand, *q, block, sz, k, 3, C, mode, 2.0)
    with capture() as rec:
        got = tfg._fused_eval(*args)
    want = tfg._fused_eval_plain(*args)
    torch.cuda.synchronize()
    assert rec.counters()["kernel1.launches"] == 1
    assert bool((want[:, :, 3] == 0).any())
    assert torch.equal(got[:, :, 3] == 0, want[:, :, 3] == 0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_fused_kernel_refuses_non_contiguous_input(cuda_device):
    block, k = (2, 4, 8), 10
    m2, cand, q, sz, C = _panel(fx.uniform(), block, k, cuda_device)
    strided = torch.empty((8, 2 * cand.shape[1]), device=cuda_device)[:, ::2]
    strided.copy_(cand)
    with pytest.raises(ValueError, match="contiguous"):
        tfg._fused_eval(m2, strided, *q, block, sz, k, 3, C, "idw", 2.0)


@pytest.mark.parametrize("cloud,mode", [
    ("uniform", "sibson"), ("void_region", "idw"), ("corner_slab", "sibson"),
    ("ragged", "idw"),
])
def test_grid_slice_on_gpu_matches_cpu(cuda_device, cloud, mode):
    """The whole slice on the GPU launches the kernel (main pass and
    repair) and agrees with the same slice on the CPU."""
    pts, vals, bounds, n = getattr(fx, cloud)()
    grid = create_grid(bounds, n)
    entry = sibson_grid_interpolate if mode == "sibson" \
        else idw_grid_interpolate
    kw = dict(k=8, block=(2, 4, 8))
    with capture() as rec:
        got = entry(pts, vals, grid, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert rec.counters()["kernel1.launches"] >= 1
    assert got.device.type == "cuda"
    want = entry(pts, vals, grid, device="cpu", **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


def _check_kernel(m2, cand, q, block, sz, k, C, mode):
    """The kernel against its plain version: τ² bit-equal, den==0
    identical, the values within RTOL/ATOL. Returns the kernel's counters
    (``kernel1.overflow``: the nodes without a shortlist;
    ``kernel1.list_slots`` and ``kernel1.list_overflow``: the slots on the
    warps' lists and the warps that passed over the panel), and the node
    count."""
    n_rows, _, Bt = q[0].shape
    tau2 = torch.empty((n_rows, Bt), device=cand.device)
    args = (m2, cand, *q, block, sz, k, 3, C, mode, 2.0)
    with capture() as rec:
        got = tfg._fused_eval(*args, tau2=tau2)
    counts = rec.counters()
    want = tfg._fused_eval_plain(*args)
    want_tau2 = tfg._fused_tau2_plain(m2, cand, *q, block, sz, k, C)
    torch.cuda.synchronize()
    assert torch.equal(tau2, want_tau2)
    assert torch.equal(got[:, :, 3] == 0, want[:, :, 3] == 0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    return counts, n_rows * Bt


@pytest.mark.parametrize("mode,k", [("sibson", 10), ("idw", 10),
                                    ("sibson", 1), ("idw", 1)])
def test_fused_kernel_tau2_bit_equal_on_gpu(cuda_device, mode, k):
    """Blocks with uncovered nodes (the corner slab), k = 10 and k = 1."""
    block = (2, 4, 8)
    m2, cand, q, sz, C = _panel(fx.corner_slab(), block, k, cuda_device)
    counts, n = _check_kernel(m2, cand, q, block, sz, k, C, mode)
    assert counts["kernel1.overflow"] < n


def _duplicated_cloud():
    """A uniform cloud with one point copied 64 times onto a grid node
    (more than the k + 32 entries a shortlist holds at k = 10; few enough
    that the kernel's sequential f32 sum of their equal weights stays
    within RTOL of the plain version's) and a 4³ lattice of points at
    whole coordinates (tied distances)."""
    pts, vals, bounds, n = fx.uniform()
    lattice = np.stack(np.meshgrid(*[np.arange(4, 8)] * 3), -1).reshape(-1, 3)
    extra = np.concatenate([np.repeat([[12.0, 12.0, 12.0]], 64, 0),
                            lattice]).astype(np.float32)
    extra_vals = np.ones((len(extra), 3), np.float32)
    return (np.concatenate([pts, extra]), np.concatenate([vals, extra_vals]),
            bounds, n)


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_fused_kernel_overflow_on_duplicates_on_gpu(cuda_device, mode):
    """Nodes beside 64 coincident points count more than the shortlist
    holds: they run over the whole panel with the same result."""
    block, k = (2, 4, 8), 10
    m2, cand, q, sz, C = _panel(_duplicated_cloud(), block, k, cuda_device)
    counts, n = _check_kernel(m2, cand, q, block, sz, k, C, mode)
    assert 0 < counts["kernel1.overflow"] < n


@pytest.mark.parametrize("k,block", [(10, (2, 4, 8)), (300, (8, 8, 16))])
def test_fused_kernel_at_the_panel_cap_on_gpu(cuda_device, k, block):
    """C = 8 192, the cap: at k = 10 the shortlists fit beside the panel;
    at k = 300 with 256 threads they do not (S = 0), and every node runs
    over the whole panel."""
    C = 8192
    m2, cand, q, sz, _ = _panel(fx.uniform(), block, k, cuda_device, C=C)
    Bt = q[0].shape[2]
    S = tfg._kernel1_plan(C, Bt, k)[0]
    counts, n = _check_kernel(m2, cand, q, block, sz, k, C, "sibson")
    if k == 300:
        assert S == 0 and counts["kernel1.overflow"] == n
    else:
        assert S == k + 32 and counts["kernel1.overflow"] < n


@pytest.mark.parametrize("block", [(2, 4, 8), (4, 4, 8), (4, 8, 16),
                                   (8, 8, 16), (3, 4, 8), (3, 5, 6)])
def test_fused_kernel_warp_bricks_on_gpu(cuda_device, block):
    """Warps on 4 × 4 × 2 bricks of the sub-tiles 2×4×8, 4×4×8 and 2×8×16
    (blocks (2,4,8), (4,4,8), (4,8,16) and (8,8,16)); the sub-tile's own
    order at 3×4×8, whose odd depth takes no brick, and at 3×5×6, whose 90
    threads fill no whole warp (no warp lists). On the uniform cloud every
    warp's list fits: τ² bit-equal, the values within RTOL/ATOL."""
    k = 10
    m2, cand, q, sz, C = _panel(fx.uniform(), block, k, cuda_device)
    L = tfg._kernel1_plan(C, q[0].shape[2], k)[1]
    counts, _ = _check_kernel(m2, cand, q, block, sz, k, C, "sibson")
    assert counts["kernel1.list_overflow"] == 0
    assert (counts["kernel1.list_slots"] > 0) == (L > 0)
    assert (L > 0) == (block != (3, 5, 6))


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_fused_kernel_warp_list_overflow_on_gpu(cuda_device, mode):
    """1 600 points in a 0.5-wide knot: the warps beside it list more
    slots than the 498 their lists hold and pass over the panel, the
    others run their lists; the same results."""
    block, k = (2, 4, 8), 10
    m2, cand, q, sz, C = _panel(fx.dense_knot(), block, k, cuda_device)
    assert tfg._kernel1_plan(C, q[0].shape[2], k)[1] == 498
    counts, n = _check_kernel(m2, cand, q, block, sz, k, C, mode)
    assert 0 < counts["kernel1.list_overflow"] < n // 32
    assert counts["kernel1.list_slots"] > 0


@pytest.mark.parametrize("C,Bt,k,ctas", [(1920, 256, 50, 3),
                                         (3200, 256, 50, 2)])
def test_kernel1_plan_ctas_on_gpu(cuda_device, C, Bt, k, ctas):
    """The card holds as many CTAs per SM as the plan counts on: 3 at the
    headline's panel (C = 1 920), 2 at its repair's (C = 3 200)."""
    S, L, smem = tfg._kernel1_plan(C, Bt, k)
    assert tfg._SMEM_SM // (smem + tfg._SMEM_CTA) == ctas
    got = ctypes.c_int(0)
    err = tfg._kernel_lib().fused_grid_knn_ctas_per_sm(C, Bt, S, L,
                                                       ctypes.byref(got))
    assert err == 0
    assert got.value == ctas
