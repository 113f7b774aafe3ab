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


@pytest.mark.parametrize("mode,block", [
    ("sibson", (2, 4, 8)), ("idw", (2, 4, 8)), ("sibson", (4, 4, 8)),
    ("idw", (8, 8, 16)),
])
def test_fused_kernel_matches_plain_on_gpu(cuda_device, mode, block):
    """An identical den==0 pattern, floats within rtol 1e-5 / atol 1e-6."""
    k = 10
    m2, cand, q, sz, C = fx.kernel1_panel(fx.corner_slab(), block, k,
                                          cuda_device)
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
    m2, cand, q, sz, C = fx.kernel1_panel(fx.uniform(), block, k,
                                          cuda_device)
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
    identical, the values within RTOL/ATOL, ``kernel1.edge_spill`` the
    count of :func:`_edge_spills` (at most that where some nodes have no
    shortlist). Returns the kernel's counters (``kernel1.overflow``: the
    nodes without a shortlist; ``kernel1.list_slots`` and
    ``kernel1.list_overflow``: the slots on the warps' lists and the warps
    that passed over the panel; ``kernel1.edge_spill``), and the node
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
    spills = _edge_spills(m2, cand, q, block, sz, k, C, tau2)
    if counts["kernel1.overflow"] == 0:
        assert counts["kernel1.edge_spill"] == spills
    else:
        assert counts["kernel1.edge_spill"] <= spills
    return counts, n_rows * Bt


def _edge_spills(m2, cand, q, block, sz, k, C, tau2):
    """The covered nodes whose τ² falls in a later pass-A bucket than
    their k-th smallest d², so that the kernel sums them over their warp's
    list instead of their shortlist."""
    d2 = fx.kernel1_d2(cand, q, block, sz, C)
    covered = (d2 <= float(m2)).sum(dim=-1) >= k
    kth = torch.kthvalue(d2, k, dim=-1).values
    later = fx.kernel1_bucket(tau2, m2) > fx.kernel1_bucket(kth, m2)
    return int((covered & later).sum())


@pytest.mark.parametrize("mode,k", [("sibson", 10), ("idw", 10),
                                    ("sibson", 1), ("idw", 1)])
def test_fused_kernel_tau2_bit_equal_on_gpu(cuda_device, mode, k):
    """Blocks with uncovered nodes (the corner slab), k = 10 and k = 1."""
    block = (2, 4, 8)
    m2, cand, q, sz, C = fx.kernel1_panel(fx.corner_slab(), block, k,
                                          cuda_device)
    counts, n = _check_kernel(m2, cand, q, block, sz, k, C, mode)
    assert counts["kernel1.overflow"] < n


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_fused_kernel_overflow_on_duplicates_on_gpu(cuda_device, mode):
    """Nodes beside 64 coincident points count more than the shortlist
    holds: they run over the whole panel with the same result."""
    block, k = (2, 4, 8), 10
    m2, cand, q, sz, C = fx.kernel1_panel(fx.duplicated(), block, k,
                                          cuda_device)
    counts, n = _check_kernel(m2, cand, q, block, sz, k, C, mode)
    assert 0 < counts["kernel1.overflow"] < n


_M2_SPILL = float(np.nextafter(np.float32(8.0), np.float32(9.0)))


@pytest.mark.parametrize("mode,k,m2,path", [
    ("sibson", 10, _M2_SPILL, "spill"), ("idw", 10, _M2_SPILL, "spill"),
    ("sibson", 50, 32.0, "beyond_tail"),
])
def test_fused_kernel_lattice_ties_on_gpu(cuda_device, mode, k, m2, path):
    """Whole-coordinate points and nodes (every d² a whole number, tied
    many times over). ``spill``: at k = 10 and m2 one ulp above 8, 16/m2
    rounds below 2, so the k-th d², 2, falls in bucket 3, while τ² is the
    halving grid's point m2/4 just above it, in bucket 4: those nodes pass
    the edge of their shortlist and sum over their warp's list.
    ``beyond_tail``: at k = 50 and m2 = 32, d² 4 and 5 share the k-th's
    bucket, whose 30 open slots do not fit at the shortlist's tail beside
    its 57 (S = 82): d₍ₖ₎ comes from the radix select over the shortlist.
    τ² bit-equal, the values within RTOL/ATOL, no node without a
    shortlist."""
    block = (2, 4, 8)
    _, cand, q, sz, C = fx.kernel1_panel(fx.lattice(), block, k,
                                         cuda_device)
    m2 = np.float32(m2)
    counts, n = _check_kernel(m2, cand, q, block, sz, k, C, mode)
    assert counts["kernel1.overflow"] == 0
    if path == "spill":
        assert n // 2 < counts["kernel1.edge_spill"] < n
    else:
        S = tfg._kernel1_plan(C, q[0].shape[2], k)[0]
        d2 = fx.kernel1_d2(cand, q, block, sz, C)
        b = fx.kernel1_bucket(d2, m2)
        b_k = fx.kernel1_bucket(torch.kthvalue(d2, k, dim=-1).values, m2)
        n_le = (b <= b_k[..., None]).sum(dim=-1)
        n_open = (b == b_k[..., None]).sum(dim=-1)
        assert int(((n_le <= S) & (n_le + n_open > S)).sum()) > n // 8


@pytest.mark.parametrize("k,block", [(10, (2, 4, 8)), (300, (8, 8, 16))])
def test_fused_kernel_at_the_panel_cap_on_gpu(cuda_device, k, block):
    """C = 8 192, the cap: at k = 10 the shortlists fit beside the panel;
    at k = 300 with 256 threads they do not (S = 0), and every node runs
    over the whole panel."""
    C = 8192
    m2, cand, q, sz, _ = fx.kernel1_panel(fx.uniform(), block, k,
                                          cuda_device, C=C)
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
    m2, cand, q, sz, C = fx.kernel1_panel(fx.uniform(), block, k,
                                          cuda_device)
    L = tfg._kernel1_plan(C, q[0].shape[2], k)[1]
    counts, _ = _check_kernel(m2, cand, q, block, sz, k, C, "sibson")
    assert counts["kernel1.list_overflow"] == 0
    assert counts["kernel1.edge_spill"] == 0
    assert (counts["kernel1.list_slots"] > 0) == (L > 0)
    assert (L > 0) == (block != (3, 5, 6))


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_fused_kernel_warp_list_overflow_on_gpu(cuda_device, mode):
    """1 600 points in a 0.5-wide knot: the warps beside it list more
    slots than the 498 their lists hold and pass over the panel, the
    others run their lists; the same results."""
    block, k = (2, 4, 8), 10
    m2, cand, q, sz, C = fx.kernel1_panel(fx.dense_knot(), block, k,
                                          cuda_device)
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
