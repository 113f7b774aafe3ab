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
    s = fx.kernel1_setup(fx.corner_slab(), block, k, cuda_device)
    m2, cand, q, sz, C = fx.kernel1_phase1(s)
    with capture() as rec:
        got = fx.kernel1_cells(s, k, mode)
    want = tfg._fused_eval_plain(m2, cand, *q, block, sz, k, 3, C, mode,
                                 2.0)
    torch.cuda.synchronize()
    assert rec.counters()["kernel1.launches"] == 1
    assert bool((want[:, :, 3] == 0).any())
    assert torch.equal(got[:, :, 3] == 0, want[:, :, 3] == 0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_fused_kernel_refuses_non_contiguous_input(cuda_device):
    k = 10
    s = fx.kernel1_setup(fx.uniform(), (2, 4, 8), k, cuda_device)
    vs = s["values_sorted"]
    strided = torch.empty((vs.shape[0], 2 * vs.shape[1]),
                          device=cuda_device)[:, ::2]
    strided.copy_(vs)
    with pytest.raises(ValueError, match="contiguous"):
        fx.kernel1_cells(dict(s, values_sorted=strided), k, "idw")


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


def _check_kernel(s, k, mode):
    """The kernel, staging from the cell list of :func:`kernel1_setup`'s
    ``s``, against its plain version, phase 1 and ``_fused_eval_plain``:
    τ² bit-equal, den==0 identical, the values within RTOL/ATOL,
    ``kernel1.staged_slots`` the count of the panel's real slots and
    ``kernel1.edge_spill`` the count of :func:`_edge_spills` (at most that
    where some nodes have no shortlist). Returns the kernel's counters
    (``kernel1.overflow``: the nodes without a shortlist;
    ``kernel1.list_slots`` and ``kernel1.list_overflow``: the slots on the
    warps' lists and the warps that passed over the panel;
    ``kernel1.edge_spill``), and the node count."""
    m2, cand, q, sz, C = fx.kernel1_phase1(s)
    block = s["block"]
    n_rows, _, Bt = q[0].shape
    tau2 = torch.empty((n_rows, Bt), device=cand.device)
    with capture() as rec:
        got = fx.kernel1_cells(s, k, mode, tau2=tau2)
    counts = rec.counters()
    want = tfg._fused_eval_plain(m2, cand, *q, block, sz, k, 3, C, mode,
                                 2.0)
    want_tau2 = tfg._fused_tau2_plain(m2, cand, *q, block, sz, k, C)
    torch.cuda.synchronize()
    assert torch.equal(tau2, want_tau2)
    assert torch.equal(got[:, :, 3] == 0, want[:, :, 3] == 0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert counts["kernel1.staged_slots"] == int((cand[0] < 1e18).sum())
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


def _rows(s):
    """The CSR rows a block of ``s`` stages: mcz·mcy."""
    return s["mc"][0] * s["mc"][1]


def _threads(block):
    return tfg._pick_sz(*block) * block[1] * block[2]


@pytest.mark.parametrize("mode,k", [("sibson", 10), ("idw", 10),
                                    ("sibson", 1), ("idw", 1)])
def test_fused_kernel_tau2_bit_equal_on_gpu(cuda_device, mode, k):
    """Blocks with uncovered nodes (the corner slab), k = 10 and k = 1."""
    s = fx.kernel1_setup(fx.corner_slab(), (2, 4, 8), k, cuda_device)
    counts, n = _check_kernel(s, k, mode)
    assert counts["kernel1.overflow"] < n


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_fused_kernel_overflow_on_duplicates_on_gpu(cuda_device, mode):
    """Nodes beside 64 coincident points count more than the shortlist
    holds: they run over the whole panel with the same result."""
    k = 10
    s = fx.kernel1_setup(fx.duplicated(), (2, 4, 8), k, cuda_device)
    counts, n = _check_kernel(s, k, mode)
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
    s = fx.kernel1_setup(fx.lattice(), block, k, cuda_device)
    s = dict(s, m2=np.float32(m2))
    counts, n = _check_kernel(s, k, mode)
    assert counts["kernel1.overflow"] == 0
    if path == "spill":
        assert n // 2 < counts["kernel1.edge_spill"] < n
    else:
        m2, cand, q, sz, C = fx.kernel1_phase1(s)
        S = tfg._kernel1_plan(C, q[0].shape[2], k, _rows(s))[0]
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
    s = fx.kernel1_setup(fx.uniform(), block, k, cuda_device, C=C)
    S = tfg._kernel1_plan(C, _threads(block), k, _rows(s))[0]
    counts, n = _check_kernel(s, k, "sibson")
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
    s = fx.kernel1_setup(fx.uniform(), block, k, cuda_device)
    L = tfg._kernel1_plan(s["C"], _threads(block), k, _rows(s))[1]
    counts, _ = _check_kernel(s, k, "sibson")
    assert counts["kernel1.list_overflow"] == 0
    assert counts["kernel1.edge_spill"] == 0
    assert (counts["kernel1.list_slots"] > 0) == (L > 0)
    assert (L > 0) == (block != (3, 5, 6))


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_fused_kernel_warp_list_overflow_on_gpu(cuda_device, mode):
    """1 600 points in a 0.5-wide knot: the warps beside it list more
    slots than the 860 their lists hold (block (4, 4, 8), 128 threads)
    and pass over the panel, the others run their lists; the same
    results."""
    block, k = (4, 4, 8), 10
    s = fx.kernel1_setup(fx.dense_knot(), block, k, cuda_device)
    assert tfg._kernel1_plan(s["C"], _threads(block), k, _rows(s))[1] == 860
    counts, n = _check_kernel(s, k, mode)
    assert 0 < counts["kernel1.list_overflow"] < n // 32
    assert counts["kernel1.list_slots"] > 0


@pytest.mark.parametrize("C,rows,ctas", [(1920, 100, 3), (3200, 196, 2)])
def test_kernel1_plan_ctas_on_gpu(cuda_device, C, rows, ctas):
    """The card holds as many CTAs per SM as the plan counts on: 3 at the
    headline's panel (C = 1 920 over 100 rows), 2 at its repair's (C =
    3 200 over 196), 256 threads and k = 50."""
    Bt, k = 256, 50
    S, L, smem = tfg._kernel1_plan(C, Bt, k, rows)
    assert tfg._SMEM_SM // (smem + tfg._SMEM_CTA) == ctas
    got = ctypes.c_int(0)
    err = tfg._kernel_lib().fused_grid_knn_ctas_per_sm(C, Bt, S, L, rows,
                                                       ctypes.byref(got))
    assert err == 0
    assert got.value == ctas


@pytest.mark.parametrize("cloud", ["corner_slab", "ragged", "duplicated"])
@pytest.mark.parametrize("block", [(8, 8, 16), (4, 8, 16), (3, 8, 16),
                                   (8, 16, 16)])
@pytest.mark.parametrize("mode", ["idw", "sibson"])
def test_csr_staging_matches_phase1_on_gpu(cuda_device, cloud, block, mode):
    """The kernel stages each block's candidates from the cell list: the
    same slots in the same order as phase 1's panel, so τ² bit-equal to
    the plain version's and ``kernel1.staged_slots`` the panel's real
    slots, at the main margin over every block and at the repair's 1.6×
    margin over a set of block ids (a device tensor). The clouds: rows
    left empty by a slab of points (``corner_slab``), blocks whose
    regions leave the cell grid's faces (``ragged``'s padded axes), and
    64 coincident points whose nodes overflow their shortlists
    (``duplicated``). Blocks (3, 8, 16) and (8, 16, 16) run sub-tiles one
    node deep (sz = 1)."""
    k = 10
    main = fx.kernel1_setup(getattr(fx, cloud)(), block, k, cuda_device)
    counts, n = _check_kernel(main, k, mode)
    assert counts["kernel1.staged_slots"] > 0
    if cloud == "duplicated":
        assert 0 < counts["kernel1.overflow"] < n
    dims = [-(-a // b) for a, b in zip(main["grid_shape"], block)]
    n_blocks = int(np.prod(dims))
    ids = torch.tensor(sorted({n_blocks - 1, 0, n_blocks // 2}),
                       device=cuda_device)
    repair = fx.kernel1_setup(getattr(fx, cloud)(), block, k, cuda_device,
                              ids=ids, repair=True)
    _check_kernel(repair, k, mode)
