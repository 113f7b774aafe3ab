"""The CUDA kernel of the fused grid kNN path against its plain PyTorch
version, and the slice on the GPU against the slice on the CPU. Needs an
NVIDIA GPU and ``nvcc`` (marker ``gpu``); skipped elsewhere.

This file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_fused_grid_knn_gpu.py``
(``tests/conftest.py`` imports JAX)."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import (idw_grid_interpolate,
                                                     sibson_grid_interpolate)
from ptv_interpolation_tpu_torch.ops import fused_grid_knn as tfg
from ptv_interpolation_tpu_torch.ops import grid_knn as tgk
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


def _panel(cloud, block, k, device):
    pts, vals, bounds, n = cloud
    grid = create_grid(bounds, n)
    cells, vs, axes, margin, mc, _, _ = tgk._host_setup(
        pts, vals, grid, k, block, 1.45, cell_divisor=3.0, device=device)
    C = tfg._panel_width(tfg._block_total_capacity(cells, axes, margin,
                                                   block, grid.shape, mc))
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
    before = tfg._fused_eval.launches
    got = tfg._fused_eval(*args)
    want = tfg._fused_eval_plain(*args)
    torch.cuda.synchronize()
    assert tfg._fused_eval.launches == before + 1
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
    before = tfg._fused_eval.launches
    got = entry(pts, vals, grid, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert tfg._fused_eval.launches >= before + 1
    assert got.device.type == "cuda"
    want = entry(pts, vals, grid, device="cpu", **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
