"""The CUDA kernel of the one-phase grid route (``backend='pallas'``)
against its plain PyTorch version, and the streaming and gather routes on
the GPU against the same routes on the CPU. Needs an NVIDIA GPU and
``nvcc`` (marker ``gpu``); skipped elsewhere.

This file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_pallas_grid_knn_gpu.py``
(``tests/conftest.py`` imports JAX)."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import (idw_grid_interpolate,
                                                     sibson_grid_interpolate)
from ptv_interpolation_tpu_torch.ops import pallas_grid_knn as tpg
from ptv_interpolation_tpu_torch.utils import capture
import torch_port_fixtures as fx

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

# τ² (column 3) is bit-equal: d², hi and the midpoints are the same f32
# ops in the same order. The weighted sums accumulate in f64 in both, and
# expf differs from torch.exp by an ulp or so.
RTOL, ATOL = 1e-5, 1e-6
BLOCK = (2, 8, 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cloud, k, device):
    """The kernel's inputs over every block of the cloud's grid: the small
    grids hold the corner and edge blocks and blocks whose windows leave
    the cell grid."""
    pts, vals, bounds, n = cloud
    starts, axes, store, dims, L = tpg._pallas_setup(
        pts, vals, create_grid(bounds, n), k, BLOCK, 1.45, device)
    ids = torch.arange(starts.shape[0], dtype=torch.int32, device=device)
    return starts, ids, axes, store, BLOCK, dims, L


def _check(got, want):
    assert torch.equal(got[..., 3], want[..., 3]), "τ² differs"
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


_LAST = {}


def _stages(rec):
    """The repair ladder's counters of a capture, by stage."""
    return {name.split(".", 1)[1]: n for name, n in rec.counters().items()
            if name.startswith("repair.")}


def _launch_and_plain(args, k, mode, power, iters=14):
    with capture() as rec:
        got = tpg._pallas_eval(*args, k, mode, power, iters)
    want = tpg._pallas_eval_plain(*args, k, mode, power, iters)
    torch.cuda.synchronize()
    counts = rec.counters()
    assert counts["kernel3.launches"] == 1
    _LAST["overflow"] = counts["kernel3.overflow"]
    return got, want


def _overflow(args):
    """Nodes of the last launch that ran over the whole panel, and the
    node count."""
    return _LAST["overflow"], args[0].shape[0] * 128


@pytest.mark.parametrize("cloud,mode,power,iters", [
    ("corner_slab", "sibson", 2.0, 14), ("corner_slab", "idw", 2.0, 14),
    ("uniform", "idw", 3.0, 14), ("ragged", "sibson", 2.0, 18),
    ("void_region", "sibson", 2.0, 14), ("void_region", "idw", 2.5, 14),
])
def test_pallas_kernel_matches_plain_on_gpu(cuda_device, cloud, mode, power,
                                            iters):
    """Every block, both modes; nodes whose windows hold no point (above
    the void region's cloud) are exactly 0 in both."""
    args = _inputs(getattr(fx, cloud)(), 10, cuda_device)
    got, want = _launch_and_plain(args, 10, mode, power, iters)
    _check(got, want)
    overflow, n = _overflow(args)
    assert overflow < n
    if cloud == "void_region":
        empty = (want[..., :3] == 0).all(dim=-1)
        assert int(empty.sum()) > 100, "fixture must have empty windows"
        assert bool((got[..., :3][empty] == 0).all())


def test_pallas_kernel_on_a_block_subset(cuda_device):
    """Blocks in another order than the lattice's, corners first."""
    starts, ids, *rest = _inputs(fx.corner_slab(), 10, cuda_device)
    n = starts.shape[0]
    pick = torch.tensor([n - 1, 0, 7, n // 2, 3, n - 2], device=cuda_device)
    args = (starts[pick].contiguous(), ids[pick].contiguous(), *rest)
    got, want = _launch_and_plain(args, 10, "sibson", 2.0)
    _check(got, want)
    full = tpg._pallas_eval(starts, ids, *rest, 10, "sibson", 2.0, 14)
    assert torch.equal(got, full[pick])


@pytest.mark.parametrize("iters", [1, 2, 4, 5, 12, 13, 14, 24])
@pytest.mark.parametrize("mode,power", [("sibson", 2.0), ("idw", 2.0),
                                        ("idw", 3.0)])
def test_pallas_kernel_halvings_on_gpu(cuda_device, mode, power, iters):
    """Halvings that stop on the panel (1 to 12: tree visits of fewer
    levels at the end) and that go on on the shortlist (13, 14, 24), every
    block of the corner slab."""
    args = _inputs(fx.corner_slab(), 10, cuda_device)
    _check(*_launch_and_plain(args, 10, mode, power, iters))
    overflow, n = _overflow(args)
    assert overflow < n


def _duplicated_cloud():
    """A uniform cloud with one point copied 80 times beside a grid node:
    more than the k + 48 entries a shortlist holds at k = 10, so the nodes
    around it count more than their list holds after 12 halvings."""
    pts, vals, bounds, n = fx.uniform()
    extra = np.repeat([[12.3, 11.8, 12.1]], 80, 0).astype(np.float32)
    extra_vals = np.ones((len(extra), 3), np.float32)
    return (np.concatenate([pts, extra]), np.concatenate([vals, extra_vals]),
            bounds, n)


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_pallas_kernel_overflow_on_duplicates_on_gpu(cuda_device, mode):
    """Nodes beside 80 coincident points run over the whole panel, with
    the same result; the others stay on their shortlists."""
    args = _inputs(_duplicated_cloud(), 10, cuda_device)
    _check(*_launch_and_plain(args, 10, mode, 2.0))
    overflow, n = _overflow(args)
    assert 0 < overflow < n


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_pallas_kernel_without_lists_on_gpu(cuda_device, mode, monkeypatch):
    """With S forced to 0 every node runs over the whole panel, and the
    result is the same as on the shortlists, bit for bit."""
    args = _inputs(fx.corner_slab(), 10, cuda_device)
    listed = tpg._pallas_eval(*args, 10, mode, 2.0, 14)
    plan = tpg._list_plan
    monkeypatch.setattr(tpg, "_list_plan",
                        lambda C, B, k: (0,) + plan(C, B, k)[1:])
    got, want = _launch_and_plain(args, 10, mode, 2.0)
    _check(got, want)
    overflow, n = _overflow(args)
    assert overflow == n
    assert torch.equal(got, listed)


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_pallas_kernel_chunked_staging(cuda_device, mode, monkeypatch):
    """Panels wider than the staged width are staged chunk by chunk on
    every pass, and every node runs over the whole panel: a dense cloud at
    k=300, whose C exceeds the width, and a small cloud with the width cut
    to 512 slots."""
    pts = np.random.default_rng(3).uniform(0, 16, size=(20000, 3)).astype(
        np.float32)
    vals = np.stack([np.sin(pts[:, 0]), np.cos(pts[:, 1]), pts[:, 2]],
                    axis=-1).astype(np.float32)
    args = _inputs((pts, vals, ((0, 17),) * 3, 16), 300, cuda_device)
    starts, L = args[0], args[-1]
    assert starts.shape[1] * L > tpg._MAX_CHUNK
    _check(*_launch_and_plain(args, 300, mode, 2.0))
    assert _overflow(args)[0] == _overflow(args)[1]
    monkeypatch.setattr(tpg, "_MAX_CHUNK", 512)
    args = _inputs(fx.corner_slab(), 10, cuda_device)
    assert args[0].shape[1] * args[-1] > 512
    _check(*_launch_and_plain(args, 10, mode, 2.0))
    assert _overflow(args)[0] == _overflow(args)[1]


def test_pallas_kernel_refuses_non_contiguous_input(cuda_device):
    starts, ids, *rest = _inputs(fx.uniform(), 10, cuda_device)
    strided = torch.empty((starts.shape[0], 2 * starts.shape[1]),
                          dtype=torch.int32, device=cuda_device)[:, ::2]
    strided.copy_(starts)
    with pytest.raises(ValueError, match="contiguous"):
        tpg._pallas_eval(strided, ids, *rest, 10, "idw", 2.0, 14)


@pytest.mark.parametrize("entry", [sibson_grid_interpolate,
                                   idw_grid_interpolate])
def test_pallas_route_on_gpu_matches_cpu(cuda_device, entry):
    """``backend='pallas'`` through the entry points launches the kernel
    once and agrees with the plain version's route on the CPU."""
    pts, vals, bounds, n = fx.ragged()
    grid = create_grid(bounds, n)
    with capture() as rec:
        got = entry(pts, vals, grid, k=10, backend="pallas",
                    device=cuda_device)
    torch.cuda.synchronize()
    assert rec.counters()["kernel3.launches"] == 1
    want = entry(pts, vals, grid, k=10, backend="pallas", device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("route", ["xla", "exact_topk"])
def test_streaming_and_gather_routes_on_gpu_match_cpu(cuda_device, route):
    """The streaming path (its repair ladder launches the grid kernel) and
    the exact top-k gather path on the GPU against the CPU."""
    pts, vals, bounds, n = fx.void_region()
    grid = create_grid(bounds, n)
    kw = dict(k=8, block=(2, 4, 8))
    kw.update(dict(backend="xla") if route == "xla" else
              dict(exact_topk=True))
    with capture() as rec:
        got = sibson_grid_interpolate(pts, vals, grid, device=cuda_device,
                                      **kw)
    torch.cuda.synchronize()
    stages = _stages(rec)
    if route == "xla":
        assert rec.counters()["kernel1.launches"] > 0
    with capture() as rec:
        want = sibson_grid_interpolate(pts, vals, grid, device="cpu", **kw)
    if route == "xla":
        assert stages == _stages(rec)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
