"""The port's one-phase grid kernel route (``backend='pallas'``) on the CPU,
where it runs the kernel's plain version, against the JAX package's
Pallas kernel in interpret mode on the same numpy inputs: the host setup
(window starts, gapped store, window length) bit for bit, and the field at
every node. The CUDA kernel itself is held against its plain version in
``test_torch_pallas_grid_knn_gpu.py``."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.grid import create_grid as jax_create_grid
from ptv_interpolation_tpu.ops import pallas_grid_knn as jpg
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import knn_weights as tkw
from ptv_interpolation_tpu_torch.ops import pallas_grid_knn as tpg
from ptv_interpolation_tpu_torch.utils import capture
import torch_port_fixtures as fx

torch.set_num_threads(2)

# IDW: the same f32 ops on bit-equal d² and τ² (only the sums' order
# differs). Sibson: the kernel's one-pass variance s2 − s1² cancels, which
# magnifies the JAX package's f32 summation error (the port sums in f64)
# to a few 1e-6.
TOL = {"idw": dict(rtol=1e-5, atol=1e-6), "sibson": dict(rtol=5e-4, atol=5e-5)}


def anisotropic():
    """An anisotropic cloud on an odd-shaped grid (19 × 13 × 7 nodes)."""
    rng = np.random.default_rng(22)
    pts = rng.uniform(0, 20, size=(3000, 3)).astype(np.float32)
    pts[:, 2] *= 0.5
    vals = np.stack([pts[:, 0] * 0.1, np.sin(pts[:, 1]), np.cos(pts[:, 2])],
                    axis=-1).astype(np.float32)
    return pts, vals, ((0, 21), (0, 21), (0, 11)), (19, 13, 7)


def small_uniform():
    return fx.uniform(n_pts=3000, n=16)


CLOUDS = {"uniform": small_uniform, "anisotropic": anisotropic,
          "void_region": fx.void_region}


@pytest.mark.parametrize("cloud,mode,power,iters", [
    ("uniform", "sibson", 2.0, 14),
    ("uniform", "idw", 2.0, 14),
    ("uniform", "idw", 2.5, 14),
    ("uniform", "sibson", 2.0, 18),
    ("anisotropic", "idw", 2.0, 18),
    ("anisotropic", "sibson", 2.0, 14),
    ("void_region", "sibson", 2.0, 14),
    ("void_region", "idw", 2.5, 14),
])
def test_plain_matches_pallas_interpret(cloud, mode, power, iters):
    """Every node within ``TOL[mode]``; nodes whose windows are all empty
    (the void above the cloud) are exactly 0 in both packages."""
    pts, vals, bounds, n = CLOUDS[cloud]()
    k = 10
    want = np.asarray(jpg.pallas_grid_weighted_interpolate(
        pts, vals, jax_create_grid(bounds, n), k, mode=mode, power=power,
        bisect_iters=iters, interpret=True))
    with capture() as rec:
        got = tpg.pallas_grid_weighted_interpolate(
            pts, vals, create_grid(bounds, n), k, mode=mode, power=power,
            bisect_iters=iters, device="cpu")
    assert "kernel3.launches" not in rec.counters()  # CPU: the plain version
    assert got.device.type == "cpu" and got.shape == want.shape
    got = got.numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    if cloud == "void_region":
        assert (want == 0).all(axis=-1).sum() > 100, "fixture must have voids"
    np.testing.assert_allclose(got, want, **TOL[mode])


def _captured(module, monkeypatch, call):
    """The arguments ``module._pallas_eval`` received in ``call()``."""
    seen = {}
    inner = module._pallas_eval

    def grab(*a, **kw):
        seen["args"] = a
        return inner(*a, **kw)

    monkeypatch.setattr(module, "_pallas_eval", grab)
    call()
    return seen["args"]


@pytest.mark.parametrize("cloud", ["uniform", "anisotropic"])
def test_host_setup_matches_jax(cloud, monkeypatch):
    """Window starts, gapped store and window length bit for bit: with 14
    halvings τ² depends on the bound hi over the whole windows, so a
    tidier window would move τ² for interior nodes too."""
    pts, vals, bounds, n = CLOUDS[cloud]()
    j_starts, j_q, j_store, R, L, B = _captured(
        jpg, monkeypatch, lambda: jpg.pallas_grid_weighted_interpolate(
            pts, vals, jax_create_grid(bounds, n), 10, mode="idw",
            interpret=True))[:6]
    starts, axes, store, dims, t_L = tpg._pallas_setup(
        pts, vals, create_grid(bounds, n), 10, (2, 8, 8), 1.45, device="cpu")
    assert t_L == L and starts.shape == (np.prod(dims), R) and B == 128
    np.testing.assert_array_equal(starts.numpy(), np.asarray(j_starts)[:, :R])
    np.testing.assert_array_equal(store.numpy(), np.asarray(j_store))
    # the node coordinates the kernel derives from the padded axes
    ids = torch.arange(starts.shape[0])
    from ptv_interpolation_tpu_torch.ops.grid_knn import _block_queries
    qx, qy, qz, _ = _block_queries(axes, (2, 8, 8), dims[1], dims[2], ids)
    for got, want in zip((qx, qy, qz), np.asarray(j_q)[:, :3].transpose(
            1, 0, 2)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_route_to_the_kernel():
    """``backend='pallas'`` through both grid entry points: the kernel's
    route with its own defaults (block, skip_mask and τ options ignored)."""
    pts, vals, bounds, n = small_uniform()
    grid = create_grid(bounds, n)
    for entry, mode in ((tkw.sibson_grid_interpolate, "sibson"),
                        (tkw.idw_grid_interpolate, "idw")):
        got = entry(pts, vals, grid, k=10, backend="pallas",
                    block=(4, 4, 8), skip_mask=np.ones(grid.shape, bool),
                    device="cpu")
        want = tpg.pallas_grid_weighted_interpolate(pts, vals, grid, 10,
                                                    mode=mode, device="cpu")
        assert torch.equal(got, want)


def test_too_many_rows_raise_in_both_packages():
    """A block whose candidate region spans more than 128 (z, y) rows."""
    pts, vals, bounds, n = fx.uniform(n_pts=4000, n=24)
    with pytest.raises(ValueError, match="128"):
        jpg.pallas_grid_weighted_interpolate(
            pts, vals, jax_create_grid(bounds, n), 10, block=(24, 24, 8),
            interpret=True)
    with pytest.raises(ValueError, match="128"):
        tpg.pallas_grid_weighted_interpolate(
            pts, vals, create_grid(bounds, n), 10, block=(24, 24, 8),
            device="cpu")
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        tpg.pallas_grid_weighted_interpolate(
            pts, vals[:, :2], create_grid(bounds, n), 10, device="cpu")


def test_pallas_eval_input_checks():
    starts, axes, store, dims, L = tpg._pallas_setup(
        *small_uniform()[:2], create_grid(*small_uniform()[2:]), 10,
        (2, 8, 8), 1.45, device="cpu")
    ids = torch.arange(starts.shape[0], dtype=torch.int32)
    args = (starts, ids, axes, store, (2, 8, 8), dims, L, 10)
    out = tpg._pallas_eval(*args, "idw", 2.0, 14)
    assert out.shape == (starts.shape[0], 128, 4)
    with pytest.raises(ValueError, match="mode"):
        tpg._pallas_eval(*args, "rbf", 2.0, 14)
    with pytest.raises(ValueError, match="starts"):
        tpg._pallas_eval(starts.long(), *args[1:], "idw", 2.0, 14)
    with pytest.raises(ValueError, match="ids"):
        tpg._pallas_eval(starts, ids[1:], *args[2:], "idw", 2.0, 14)
    with pytest.raises(ValueError, match="axes"):
        tpg._pallas_eval(starts, ids, (axes[0][1:],) + axes[1:], *args[3:],
                         "idw", 2.0, 14)
    with pytest.raises(ValueError, match="store"):
        tpg._pallas_eval(starts, ids, axes, store[:3], *args[4:], "idw", 2.0,
                         14)
    meta = [t.to("meta") for t in (starts, ids, store, *axes)]
    with pytest.raises(ValueError, match="unsupported device"):
        tpg._pallas_eval(meta[0], meta[1], tuple(meta[3:]), meta[2],
                         *args[4:], "idw", 2.0, 14)


@pytest.mark.parametrize("C,B,k", [(6144, 128, 50), (7168, 128, 10),
                                   (19328, 128, 10), (27648, 128, 300),
                                   (6144, 1024, 50), (512, 64, 1)])
def test_list_plan_fits_shared_memory(C, B, k):
    """The kernel's shared-memory plan stays within the 232 448 bytes a CTA
    may use beside its 512 bytes of window starts, keeps the shortlists
    wherever they fit beside a panel staged once, and plans S = 0 where
    they do not or where the panel is staged chunk by chunk."""
    S, chunk, smem = tpg._list_plan(C, B, k)
    assert smem + 4 * 128 <= 232448
    assert chunk == min(C, tpg._MAX_CHUNK)
    panel = 12 * -(-chunk // 4) * 4
    assert smem == panel + 2 * S * B
    fits = chunk == C and panel + 2 * (k + 48) * B + 512 <= 232448
    assert S == (k + 48 if fits else 0)


def test_list_plan_at_the_headline():
    """The headline's C = 6 144, 128 nodes, k = 50: 72 KiB of planes and
    98 entries a node, 98 816 bytes, so that two CTAs share an SM's 228 KB
    (with 1 KB reserved per CTA); wider panels are chunked with S = 0."""
    assert tpg._list_plan(6144, 128, 50) == (98, 6144, 98816)
    assert 2 * (98816 + 512 + 1024) <= 228 * 1024
    assert tpg._MAX_CHUNK == 19328
    assert tpg._list_plan(19456, 128, 10)[:2] == (0, 19328)
    assert tpg._list_plan(6144, 1024, 80)[0] == 0


# A model in numpy f32 of the kernel's halvings: 4-level trees over the
# panel, then the shortlist's settled base and open slots.

def _f32(x):
    return np.float32(x)


def _tree(lo, hi):
    """The 15 midpoints the sequential loop forms down each branch of 4
    halvings of [lo, hi], in heap order; t[0] = hi."""
    t, l, h = [_f32(0)] * 16, [_f32(0)] * 16, [_f32(0)] * 16
    t[0], l[1], h[1] = hi, lo, hi
    for n in range(1, 16):
        if n > 1:
            p = n >> 1
            l[n], h[n] = (t[p], h[p]) if n & 1 else (l[p], t[p])
        t[n] = _f32(0.5) * (l[n] + h[n])
    return t


def _halve(d2, base, levels, k, lo, hi):
    """One visit: the counts at every midpoint (``base`` slots not in
    ``d2`` count everywhere), then the walk of ``levels`` levels. Returns
    (lo, hi, #{d² ≤ hi})."""
    t = _tree(lo, hi)
    c = [base + int((d2 <= tn).sum()) for tn in t]
    n_hi, node = c[0], 1
    for n in range(1, 1 << levels):
        if n == node:
            if c[n] < k:
                lo, node = t[n], 2 * n + 1
            else:
                hi, n_hi, node = t[n], c[n], 2 * n
    return lo, hi, n_hi


def _kernel_halvings(d2, k, hi, iters, S, list_after=12):
    """The kernel's steps: ``list_after`` halvings on the panel, 4 a sweep;
    the list of the slots at d² ≤ hi when it holds S, its open slots and
    settled base; the other halvings on the open slots (or the panel)."""
    lo, done, on_panel = _f32(0), 0, min(iters, list_after)
    while True:
        levels = min(4, on_panel - done)
        lo, hi, n_hi = _halve(d2, 0, levels, k, lo, hi)
        done += levels
        if done >= on_panel:
            break
    slots, base = d2, 0
    if n_hi <= S:
        listed = d2[d2 <= hi]
        assert len(listed) == n_hi
        slots = listed[listed > lo]
        if len(slots) <= S - n_hi:
            base = n_hi - len(slots)
        else:
            slots = listed
    while done < iters:
        levels = min(4, iters - done)
        lo, hi, _ = _halve(slots, base, levels, k, lo, hi)
        done += levels
    return lo, hi, n_hi <= S


@pytest.mark.parametrize("iters", [0, 1, 2, 4, 5, 12, 13, 14, 24])
def test_tree_and_list_halvings_match_the_sequential_loop(iters):
    """In f32, on random d² sets with ties and duplicates, and k from 1 to
    past the set's size: the kernel's tree visits and shortlist land on the
    same (lo, hi] as ``iters`` sequential halvings of [0, hi]."""
    rng = np.random.default_rng(100 + iters)
    on_list = 0
    for case in range(120):
        n = int(rng.integers(1, 400))
        d2 = rng.uniform(0, 50, n).astype(np.float32)
        if case % 3 == 1:
            d2 = np.round(d2)                        # ties
        if case % 3 == 2:
            d2[: n // 2] = d2[0]                     # duplicated points
        k = int(rng.integers(1, n + 20))
        hi0 = _f32(d2.max()) * _f32(1.000001) + _f32(1e-30)
        lo, hi = _f32(0), hi0
        for _ in range(iters):
            mid = _f32(0.5) * (lo + hi)
            if (d2 <= mid).sum() >= k:
                hi = mid
            else:
                lo = mid
        S = k + 48 if case % 5 else 0
        got_lo, got_hi, listed = _kernel_halvings(d2, k, hi0, iters, S)
        assert (got_lo, got_hi) == (lo, hi), (case, n, k)
        assert got_lo.dtype == got_hi.dtype == np.float32
        on_list += listed
    assert on_list > 30
