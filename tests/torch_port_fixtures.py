"""Inputs and helpers shared by the ``test_torch_*.py`` files, which hold
the PyTorch port against the JAX package on the same numpy inputs. Each
point cloud is made from a seed and returns ``(points, values, bounds,
n)``; the grid is ``create_grid(bounds, n)``. The cleaning problems return
a fluid mask, a field and the spacing."""

import contextlib
import io
import re

import numpy as np


def uniform(n_pts=4000, n=24, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, n, size=(n_pts, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.3), np.cos(pts[:, 1] * 0.2),
                     1.0 + 0.1 * pts[:, 2] / n], axis=-1).astype(np.float32)
    return pts, vals, ((0, n + 1),) * 3, n


def ragged():
    """A grid whose shape is no multiple of the blocks: padded axes, and
    blocks that straddle the grid's far faces. Returns a resolution
    (nx, ny, nz) in place of ``n``."""
    rng = np.random.default_rng(17)
    pts = rng.uniform([0, 0, 0], [20, 17, 12], size=(2500, 3)).astype(
        np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.3), np.cos(pts[:, 2] * 0.4),
                     pts[:, 1] * 0.1], axis=-1).astype(np.float32)
    return pts, vals, ((0, 21), (0, 18), (0, 13)), (21, 18, 13)


def dense_knot():
    """A uniform cloud with 1600 points packed into a 0.5-wide knot: the
    first cell size puts more than 1024 points in one candidate row, so
    the setup refines the cell list once."""
    rng = np.random.default_rng(19)
    bg = rng.uniform(0, 24, size=(2500, 3))
    knot = 12.0 + rng.uniform(0, 0.5, size=(1600, 3))
    pts = np.concatenate([bg, knot]).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.3), np.cos(pts[:, 1] * 0.2),
                     np.ones(len(pts))], axis=-1).astype(np.float32)
    return pts, vals, ((0, 25),) * 3, 24


def void_region():
    """The cloud fills only z < 5 of a 16³ grid: the upper nodes are
    uncovered and go to repair."""
    rng = np.random.default_rng(11)
    pts = rng.uniform([0, 0, 0], [16, 16, 5], size=(800, 3)).astype(
        np.float32)
    vals = np.stack([np.sin(pts[:, 0]), np.cos(pts[:, 1]),
                     np.ones(len(pts))], axis=-1).astype(np.float32)
    return pts, vals, ((0, 17),) * 3, 16


def skip_mask_cloud():
    """Constant values under a void; ``skip`` marks the void's nodes."""
    rng = np.random.default_rng(13)
    pts = rng.uniform([0, 0, 0], [16, 16, 5], size=(800, 3)).astype(
        np.float32)
    vals = np.ones((len(pts), 3), np.float32)
    return pts, vals, ((0, 17),) * 3, 16


def skip_mask():
    skip = np.zeros((16, 16, 16), bool)
    skip[8:] = True
    return skip


def clustered():
    """Gaussian blobs on a sparse background."""
    rng = np.random.default_rng(9)
    n = 24
    blobs = [rng.normal(loc=c, scale=1.5, size=(1200, 3))
             for c in ((6, 6, 6), (18, 16, 8), (10, 18, 18))]
    bg = rng.uniform(0, n, size=(300, 3))
    pts = np.clip(np.concatenate(blobs + [bg]), 0, n).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.4), np.cos(pts[:, 1] * 0.3),
                     1.0 + 0.05 * pts[:, 2]], axis=-1).astype(np.float32)
    return pts, vals, ((0, n + 1),) * 3, n


def corner_slab():
    """The cloud fills z < 9 of a 24³ grid: coverage fails near the far
    faces, where repair certifies most nodes at the widened margin."""
    rng = np.random.default_rng(21)
    n = 24
    pts = rng.uniform([0, 0, 0], [n, n, 9], size=(2500, 3)).astype(
        np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.3), np.cos(pts[:, 1] * 0.2),
                     1.0 + 0.02 * pts[:, 2]], axis=-1).astype(np.float32)
    return pts, vals, ((0, n + 1),) * 3, n


def duplicated():
    """A uniform cloud with one point copied 64 times onto a grid node
    (more than the k + 32 entries a shortlist holds at k = 10; few enough
    that the kernel's sequential f32 sum of their equal weights stays
    within rtol 1e-5 of the plain version's) and a 4³ lattice of points
    at whole coordinates (tied distances)."""
    pts, vals, bounds, n = uniform()
    lattice = np.stack(np.meshgrid(*[np.arange(4, 8)] * 3), -1).reshape(-1, 3)
    extra = np.concatenate([np.repeat([[12.0, 12.0, 12.0]], 64, 0),
                            lattice]).astype(np.float32)
    extra_vals = np.ones((len(extra), 3), np.float32)
    return (np.concatenate([pts, extra]), np.concatenate([vals, extra_vals]),
            bounds, n)


def lattice(n=12):
    """A point at every whole coordinate of [0, n-1]³ and a grid node on
    each: the squared distances are whole numbers, tied many times over
    (at k = 10 the k-th is 2 at every node off the corners)."""
    ax = np.arange(n, dtype=np.float32)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    vals = np.stack([np.sin(pts[:, 0] * 0.3), np.cos(pts[:, 1] * 0.2),
                     1.0 + 0.1 * pts[:, 2]], axis=-1).astype(np.float32)
    return pts, vals, ((0, n),) * 3, n


def kernel1_setup(cloud, block, k, device="cpu", C=None, ids=None,
                  repair=False):
    """Kernel 1's inputs on ``cloud`` as the grid path forms them, as a
    dict: the cell list (``cells``, ``values_sorted``), the padded
    ``axes``, ``margin`` and its f32 square ``m2``, ``mc``, ``C``,
    ``grid_shape``, ``block``, ``ids``. The main pass's, or with
    ``repair`` the repair's (1.6× the margin, its region and f32 m2) over
    the blocks ``ids``. ``C`` widens the panel past the largest block's
    candidate count (the extra slots are sentinels)."""
    from ptv_interpolation_tpu_torch.grid import create_grid
    from ptv_interpolation_tpu_torch.ops import fused_grid_knn as tfg
    from ptv_interpolation_tpu_torch.ops import grid_knn as tgk
    pts, vals, bounds, n = cloud
    grid = create_grid(bounds, n)
    cells, vs, axes, margin, mc, _, _ = tgk._host_setup(
        pts, vals, grid, k, block, 1.45, cell_divisor=3.0, device=device)
    m2 = np.float32(margin * margin)
    if repair:
        margin, mc, axes = tfg._repair_plan(cells, grid, block, margin)
        m2 = np.float32(margin) * np.float32(margin)
    C_raw = tfg._panel_width(tfg._block_total_capacity(
        cells, axes, margin, block, grid.shape, mc, ids=ids))
    assert C is None or C >= C_raw
    return dict(cells=cells, values_sorted=vs, axes=axes, margin=margin,
                m2=m2, mc=mc, C=C_raw if C is None else C,
                grid_shape=grid.shape, block=block, ids=ids)


def kernel1_cells(s, k, mode, tau2=None):
    """:func:`_fused_eval_cells` on the inputs of :func:`kernel1_setup`."""
    from ptv_interpolation_tpu_torch.ops import fused_grid_knn as tfg
    return tfg._fused_eval_cells(
        s["cells"], s["values_sorted"], s["axes"], s["margin"], s["m2"],
        s["block"], s["grid_shape"], s["mc"], s["C"], k, mode, 2.0,
        ids=s["ids"], tau2=tau2)


def kernel1_phase1(s):
    """Phase 1 on the inputs of :func:`kernel1_setup`: ``(m2, cand, (qx,
    qy, qz), sz, C)``, the panel and query rows of the plain version."""
    from ptv_interpolation_tpu_torch.ops import fused_grid_knn as tfg
    block, C = s["block"], s["C"]
    dims = tuple((n + b - 1) // b for n, b in zip(s["grid_shape"], block))
    sz = tfg._pick_sz(*block)
    cand = tfg._compact_gather(s["cells"], s["values_sorted"], s["axes"],
                               s["margin"], block, s["grid_shape"], s["mc"],
                               C, ids=s["ids"])
    q = tfg._build_queries(s["axes"], block, dims, sz, ids=s["ids"],
                           device=s["cells"].device)
    return s["m2"], cand, q, sz, C


def kernel1_panel(cloud, block, k, device="cpu", C=None):
    """Kernel 1's panel inputs on ``cloud`` as the grid path forms them:
    ``(m2, cand, (qx, qy, qz), sz, C)`` (:func:`kernel1_phase1` of the main
    pass)."""
    return kernel1_phase1(kernel1_setup(cloud, block, k, device, C=C))


def kernel1_d2(cand, q, block, sz, C):
    """Every node's d² to every slot of its block's panel, (rows, Bt, C)
    f32, in kernel 1's op order ((dx·dx + dy·dy) + dz·dz)."""
    n_sub = block[0] // sz
    panel = cand.view(8, -1, C)[:3].repeat_interleave(n_sub, dim=1)
    d2 = None
    for a in range(3):
        d = q[a].transpose(1, 2) - panel[a][:, None, :]
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def kernel1_bucket(d2, m2):
    """Kernel 1's pass-A bucket of each d²: min(⌊d²·inv⌋, 15) with inv =
    16/m2 rounded to f32, and 16 above m2."""
    inv = np.float32(16.0) / np.float32(m2)
    b = (d2 * float(inv)).clamp_max(15.0).floor().long()
    return b.masked_fill(d2 > float(m2), 16)


def odd_anisotropic():
    """The odd-extent, anisotropic cleaning problem of
    ``tests/test_physics.py::test_variational_woodbury_odd_anisotropic``:
    a (21, 24, 27) grid around an ellipsoidal solid, spacing (1.0, 1.3,
    0.7). Returns ``(fluid, u, v, w, (dx, dy, dz))``, f32 and zero in the
    solid."""
    shape = (21, 24, 27)
    az = np.arange(shape[0]) - shape[0] / 2 + 0.5
    ay = np.arange(shape[1]) - shape[1] / 2 + 0.5
    ax = np.arange(shape[2]) - shape[2] / 2 + 0.5
    Z, Y, X = np.meshgrid(az, ay, ax, indexing="ij")
    fluid = ~(((X / 8.0) ** 2 + (Y / 7.0) ** 2 + (Z / 6.0) ** 2) < 1.0)
    rng = np.random.default_rng(11)
    mf = fluid.astype(np.float32)
    u = (0.1 * rng.normal(size=shape)).astype(np.float32) * mf
    v = (0.1 * rng.normal(size=shape)).astype(np.float32) * mf
    w = (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32) * mf
    return fluid, u, v, w, (1.0, 1.3, 0.7)


def sphere_problem(n=16):
    """``_sphere_mask(n)`` and ``_divergent_field(n)`` of
    ``tests/test_physics.py``, the field f32 and zero in the solid.
    Returns ``(fluid, u, v, w, (1.0, 1.0, 1.0))``."""
    from test_physics import _divergent_field, _sphere_mask
    fluid = _sphere_mask(n)
    u, v, w = (np.asarray(a * fluid, np.float32) for a in _divergent_field(n))
    return fluid, u, v, w, (1.0, 1.0, 1.0)


def faces_mask(shape=(6, 7, 8), seed=0):
    """A random mask (65% fluid) whose fluid touches all six faces of the
    domain: every domain-edge Neumann term of the divergence is live."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.35
    mask[0, 0, 0] = mask[-1, -1, -1] = True
    mask[0, -1, 0] = mask[-1, 0, -1] = True
    return mask


_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\d+)(?:e[-+]?\d+)?")


def printed_lines(fn, *args, **kw):
    """The lines ``fn(*args, **kw)`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return out.getvalue().splitlines()


def _last_digit(text):
    """One unit of the last printed digit of a number's text."""
    mantissa, _, exp = text.partition("e")
    decimals = len(mantissa.partition(".")[2])
    return 10.0 ** ((int(exp) if exp else 0) - decimals)


def assert_reports_match(got_lines, want_lines, rtol=1e-5, iters=2):
    """Two cleaning reports: the same lines with the same text between the
    numbers; each number within ``rtol`` or one unit of its last printed
    digit, the CG iteration count within ``iters``."""
    assert len(got_lines) == len(want_lines), (got_lines, want_lines)
    for g, w in zip(got_lines, want_lines):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        for a, b in zip(_NUMBER.findall(g), _NUMBER.findall(w)):
            if g.startswith("CG iterations"):
                assert abs(int(a) - int(b)) <= iters, (g, w)
            else:
                tol = max(rtol * abs(float(b)), _last_digit(b))
                assert abs(float(a) - float(b)) <= tol, (g, w)


def carry_cells(jax_cells, device="cpu"):
    """The JAX package's cell list as the port's, through the host."""
    from ptv_interpolation_tpu_torch.convert import cells_from_numpy
    return cells_from_numpy(
        np.asarray(jax_cells.starts), np.asarray(jax_cells.order),
        np.asarray(jax_cells.points_sorted), np.asarray(jax_cells.origin),
        np.asarray(jax_cells.inv_cell), jax_cells.dims, jax_cells.cap,
        jax_cells.n_points, inv_host=jax_cells.inv_host, device=device)


def cell_density_cube(n=40, seed=4):
    """Tracks uniform in [0, n)³ at the density of the benchmark's
    headline cells (1M tracks per 256³), carrying their field; the bounds
    put n nodes a side over [0, n]."""
    rng = np.random.default_rng(seed)
    n_pts = int(round(1e6 / 256 ** 3 * n ** 3))
    pts = rng.uniform(0, n, (n_pts, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.05), np.cos(pts[:, 1] * 0.04),
                     1.0 + 0.1 * np.sin(pts[:, 2] * 0.03)],
                    -1).astype(np.float32)
    return pts, vals, ((0, n + 1),) * 3, n


def grid_nodes(grid):
    """(Q, 3) x, y, z of every node of ``grid``, in its (z, y, x) order."""
    Z, Y, X = np.meshgrid(grid.z, grid.y, grid.x, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)


def face_rows(shape):
    """Flat bool mask of the nodes on any face of a (nz, ny, nx) grid."""
    import torch
    face = torch.zeros(shape, dtype=torch.bool)
    for dim in range(3):
        face.narrow(dim, 0, 1).fill_(True)
        face.narrow(dim, shape[dim] - 1, 1).fill_(True)
    return face.reshape(-1)


def rbf_grid_route(pts, vals, grid, k, device, block=(4, 8, 16),
                   margin_factor=1.45):
    """One call of ``interpolate_field(method="rbf")`` on the grid route
    under ``capture()``: the field (Q, 3) in f64 on the CPU, the selection
    it made (``grid_knn_apply``'s output, (Q, 2k): d² then point ids), the
    spans, the counters, and the margin of the blocks' regions
    (``block`` and ``margin_factor`` are the route's defaults)."""
    import pytest
    import torch

    from ptv_interpolation_tpu_torch.interpolate import interpolate_field
    from ptv_interpolation_tpu_torch.ops import grid_knn as tgk
    from ptv_interpolation_tpu_torch.utils import capture
    seen = []
    original = tgk.grid_knn_apply

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        seen.append(out.reshape(-1, out.shape[-1]).cpu())
        return out

    with pytest.MonkeyPatch.context() as mp, capture() as rec:
        mp.setattr(tgk, "grid_knn_apply", recording)
        u, v, w = interpolate_field(pts, vals, grid, method="rbf",
                                    rbf_neighbors=k,
                                    use_grid_kernel="always", device=device)
        spans, counters = rec.spans(), rec.counters()
    (selection,) = seen
    margin = tgk._host_setup(torch.from_numpy(pts), torch.from_numpy(vals),
                             grid, k, block, margin_factor,
                             device="cpu")[3]
    field = torch.stack([u.reshape(-1), v.reshape(-1), w.reshape(-1)], 1)
    return {"field": field.double().cpu(), "selection": selection,
            "spans": spans, "counters": counters, "margin": margin}
