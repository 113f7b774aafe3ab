"""The port's fused grid kNN stages against the JAX package on one cell
list carried across: setup, capacity planning and phase 1 bit for bit,
the kernel's plain version against the Pallas kernel in interpret mode,
and the repair stage. The CUDA kernel itself is held against its plain
version in ``test_torch_fused_grid_knn_gpu.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.grid import create_grid as jax_create_grid
from ptv_interpolation_tpu.ops import fused_grid_knn as jfg
from ptv_interpolation_tpu.ops import grid_knn as jgk
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.ops import fused_grid_knn as tfg
from ptv_interpolation_tpu_torch.ops import grid_knn as tgk
from ptv_interpolation_tpu_torch.utils import capture
import torch_port_fixtures as fx

torch.set_num_threads(2)

# fields: the kernel's plain version and the Pallas kernel sum in another
# order and differ by a few ulps in exp; d² and τ² decisions agree
RTOL, ATOL = 1e-5, 1e-6


def _jax_setup(cloud, k, block):
    pts, vals, bounds, n = cloud
    grid = jax_create_grid(bounds, n)
    cells, values_sorted, axes, margin, mc, row_len, values_dev = \
        jgk._host_setup(pts, vals, grid, k, None, None, block, 1.45,
                        cell_divisor=3.0)
    axes_np = tuple(np.asarray(a) for a in axes)
    C = max((jfg._block_total_capacity(cells, axes_np, margin, block,
                                       grid.shape, mc) + 127) // 128 * 128,
            128)
    dims = tuple((s + b - 1) // b for s, b in zip(grid.shape, block))
    return dict(grid=grid, cells=cells, values_sorted=values_sorted,
                axes=axes_np, margin=margin, mc=mc, row_len=row_len, C=C,
                dims=dims, sz=jfg._pick_sz(*block), V=vals.shape[1])


def _jax_panel(s, block, ids=None):
    ids_dev = None if ids is None else jnp.asarray(ids, jnp.int32)
    cand = jfg._compact_gather(s["cells"], s["values_sorted"], s["axes"],
                               jnp.float32(s["margin"]), block,
                               s["grid"].shape, s["mc"], s["C"], 8,
                               ids=ids_dev)
    q = jfg._build_queries(s["axes"], block, s["dims"], s["sz"], ids=ids_dev)
    return cand, q


def _torch(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("cloud,block", [
    ("uniform", (2, 4, 8)), ("uniform", (4, 4, 8)),
    ("dense_knot", (2, 4, 8)),       # the cell list is refined once
    ("ragged", (4, 4, 8)),           # axes padded to block multiples
])
def test_host_setup_matches_jax(cloud, block):
    pts, vals, bounds, n = getattr(fx, cloud)()
    s = _jax_setup(getattr(fx, cloud)(), 12, block)
    cells, vs, axes, margin, mc, row_len, v = tgk._host_setup(
        pts, vals, create_grid(bounds, n), 12, block, 1.45, cell_divisor=3.0,
        device="cpu")
    assert margin == s["margin"] and mc == s["mc"]
    assert row_len == s["row_len"]
    assert cells.dims == s["cells"].dims
    np.testing.assert_array_equal(cells.order.numpy(),
                                  np.asarray(s["cells"].order))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(s["values_sorted"]))
    for got, want in zip(axes, s["axes"]):
        np.testing.assert_array_equal(got, want)


def test_row_capacity_error_matches_jax():
    """1100 coincident points: no cell size keeps a row within the
    1024-row padding, in either package."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(0, 24, size=(2000, 3)),
                          np.full((1100, 3), 7.0)]).astype(np.float32)
    vals = np.ones((len(pts), 3), np.float32)
    bounds = ((0, 25),) * 3
    with pytest.raises(jgk.RowCapacityError):
        jgk._host_setup(pts, vals, jax_create_grid(bounds, 24), 10, None,
                        None, (2, 4, 8), 1.45, cell_divisor=3.0)
    with pytest.raises(tgk.RowCapacityError):
        tgk._host_setup(pts, vals, create_grid(bounds, 24), 10, (2, 4, 8),
                        1.45, cell_divisor=3.0, device="cpu")


@pytest.mark.parametrize("block", [(2, 4, 8), (4, 4, 8), (8, 8, 16)])
def test_block_total_capacity_matches_jax(block):
    s = _jax_setup(fx.uniform(), 12, block)
    cells = fx.carry_cells(s["cells"])
    grid_shape = s["grid"].shape
    want = jfg._block_total_capacity(s["cells"], s["axes"], s["margin"],
                                     block, grid_shape, s["mc"])
    got = tfg._block_total_capacity(cells, s["axes"], s["margin"], block,
                                    grid_shape, s["mc"])
    assert got == want
    ids = np.array([0, 3, int(np.prod(s["dims"])) - 1])
    margin2 = 1.6 * s["margin"]
    assert tfg._block_total_capacity(
        cells, s["axes"], margin2, block, grid_shape, s["mc"], ids=ids) == \
        jfg._block_total_capacity(s["cells"], s["axes"], margin2, block,
                                  grid_shape, s["mc"], ids=ids)


@pytest.mark.parametrize("cloud,block", [
    ("clustered", (2, 4, 8)), ("clustered", (4, 4, 8)),
    ("ragged", (4, 4, 8)),
])
@pytest.mark.parametrize("subset", [False, True])
def test_phase1_bit_equal(cloud, block, subset):
    """Compacted indices, candidate panel and query rows equal the JAX
    package's bit for bit."""
    s = _jax_setup(getattr(fx, cloud)(), 10, block)
    cells = fx.carry_cells(s["cells"])
    n_blocks = int(np.prod(s["dims"]))
    ids = np.array([n_blocks - 1, 0, 5, 17]) if subset else None
    ids_dev = None if ids is None else jnp.asarray(ids, jnp.int32)
    want_G = jfg._compact_indices(s["cells"], s["axes"],
                                  jnp.float32(s["margin"]), block,
                                  s["grid"].shape, s["mc"], s["C"],
                                  ids=ids_dev)
    got_G = tfg._compact_indices(cells, s["axes"], s["margin"], block,
                                 s["grid"].shape, s["mc"], s["C"], ids=ids)
    np.testing.assert_array_equal(got_G.numpy(), np.asarray(want_G))

    want_cand, want_q = _jax_panel(s, block, ids)
    vs = _torch(s["values_sorted"])
    got_cand = tfg._compact_gather(cells, vs, s["axes"], s["margin"], block,
                                   s["grid"].shape, s["mc"], s["C"], ids=ids)
    np.testing.assert_array_equal(got_cand.numpy(), np.asarray(want_cand))
    got_q = tfg._build_queries(s["axes"], block, s["dims"], s["sz"], ids=ids)
    for g, w in zip(got_q, want_q):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode,power,block", [
    ("sibson", 2.0, (2, 4, 8)),
    ("sibson", 2.0, (4, 4, 8)),
    ("idw", 2.0, (2, 4, 8)),
    ("idw", 2.0, (4, 4, 8)),
    ("idw", 3.0, (2, 4, 8)),
])
def test_fused_eval_plain_matches_pallas_kernel(mode, power, block):
    s = _jax_setup(fx.corner_slab(), 10, block)
    cand, q = _jax_panel(s, block)
    m2 = np.float32(s["margin"] * s["margin"])
    want = np.asarray(jfg._fused_eval(
        jnp.asarray([[m2]], jnp.float32), cand, *q, block, s["dims"],
        s["sz"], 10, s["V"], s["C"], mode, power, interpret=True))
    got = tfg._fused_eval_plain(m2, _torch(cand), *(_torch(a) for a in q),
                                block, s["sz"], 10, s["V"], s["C"], mode,
                                power).numpy()
    V = s["V"]
    assert (want[:, :, V] == 0).any(), "fixture must have uncovered nodes"
    np.testing.assert_array_equal(got[:, :, V] == 0, want[:, :, V] == 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_reassemble_and_survey_match_jax():
    block = (2, 4, 8)
    s = _jax_setup(fx.corner_slab(), 10, block)
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(int(np.prod(s["dims"])), block[0] // s["sz"], 8,
                           s["sz"] * block[1] * block[2])).astype(np.float32)
    den = raw[:, :, 3]
    den[den < 0.3] = 0.0               # uncovered nodes for the survey
    shape = s["grid"].shape
    want = np.asarray(jfg._reassemble(jnp.asarray(raw), block, s["dims"],
                                      s["sz"], shape))
    got = tfg._reassemble(_torch(raw), block, s["dims"], s["sz"], shape)
    np.testing.assert_array_equal(got.numpy(), want)
    skip = np.zeros(shape, bool)
    skip[:, :3] = True
    for sk in (None, skip):
        w = jfg._repair_survey(jnp.asarray(want[..., 3]),
                               None if sk is None else jnp.asarray(sk),
                               block, s["dims"], 64)
        g, ids = tfg._repair_survey(
            got[..., 3], None if sk is None else torch.from_numpy(sk),
            block, s["dims"], 64)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # past the survey's 64 ids, the device ids go on in order
        n_bad = int(g[1])
        assert n_bad > 64 and ids.shape == (n_bad,)
        np.testing.assert_array_equal(ids[:64].numpy(), g[2:].numpy())
        assert (torch.diff(ids) > 0).all()


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_fused_repair_matches_jax(mode):
    """The widened-margin repair on the corner-slab cloud: the same nodes
    certified, the same values, the same uncovered tail."""
    block, k = (2, 4, 8), 10
    s = _jax_setup(fx.corner_slab(), k, block)
    cand, q = _jax_panel(s, block)
    out = jfg._fused_eval(jnp.asarray([[s["margin"] ** 2]], jnp.float32),
                          cand, *q, block, s["dims"], s["sz"], k, s["V"],
                          s["C"], mode, 2.0, interpret=True)
    out = jfg._reassemble(out, block, s["dims"], s["sz"], s["grid"].shape)
    field, den = out[..., :3], out[..., 3]
    assert int((np.asarray(den) == 0).sum()) > 50, "fixture must need repair"
    want = jfg.fused_repair(field, den, None, s["cells"], s["values_sorted"],
                            s["grid"], k, mode, 2.0, block,
                            float(s["margin"]), interpret=True)
    got = tfg.fused_repair(_torch(field), _torch(den), None,
                           fx.carry_cells(s["cells"]),
                           _torch(s["values_sorted"]),
                           create_grid(*fx.corner_slab()[2:]), k, mode, 2.0,
                           block, float(s["margin"]))
    assert want is not None and got is not None
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cloud", ["uniform", "corner_slab"])
@pytest.mark.parametrize("block", [(2, 4, 8), (4, 4, 8), (8, 8, 16)])
def test_repair_plan_agrees_with_its_users(cloud, block, monkeypatch):
    """One plan for the widened-margin repair: its window covers a block
    and the widened margin on each side; each rank's slab store holds
    every row that window reads for the rank's blocks, with a halo of the
    widened margin; and the cell-list stage's guard radius reaches the
    factor times the margin."""
    import inspect
    from ptv_interpolation_tpu_torch.ops.neighbors import cell_meta_np
    from ptv_interpolation_tpu_torch.parallel import slab_store
    pts, vals, bounds, n = getattr(fx, cloud)()
    grid = create_grid(bounds, n)
    k = 10
    cells, vs, axes, margin, _, _, _ = tgk._host_setup(
        pts, vals, grid, k, block, 1.45, cell_divisor=3.0, device="cpu")
    margin2, mc2, axes2 = tfg._repair_plan(cells, grid, block, margin)
    inv = cell_meta_np(cells)[1]
    assert margin2 == tfg.REPAIR_MARGIN_FACTOR * margin
    dx, dy, dz = grid.spacing
    for m, ext in zip(mc2, (block[0] * dz, block[1] * dy, block[2] * dx)):
        assert (m - 1) / inv >= ext + 2.0 * margin2
    for got, want in zip(axes2, axes):
        np.testing.assert_array_equal(got, want)

    # two ranks' z-slabs, each a whole number of blocks, the last padded
    bz, n_dev = block[0], 2
    slab = -(-grid.nz // (n_dev * bz)) * bz
    z_slabs = tgk._pad_axis(grid.z, slab * n_dev).reshape(n_dev, slab)
    row0, n_loc, halo = slab_store._slab_windows(cells, z_slabs, bz, dz,
                                                 margin)
    assert halo == float(np.float32(margin2))
    m32 = torch.tensor(np.float32(margin2))
    for d in range(n_dev):
        lo = torch.cartesian_prod(torch.from_numpy(axes2[0][::block[2]]),
                                  torch.from_numpy(axes2[1][::block[1]]),
                                  torch.from_numpy(z_slabs[d, ::bz]))
        start, cnt = tgk._block_rows(cells, lo, m32, mc2)
        read = cnt > 0
        assert (start[read] >= row0[d]).all()
        assert (start[read] + cnt[read] <= row0[d] + n_loc[d]).all()

    field = torch.zeros(grid.shape + (3,))
    den = torch.ones(grid.shape)
    den[0, 0, 0] = den[-1, -1, -1] = 0.0            # two corner nodes
    guards = []
    celllist = tgk._celllist_repair_eval_csr
    bind = inspect.signature(celllist).bind

    def spy(*a, **kw):
        guards.append(bind(*a, **kw).arguments["guard_radius"])
        return celllist(*a, **kw)

    monkeypatch.setattr(tgk, "_celllist_repair_eval_csr", spy)
    tgk.repair_empty_nodes(field, den, torch.from_numpy(pts),
                           torch.from_numpy(vals), grid, k, "sibson", 2.0,
                           cells=cells, margin=margin, values_sorted=vs)
    guard, = guards
    assert guard >= tfg.REPAIR_MARGIN_FACTOR * margin


def test_fused_eval_input_checks():
    block, sz, C = (2, 4, 8), 2, 128
    cand = torch.zeros((8, 2 * C))
    q = torch.zeros((2, 1, 64))
    out = tfg._fused_eval(1.0, cand, q, q, q, block, sz, 4, 3, C, "idw", 2.0)
    assert out.shape == (2, 1, 8, 64)
    with pytest.raises(ValueError, match="mode"):
        tfg._fused_eval(1.0, cand, q, q, q, block, sz, 4, 3, C, "rbf", 2.0)
    with pytest.raises(ValueError, match="cand"):
        tfg._fused_eval(1.0, cand[:, :-1], q, q, q, block, sz, 4, 3, C,
                        "idw", 2.0)
    with pytest.raises(ValueError, match="queries"):
        tfg._fused_eval(1.0, cand, q[:1], q, q, block, sz, 4, 3, C, "idw",
                        2.0)
    with pytest.raises(ValueError, match="channels"):
        tfg._fused_eval(1.0, cand, q, q, q, block, sz, 4, 6, C, "idw", 2.0)
    with pytest.raises(ValueError, match="neighbour"):
        tfg._fused_eval(1.0, cand, q, q, q, block, sz, 0, 3, C, "idw", 2.0)
    meta = torch.zeros((8, 2 * C), device="meta")
    qm = torch.zeros((2, 1, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfg._fused_eval(1.0, meta, qm, qm, qm, block, sz, 4, 3, C, "idw", 2.0)


@pytest.mark.parametrize("block", [(3, 8, 16), (8, 16, 16)])
@pytest.mark.parametrize("subset", [False, True])
def test_build_queries_contiguous_at_one_deep_subtiles(block, subset):
    """Where ``_pick_sz`` gives sz = 1 the query rows are contiguous (a
    reshape of an expanded view gave a view there) and equal the JAX
    package's bit for bit."""
    s = _jax_setup(fx.uniform(), 10, block)
    assert s["sz"] == tfg._pick_sz(*block) == 1
    n_blocks = int(np.prod(s["dims"]))
    ids = np.array([n_blocks - 1, 0, 2]) if subset else None
    _, want_q = _jax_panel(s, block, ids)
    got_q = tfg._build_queries(s["axes"], block, s["dims"], 1, ids=ids)
    for g, w in zip(got_q, want_q):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cloud,block,repair", [
    ("corner_slab", (2, 4, 8), False), ("ragged", (4, 4, 8), False),
    ("duplicated", (2, 4, 8), False), ("corner_slab", (4, 8, 16), True),
    ("duplicated", (3, 8, 16), True), ("uniform", (8, 16, 16), True),
])
@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_fused_eval_cells_plain_path_matches_fused_eval(cloud, block, repair,
                                                        mode):
    """On the CPU the kernel's entry runs phase 1 (span ``ptv.grid.panel``)
    and the plain version (span ``ptv.grid.kernel1``): its rows and τ²
    equal what ``_fused_eval`` gives on phase 1's panel, over every block
    at the main margin, and over the last and the first block at the
    repair's."""
    k = 10
    pts, vals, bounds, n = getattr(fx, cloud)()
    dims = [-(-a // b) for a, b in zip(create_grid(bounds, n).shape, block)]
    ids = np.array([int(np.prod(dims)) - 1, 0]) if repair else None
    s = fx.kernel1_setup(getattr(fx, cloud)(), block, k, ids=ids,
                         repair=repair)
    m2, cand, q, sz, C = fx.kernel1_phase1(s)
    Bt = q[0].shape[2]
    tau2 = torch.empty((q[0].shape[0], Bt))
    with capture() as rec:
        got = fx.kernel1_cells(s, k, mode, tau2=tau2)
    assert [r["name"] for r in rec.spans()] == ["ptv.grid.panel",
                                                "ptv.grid.kernel1"]
    want_tau2 = torch.empty_like(tau2)
    want = tfg._fused_eval(m2, cand, *q, block, sz, k, 3, C, mode, 2.0,
                           tau2=want_tau2)
    assert got.shape == (q[0].shape[0] // (block[0] // sz), block[0] // sz,
                         8, Bt)
    assert torch.equal(got, want)
    assert torch.equal(tau2, want_tau2)
    assert bool((got[:, :, 3] > 0).any())


def test_fused_eval_cells_input_checks():
    """The entry refuses what the kernel cannot run, on any device."""
    s = fx.kernel1_setup(fx.uniform(), (2, 4, 8), 10)
    with pytest.raises(ValueError, match="mode"):
        fx.kernel1_cells(s, 10, "rbf")
    with pytest.raises(ValueError, match="neighbour"):
        fx.kernel1_cells(s, 0, "idw")
    with pytest.raises(ValueError, match="tau2"):
        fx.kernel1_cells(s, 10, "idw", tau2=torch.empty(3))
    meta = dict(s, cells=dataclasses.replace(
        s["cells"], points_sorted=s["cells"].points_sorted.to("meta")))
    with pytest.raises(ValueError, match="unsupported device"):
        fx.kernel1_cells(meta, 10, "idw")


def _k1_staging(C, rows):
    """Kernel 1's bytes beside its shortlists and lists for a panel of C
    slots (a multiple of 32) staged from ``rows`` CSR rows: x, y, z, and
    a box, a first run and a mask of run starts per 32 slots, and the
    runs' table."""
    return 12 * C + 38 * (C // 32) + 4 * rows


@pytest.mark.parametrize("C", [128, 1920, 4608, 8192])
@pytest.mark.parametrize("k", [1, 30, 50, 300])
def test_shortlist_plan_fits_shared_memory(C, k):
    """Both kernels' shortlist plans (256 threads; the grid kernel counts
    to k over the staged panel of 100 CSR rows, the headline's, the MAD
    kernel to k+1 over 16·C) stay within the 232 448 bytes a CTA may use,
    and keep the shortlists wherever they fit."""
    for need, panel in ((k, _k1_staging(C, 100)), (k + 1, 16 * C)):
        if panel != 16 * C:
            S, L, smem = tfg._kernel1_plan(C, 256, need, 100)
            smem -= 2 * L * 8
        else:
            S, smem = tfg._shortlist_plan(C, 256, need)
        assert smem <= 232448
        assert smem == panel + 2 * S * 256
        fits = panel + 2 * (need + 32) * 256 <= 232448
        assert S == (need + 32 if fits else 0)
    assert tfg._kernel1_plan(1920, 256, 50, 100) == (
        82, 568, _k1_staging(1920, 100) + 41984 + 16 * 568)
    assert tfg._kernel1_plan(8192, 256, 300, 100)[0] == 0
    assert tfg._shortlist_plan(4608, 256, 31) == (63, 16 * 4608 + 32256)


@pytest.mark.parametrize("C", [128, 1920, 3200, 8192])
@pytest.mark.parametrize("Bt", [64, 96, 128, 256, 512, 1024])
def test_kernel1_plan_fits_shared_memory(C, Bt):
    """Kernel 1's plan for C slots, Bt threads and 100 or 400 CSR rows:
    within the 232 448 bytes a CTA may use; the warps' lists (L ≤ C
    entries each, or none) take only what the SM has left at the CTAs per
    SM that the panel, the runs' table, the shortlists and the registers
    allow, so they never cost a CTA."""
    warps = Bt // 32
    for k in (1, 50, 300):
        for rows in (100, 400):
            S, L, smem = tfg._kernel1_plan(C, Bt, k, rows)
            base = _k1_staging(C, rows) + 2 * S * Bt
            assert smem == base + 2 * L * warps <= 232448
            assert L == 0 or 32 <= L <= C
            ctas = min(tfg._kernel1_ctas(Bt), 233472 // (base + 1024))
            assert 233472 // (smem + 1024) >= ctas


def test_kernel1_plan_headline_and_no_list():
    """At the headline's panel (C = 1 920 over 100 CSR rows, 256 threads,
    k = 50) 3 CTAs share an SM, each warp's list holding 568 entries (the
    warps' lists hold at most ~315); none where no list fits beside the
    panel and the shortlists, or where the threads fill no whole warp."""
    S, L, smem = tfg._kernel1_plan(1920, 256, 50, 100)
    assert (S, L) == (82, 568)
    assert 233472 // (smem + 1024) == 3
    assert tfg._kernel1_plan(8192, 256, 210, 100)[:2] == (242, 0)
    assert tfg._kernel1_plan(1920, 90, 50, 100)[1] == 0
    assert tfg._kernel1_ctas(256) == 3 and tfg._kernel1_ctas(1024) == 1


@pytest.mark.parametrize("block", [(2, 4, 8), (4, 4, 8)])
def test_fused_eval_tau2_is_the_bisected_kth_distance(block):
    """The τ² output on the CPU: for every covered node within one halving
    step above the exact k-th smallest d² (the 24 halvings of [0, m2]
    bracket it), and below it nowhere."""
    k = 10
    s = _jax_setup(fx.corner_slab(), k, block)
    cand, q = _jax_panel(s, block)
    m2 = np.float32(s["margin"] * s["margin"])
    cand, q = _torch(cand), [_torch(a) for a in q]
    Bt = q[0].shape[2]
    tau2 = torch.empty((q[0].shape[0], Bt), dtype=torch.float32)
    out = tfg._fused_eval(m2, cand, *q, block, s["sz"], k, s["V"], s["C"],
                          "idw", 2.0, tau2=tau2)
    want = tfg._fused_eval_plain(m2, cand, *q, block, s["sz"], k, s["V"],
                                 s["C"], "idw", 2.0)
    assert torch.equal(out, want)
    n_sub = block[0] // s["sz"]
    panel = cand.view(8, -1, s["C"])[:3].repeat_interleave(n_sub, dim=1)
    d2 = sum((q[a].transpose(1, 2) - panel[a][:, None, :]) ** 2
             for a in range(3))                              # (rows, Bt, C)
    kth = torch.kthvalue(d2, k, dim=-1).values
    covered = (d2 <= float(m2)).sum(dim=-1) >= k
    step = 1.01 * float(m2) * 2.0 ** -24
    assert bool(covered.any()) and not bool(covered.all())
    assert bool((tau2[covered] >= kth[covered] * (1 - 1e-6)).all())
    assert bool((tau2[covered] <= kth[covered] * (1 + 1e-6) + step).all())
    with pytest.raises(ValueError, match="tau2"):
        tfg._fused_eval(m2, cand, *q, block, s["sz"], k, s["V"], s["C"],
                        "idw", 2.0, tau2=tau2[:, :-1])


def _replayed_tau2(m2, d2, k):
    """τ² from each node's k-th smallest d² alone: the 24 halvings of
    [0, m2] on mid < d₍ₖ₎ (+∞ where fewer than k lie within m2), in f32
    ops in kernel 1's order. Returns ``(τ², d₍ₖ₎, covered)``."""
    covered = (d2 <= float(m2)).sum(dim=-1) >= k
    kth = torch.where(covered, torch.kthvalue(d2, k, dim=-1).values,
                      torch.tensor(float("inf")))
    lo = torch.zeros_like(kth)
    hi = torch.full_like(kth, float(m2))
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        short = mid < kth
        lo = torch.where(short, mid, lo)
        hi = torch.where(short, hi, mid)
    return hi, kth, covered


@pytest.mark.parametrize("cloud,k,m2,case", [
    ("corner_slab", 1, None, "uncovered"),
    ("corner_slab", 10, None, "uncovered"),
    ("corner_slab", 50, None, "uncovered"),
    ("duplicated", 10, None, "ties"),
    ("lattice", 10, None, "ties"),
    ("lattice", 50, None, "ties"),
    ("lattice", 10, 4.0, "edge"),          # d₍ₖ₎ = 2 = 8·m2/16
    ("lattice", 10, float(np.nextafter(np.float32(8), np.float32(9))),
     "spill"),
])
def test_tau2_is_the_halvings_replayed_on_the_kth_d2(cloud, k, m2, case):
    """Kernel 1 finds d₍ₖ₎ and replays the halvings on it: #{d² ≤ mid} < k
    holds exactly where mid < d₍ₖ₎, so the replay is bit-equal to the
    plain bisection on every node, covered or not (``uncovered``), where
    the k-th is tied (``ties``), where it lies on a bucket edge j·m2/16
    (``edge``), and where τ² falls in a later bucket than d₍ₖ₎
    (``spill``)."""
    block = (2, 4, 8)
    m2_panel, cand, q, sz, C = fx.kernel1_panel(getattr(fx, cloud)(), block,
                                                k)
    m2 = m2_panel if m2 is None else np.float32(m2)
    d2 = fx.kernel1_d2(cand, q, block, sz, C)
    tau2, kth, covered = _replayed_tau2(m2, d2, k)
    assert bool(covered.any())
    if case == "uncovered":
        assert not bool(covered.all())
    elif case == "ties":
        assert bool(((d2 == kth[..., None]).sum(dim=-1) > 1)[covered].any())
    elif case == "edge":
        j = torch.round(kth * 16.0 / float(m2))
        assert bool((kth == j * float(m2) / 16.0)[covered].any())
    else:
        later = fx.kernel1_bucket(tau2, m2) > fx.kernel1_bucket(kth, m2)
        assert bool(later[covered].any())
    want = tfg._fused_tau2_plain(m2, cand, *q, block, sz, k, C)
    assert torch.equal(tau2, want)
