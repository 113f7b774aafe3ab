"""The port's streaming grid path (``backend='xla'``), its repair ladder
and the exact top-k gather path (``exact_topk=True``) against the JAX
package on the same inputs: one cell list carried across for the stages,
the entry points end to end for the routes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.grid import create_grid as jax_create_grid
from ptv_interpolation_tpu.interpolate import knn_weights as jkw
from ptv_interpolation_tpu.ops import fused_grid_knn as jfg
from ptv_interpolation_tpu.ops import grid_knn as jgk
from ptv_interpolation_tpu.ops.neighbors import (
    build_cell_list as jax_build_cell_list, csr_candidate_panel)
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.interpolate import knn_weights as tkw
from ptv_interpolation_tpu_torch.ops import fused_grid_knn as tfg
from ptv_interpolation_tpu_torch.ops import grid_knn as tgk
from ptv_interpolation_tpu_torch.ops import neighbors as tnb
from ptv_interpolation_tpu_torch.utils import capture
import torch_port_fixtures as fx

torch.set_num_threads(2)

# stages: the same f32 formulas on bit-equal d² and τ², summed in another
# order
RTOL, ATOL = 1e-5, 1e-6
# whole routes: the port repairs through the fused stage where the JAX
# package's CPU ladder takes the streaming subset stage (same math, other
# order), as in test_torch_knn_weights.py
ROUTE_RTOL, ROUTE_ATOL = 1e-4, 1e-5
BLOCK, K = (2, 4, 8), 10


def _torch(a):
    return torch.from_numpy(np.array(a))


def _setup(cloud, k=K, block=BLOCK, cells=None):
    """The JAX package's streaming setup (cell edge margin / 2) and the
    same state carried into the port."""
    pts, vals, bounds, n = cloud
    grid = jax_create_grid(bounds, n)
    cells, vs, axes, margin, mc, row_len, vdev = jgk._host_setup(
        pts, vals, grid, k, cells, None, block, 1.45)
    return dict(pts=pts, vals=vals, grid=grid, tgrid=create_grid(bounds, n),
                cells=cells, vs=vs, axes=tuple(np.asarray(a) for a in axes),
                margin=margin, mc=mc, row_len=row_len,
                tcells=fx.carry_cells(cells), tvs=_torch(vs))


def _weights(mode, power=2.0):
    if mode == "idw":
        return jkw._idw_panel_weights(power), tkw._idw_panel_weights(power)
    return jkw._sibson_panel_weights(), tkw._sibson_panel_weights()


@pytest.mark.parametrize("cloud,mode,tau", [
    ("corner_slab", "sibson", "bisect"),
    ("corner_slab", "idw", "exact"),
    ("uniform", "sibson", "exact"),
    ("ragged", "idw", "bisect"),
    ("corner_slab", "sibson", "approx"),
    ("ragged", "idw", "approx"),
])
def test_grid_block_weighted_sum_matches_jax(cloud, mode, tau):
    """The streaming path over every block: ``den == 0`` at the same
    nodes, fields and weight sums within f32 tolerance. ``'approx'``
    holds the port's exact selection against JAX's ``approx_min_k`` (an
    exact sort on the CPU), and is bit for bit the port's ``'exact'``."""
    s = _setup(getattr(fx, cloud)())
    jfn, tfn = _weights(mode)
    want, want_den = jgk._grid_block_weighted_sum(
        s["cells"], s["vs"], s["axes"], jnp.float32(s["margin"]), K, BLOCK,
        s["grid"].shape, s["mc"], s["row_len"], jfn, 0.9, 8, False, tau)
    got, got_den = tgk._grid_block_weighted_sum(
        s["tcells"], s["tvs"], s["axes"], s["margin"], K, BLOCK,
        s["grid"].shape, s["mc"], s["row_len"], tfn, tau_mode=tau)
    want_den = np.asarray(want_den)
    if cloud == "corner_slab":
        assert (want_den == 0).sum() > 100, "fixture must have uncovered nodes"
    np.testing.assert_array_equal(got_den.numpy() == 0, want_den == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_den.numpy(), want_den, rtol=RTOL,
                               atol=ATOL)
    if tau != "bisect":       # exact_tau=True and 'approx': the same mode
        again = tgk._grid_block_weighted_sum(
            s["tcells"], s["tvs"], s["axes"], s["margin"], K, BLOCK,
            s["grid"].shape, s["mc"], s["row_len"], tfn, exact_tau=True)
        assert torch.equal(again[0], got) and torch.equal(again[1], got_den)


def test_host_setup_takes_prebuilt_cells_like_jax():
    """A prebuilt cell list (carried through ``cells_from_numpy``) is used
    as it is: the same margin, region dims, row capacity and sorted
    values."""
    pts, vals, bounds, n = fx.uniform()
    jcells = jax_build_cell_list(pts, cell_size=1.7, build_table=False)
    s = _setup((pts, vals, bounds, n), cells=jcells)
    cells, vs, axes, margin, mc, row_len, _ = tgk._host_setup(
        pts, vals, s["tgrid"], K, BLOCK, 1.45, device="cpu",
        cells=s["tcells"])
    assert cells is s["tcells"]
    assert (margin, mc, row_len) == (s["margin"], s["mc"], s["row_len"])
    np.testing.assert_array_equal(vs.numpy(), np.asarray(s["vs"]))
    for got, want in zip(axes, s["axes"]):
        np.testing.assert_array_equal(got, want)


def _custom_weight(d, mask, sq_topk):
    return 1.0 / (d + 0.5)


@pytest.mark.parametrize("route", ["xla", "exact", "custom_weight_fn",
                                   "cells"])
def test_streaming_routes_match_jax(route):
    """The entry points down the streaming path, repair included: the
    void-region cloud leaves the nodes above it uncovered."""
    pts, vals, bounds, n = fx.void_region()
    jgrid, grid = jax_create_grid(bounds, n), create_grid(bounds, n)
    kw = dict(k=K, block=BLOCK)
    if route == "custom_weight_fn":
        want = jgk.grid_weighted_interpolate(pts, vals, jgrid, K,
                                             _custom_weight, block=BLOCK,
                                             mode="idw")
        with capture() as rec:
            got = tgk.grid_weighted_interpolate(pts, vals, grid, K,
                                                _custom_weight, block=BLOCK,
                                                mode="idw", device="cpu")
    else:
        if route == "xla":
            kw["backend"] = "xla"
        elif route == "exact":
            kw["tau_mode"] = "exact"
        jkwargs, tkwargs = dict(kw), dict(kw)
        if route == "cells":
            jcells = jax_build_cell_list(pts, cell_size=1.6,
                                         build_table=False)
            jkwargs["cells"] = jcells
            tkwargs["cells"] = fx.carry_cells(jcells)
        want = jkw.sibson_grid_interpolate(pts, vals, jgrid, **jkwargs)
        with capture() as rec:
            got = tkw.sibson_grid_interpolate(pts, vals, grid, device="cpu",
                                              **tkwargs)
        assert "kernel1.launches" not in rec.counters()
    stages = _stages(rec)
    assert stages["uncovered"] > 100 and "fused" in stages
    assert got.device.type == "cpu" and got.shape == (n, n, n, 3)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ROUTE_RTOL, atol=ROUTE_ATOL)


def _stages(rec):
    """The repair ladder's counters of a capture, by stage: ``uncovered``
    and the nodes each stage that ran served."""
    return {name.split(".", 1)[1]: n for name, n in rec.counters().items()
            if name.startswith("repair.")}


def _widened(s, block=BLOCK):
    """The widened-margin repair's geometry: 1.6× the margin, its region
    dims and row capacity."""
    cell_size = 1.0 / float(s["cells"].inv_host)
    margin2 = 1.6 * float(s["margin"])
    dx, dy, dz = s["grid"].spacing
    mc2 = tuple(int(np.ceil((ext + 2.0 * margin2) / cell_size)) + 1
                for ext in (block[2] * dx, block[1] * dy,
                            block[0] * dz))[::-1]
    axes2 = tuple(np.asarray(jgk._pad_axis(a, b)) for a, b in
                  zip((s["grid"].x, s["grid"].y, s["grid"].z), block[::-1]))
    return margin2, mc2, jgk._row_capacity(s["cells"], mc2[2]), axes2


def test_subset_evaluators_match_jax():
    """The widened-margin repair's streaming evaluator over a few blocks
    against the JAX package's. (Kernel 1 over a set of blocks is held in
    ``test_fused_repair_matches_jax``.)"""
    s = _setup(fx.corner_slab())
    margin2, mc2, row_len2, axes2 = _widened(s)
    n_blocks = int(np.prod([-(-a // b) for a, b in
                            zip(s["grid"].shape, BLOCK)]))
    ids = np.array([n_blocks - 1, 0, 5, 17, 100, n_blocks - 7, 40, 41])
    jfn, tfn = _weights("sibson")
    want = np.asarray(jgk._grid_block_weighted_sum_subset(
        s["cells"], s["vs"], axes2, jnp.float32(margin2),
        jnp.asarray(ids, jnp.int32), K, BLOCK, s["grid"].shape, mc2,
        row_len2, jfn, 8))
    assert (want[..., 3] == 0).any() and (want[..., 3] > 0).any()
    got = tgk._grid_block_weighted_sum_subset(
        s["tcells"], s["tvs"], axes2, margin2, ids, K, BLOCK,
        s["grid"].shape, mc2, row_len2, tfn).numpy()
    np.testing.assert_array_equal(got[..., 3] == 0, want[..., 3] == 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_celllist_repair_eval_csr_matches_jax(mode):
    """The cell-list CSR stage: the candidate panel bit for bit against
    the JAX package's panel as it runs, compiled (XLA fuses its d² sum
    into a chain of FMAs, which the port rounds alike), ``good``
    identical, the values within f32 tolerance."""
    s = _setup(fx.corner_slab())
    rng = np.random.default_rng(3)
    q = rng.uniform(-1, 25, size=(300, 3)).astype(np.float32)
    q[:8] = [[x, y, z] for x in (0, 24) for y in (0, 24) for z in (0, 24)]
    cell_size = 1.0 / float(s["cells"].inv_host)
    rings = int(np.ceil(1.6 * float(s["margin"]) / cell_size))
    guard = rings * cell_size
    cand, d2 = jax.jit(csr_candidate_panel, static_argnums=2)(
        s["cells"], jnp.asarray(q), rings)
    tcand, td2 = tnb.csr_candidate_panel(s["tcells"], _torch(q), rings)
    np.testing.assert_array_equal(tcand.numpy(), np.asarray(cand))
    np.testing.assert_array_equal(td2.numpy(), np.asarray(d2))
    want, want_good = jgk._celllist_repair_eval_csr(
        s["cells"], s["vs"], q, K, rings, mode, 2.0, jnp.float32(guard),
        query_tile=128)
    got, good = tgk._celllist_repair_eval_csr(
        s["tcells"], s["tvs"], _torch(q), K, rings, mode, 2.0, guard,
        query_tile=128)
    want_good = np.asarray(want_good)
    assert want_good.any() and not want_good.all()
    np.testing.assert_array_equal(good.numpy(), want_good)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_celllist_repair_eval_table_form_matches_jax(mode, monkeypatch):
    """The cell-list stage's table form, taken when no cell-sorted values
    are given: ``_celllist_repair_eval`` against the JAX package's on
    queries inside and beyond the guard radius (``good`` identical,
    values within f32 tolerance), then ``repair_empty_nodes(values_sorted=
    None)`` on cells that carry a table — the same nodes served by the
    cell-list stage and by brute force, and the same field."""
    s = _setup(fx.corner_slab())
    cell_size = 1.0 / float(s["cells"].inv_host)
    jcells = jax_build_cell_list(s["pts"], cell_size=cell_size)
    assert jcells.table.shape[0] > 1
    tcells = fx.carry_cells(jcells)
    rings = int(np.ceil(1.6 * float(s["margin"]) / cell_size))
    guard = rings * cell_size
    rng = np.random.default_rng(3)
    q = rng.uniform(-1, 25, size=(256, 3)).astype(np.float32)
    want, want_good = jgk._celllist_repair_eval(
        jcells, s["vals"], q, K, rings, mode, 2.0, jnp.float32(guard),
        query_tile=128)
    got, good = tgk._celllist_repair_eval(
        tcells, _torch(s["vals"]), _torch(q), K, rings, mode, 2.0, guard,
        query_tile=128)
    want_good = np.asarray(want_good)
    assert want_good.any() and not want_good.all()
    np.testing.assert_array_equal(good.numpy(), want_good)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)

    jfn, _ = _weights(mode)
    field, den = jgk._grid_block_weighted_sum(
        s["cells"], s["vs"], s["axes"], jnp.float32(s["margin"]), K, BLOCK,
        s["grid"].shape, s["mc"], s["row_len"], jfn, 0.9, 8, False,
        "bisect")
    served = []
    table_eval = jgk._celllist_repair_eval

    def count_table_eval(*a, **kw):
        vals, ok = table_eval(*a, **kw)
        served.append(int(np.asarray(ok)[:len(np.flatnonzero(
            np.asarray(den) == 0))].sum()))
        return vals, ok

    monkeypatch.setattr(jgk, "_celllist_repair_eval", count_table_eval)
    want = jgk.repair_empty_nodes(
        field, den, s["pts"], s["vals"], s["grid"], K, mode, 2.0,
        cells=jcells, margin=s["margin"], block=BLOCK)
    with capture() as rec:
        got = tgk.repair_empty_nodes(
            _torch(field), _torch(den), _torch(s["pts"]), _torch(s["vals"]),
            s["tgrid"], K, mode, 2.0, cells=tcells, margin=s["margin"],
            block=BLOCK)
    n_unc = int((np.asarray(den) == 0).sum())
    assert len(served) == 1 and served[0] > 100
    assert _stages(rec) == {
        "uncovered": n_unc, "celllist": served[0],
        "bruteforce": n_unc - served[0]}
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ROUTE_RTOL, atol=ROUTE_ATOL)


def _repair_inputs(s, uncovered):
    """A covered field of zeros with ``den == 0`` at the flat node indices
    ``uncovered``."""
    shape = s["grid"].shape
    den = np.ones(shape, np.float32)
    den.reshape(-1)[uncovered] = 0.0
    return np.zeros(shape + (3,), np.float32), den


def test_ladder_celllist_stage_serves():
    """Uncovered nodes scattered one per block over most blocks: the
    widened-margin stage declines (too many blocks for the nodes), and
    the cell-list stage serves what it certifies, as in the JAX package.
    100 nodes: the cell-list and brute-force stages take counts that are
    no power of two."""
    s = _setup(fx.uniform())
    rng = np.random.default_rng(5)
    dims = [-(-a // b) for a, b in zip(s["grid"].shape, BLOCK)]
    blocks = rng.choice(int(np.prod(dims)), 100, replace=False)
    bz, by, bx = np.unravel_index(blocks, dims)
    lz, ly, lx = (rng.integers(0, b, 100) for b in BLOCK)
    nodes = np.ravel_multi_index((bz * BLOCK[0] + lz, by * BLOCK[1] + ly,
                                  bx * BLOCK[2] + lx), s["grid"].shape)
    field, den = _repair_inputs(s, nodes)
    for mode in ("sibson", "idw"):
        want = jgk.repair_empty_nodes(
            jnp.asarray(field), jnp.asarray(den), s["pts"], s["vals"],
            s["grid"], K, mode, 2.0, cells=s["cells"], margin=s["margin"],
            values_sorted=s["vs"], block=BLOCK)
        with capture() as rec:
            got = tgk.repair_empty_nodes(
                _torch(field), _torch(den), _torch(s["pts"]),
                _torch(s["vals"]), s["tgrid"], K, mode, 2.0,
                cells=s["tcells"], margin=s["margin"],
                values_sorted=s["tvs"], block=BLOCK)
        stages = _stages(rec)
        assert stages["uncovered"] == 100
        assert "fused" not in stages
        assert stages["celllist"] > 50
        assert stages["celllist"] + stages.get("bruteforce", 0) == 100
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("evaluator", ["fused", "streaming"])
def test_ladder_subset_stage_serves(evaluator, monkeypatch):
    """The widened-margin stage serves the uncovered blocks of the
    corner-slab cloud where the JAX package's survey ids do not reach
    them all (its fused repair declines, its subset stage serves) —
    through kernel 1 (``fused``) over the blocks' device ids — or where
    kernel 1's panel is too wide, through the streaming subset evaluator
    (``streaming``); brute force takes the rest, as in the JAX package's
    ladder. Tolerance as for whole routes: the far void nodes'
    brute-force sums differ by a few ulps more."""
    s = _setup(fx.corner_slab())
    jfn, tfn = _weights("sibson")
    field, den = jgk._grid_block_weighted_sum(
        s["cells"], s["vs"], s["axes"], jnp.float32(s["margin"]), K, BLOCK,
        s["grid"].shape, s["mc"], s["row_len"], jfn, 0.9, 8, False,
        "bisect")
    if evaluator == "fused":
        monkeypatch.setattr(jfg, "_NBLK_MAX", 8)
    else:
        monkeypatch.setattr(tfg, "_REPAIR_PANEL_MAX", 0)
    want = jgk.repair_empty_nodes(
        field, den, s["pts"], s["vals"], s["grid"], K, "sibson", 2.0,
        cells=s["cells"], margin=s["margin"], values_sorted=s["vs"],
        block=BLOCK)
    streamed = []
    stream = tfg._grid_block_weighted_sum_subset

    def spy(*a, **kw):
        streamed.append(1)
        return stream(*a, **kw)

    monkeypatch.setattr(tfg, "_grid_block_weighted_sum_subset", spy)
    with capture() as rec:
        got = tgk.repair_empty_nodes(
            _torch(field), _torch(den), _torch(s["pts"]), _torch(s["vals"]),
            s["tgrid"], K, "sibson", 2.0, cells=s["tcells"],
            margin=s["margin"], values_sorted=s["tvs"], block=BLOCK)
    stages = _stages(rec)
    blocks = {(z // BLOCK[0], y // BLOCK[1], x // BLOCK[2])
              for z, y, x in zip(*np.nonzero(np.asarray(den) == 0))}
    assert len(blocks) > 8                   # past the survey's ids
    assert stages["uncovered"] == int((np.asarray(den) == 0).sum())
    assert stages["fused"] > 100 and "celllist" not in stages
    assert stages["fused"] + stages.get("bruteforce", 0) == \
        stages["uncovered"]
    assert (len(streamed) == 1) == (evaluator == "streaming")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ROUTE_RTOL, atol=ROUTE_ATOL)


def test_auto_falls_back_on_fused_capacity_error(monkeypatch):
    """``backend='auto'`` takes the streaming path when the fused panel is
    too wide, and ``backend='fused'`` surfaces the error (the port's
    analogue of ``tests/test_fused_grid_knn.py``'s fallback test)."""
    pts, vals, bounds, n = fx.uniform(n_pts=2000, n=16)
    grid = create_grid(bounds, n)
    want = jkw.sibson_grid_interpolate(pts, vals, jax_create_grid(bounds, n),
                                       k=8, block=BLOCK)

    def refuse(*a, **kw):
        raise tfg.FusedCapacityError("forced")

    monkeypatch.setattr(tfg, "fused_grid_weighted_interpolate", refuse)
    got = tkw.sibson_grid_interpolate(pts, vals, grid, k=8, block=BLOCK,
                                      device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ROUTE_RTOL, atol=ROUTE_ATOL)
    with pytest.raises(tfg.FusedCapacityError):
        tkw.sibson_grid_interpolate(pts, vals, grid, k=8, block=BLOCK,
                                    backend="fused", device="cpu")


def test_coincident_points_route_through_generic_path():
    """More than 1024 coincident points: no cell size fits a candidate
    row, so both packages interpolate every node by exact kNN."""
    rng = np.random.default_rng(8)
    dup = np.tile(np.float32([[4.0, 4.0, 4.0]]), (1500, 1))
    bulk = rng.uniform(0, 8, size=(300, 3)).astype(np.float32)
    pts = np.concatenate([dup, bulk])
    vals = np.stack([pts[:, 0], pts[:, 1], np.ones(len(pts), np.float32)],
                    axis=-1)
    bounds = ((0, 9),) * 3
    for backend in ("auto", "xla"):
        want = jkw.sibson_grid_interpolate(pts, vals,
                                           jax_create_grid(bounds, 8), k=8,
                                           backend=backend)
        got = tkw.sibson_grid_interpolate(pts, vals, create_grid(bounds, 8),
                                          k=8, backend=backend, device="cpu")
        assert got.shape == (8, 8, 8, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ROUTE_RTOL, atol=ROUTE_ATOL)


@pytest.fixture(scope="module")
def gather_problem():
    """``tests/test_grid_knn.py``'s problem: 6000 points, a 32³ grid."""
    rng = np.random.default_rng(21)
    pts = rng.uniform(0, 32, size=(6000, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.3), np.cos(pts[:, 1] * 0.2),
                     np.ones(len(pts))], -1).astype(np.float32)
    return pts, vals, ((0, 33),) * 3, 32


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_exact_topk_matches_jax(gather_problem, mode):
    """``exact_topk=True``: every node's exact k nearest in its block's
    region, weighted; no repair, so domain corners agree too."""
    pts, vals, bounds, n = gather_problem
    jentry, tentry = ((jkw.sibson_grid_interpolate,
                       tkw.sibson_grid_interpolate) if mode == "sibson" else
                      (jkw.idw_grid_interpolate, tkw.idw_grid_interpolate))
    want = jentry(pts, vals, jax_create_grid(bounds, n), k=20,
                  exact_topk=True, tau_mode="bisect")
    got = tentry(pts, vals, create_grid(bounds, n), k=20, exact_topk=True,
                 tau_mode="bisect", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_grid_knn_apply_positions_match_jax(gather_problem):
    """A consumer that reads the neighbours' positions and squared
    distances (``tests/test_grid_knn.py``'s mean-offset consumer). The
    mean offset cancels positions of up to 32, whose f32 spacing is
    3.8e-6: atol 2e-5."""
    pts, vals, bounds, n = gather_problem

    def consume(xp):
        def fn(sq, n_pos, n_val, ok, q):
            okf = ok.astype(xp.float32)[..., None] if xp is jnp else \
                ok.to(torch.float32)[..., None]
            mean_pos = (n_pos * okf).sum(axis=1) / okf.sum(axis=1)
            return xp.concatenate([mean_pos - q, sq[:, -1:]], axis=1) \
                if xp is jnp else torch.cat([mean_pos - q, sq[:, -1:]], 1)
        return fn

    want = jgk.grid_knn_apply(pts, vals, jax_create_grid(bounds, n), 8,
                              consume(jnp), 4, exact_topk=True)
    got = tgk.grid_knn_apply(pts, vals, create_grid(bounds, n), 8,
                             consume(torch), 4, exact_topk=True,
                             device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=2e-5)


def test_grid_knn_apply_approx_matches_jax(gather_problem):
    """``exact_topk=False``: the JAX package's ``approx_min_k`` at
    ``recall_target``, an exact sort on the CPU, against the port's exact
    gather. On each side every node's k squared distances are bit for bit
    those of ``exact_topk=True``; across the two, they and the mean
    neighbour offset (order-free over the k-set) are at the tolerance of
    the exact route (XLA rounds the d² sum in its own order)."""
    pts, vals, bounds, n = gather_problem

    def consume(xp):
        def fn(sq, n_pos, n_val, ok, q):
            if xp is jnp:
                okf = ok.astype(jnp.float32)[..., None]
                mean_pos = (n_pos * okf).sum(axis=1) / okf.sum(axis=1)
                return jnp.concatenate([sq, mean_pos - q], axis=1)
            okf = ok.to(torch.float32)[..., None]
            mean_pos = (n_pos * okf).sum(dim=1) / okf.sum(dim=1)
            return torch.cat([sq, mean_pos - q], dim=1)
        return fn

    def run(**kw):
        want = np.asarray(jgk.grid_knn_apply(
            pts, vals, jax_create_grid(bounds, n), 8, consume(jnp), 11,
            **kw))
        got = tgk.grid_knn_apply(pts, vals, create_grid(bounds, n), 8,
                                 consume(torch), 11, device="cpu",
                                 **kw).numpy()
        return want, got

    want_exact, got_exact = run(exact_topk=True)
    for rt in (0.99, 0.5):
        want, got = run(exact_topk=False, recall_target=rt)
        np.testing.assert_array_equal(want[..., :8], want_exact[..., :8])
        np.testing.assert_array_equal(got, got_exact)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=2e-5)
