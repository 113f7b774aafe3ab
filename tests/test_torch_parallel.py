"""The port's multi-GPU paths (``ptv_interpolation_tpu_torch/parallel/``,
the z-sharded cleaning of ``physics.py``) against the JAX package's and
the port's own one-device results: the counterparts of
``tests/test_sharding.py``, with the slab stencils, the sharded V-cycle
and the pipeline step besides (the dry-run entry points are in
``tests/test_torch_entry.py``).

JAX runs on its 8 virtual CPU devices (``tests/conftest.py``) with
``make_mesh(n)``; the port runs a gloo world of processes on the CPU and
meshes of the same size n ∈ {2, 4}, so both cut the same slabs. The world
is spawned once for the module (``tests/torch_parallel_workers.py``, which
imports no JAX) and runs every case; the parts that hold a kernel use its
plain version there."""

import functools

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from ptv_interpolation_tpu.grid import create_grid as jax_create_grid
from ptv_interpolation_tpu.ops.grid_knn import _host_setup as jax_host_setup
from ptv_interpolation_tpu.parallel import make_mesh as jax_make_mesh
from ptv_interpolation_tpu.parallel import (
    sharded_interpolate_values as jax_sharded_values)
from ptv_interpolation_tpu.parallel.sharding import (
    sharded_grid_interpolate as jax_sharded_grid)
from ptv_interpolation_tpu.parallel.slab_store import (
    build_slab_store as jax_build_slab_store)
from ptv_interpolation_tpu.physics import (
    clean_divergence_projection as jax_projection)
from ptv_interpolation_tpu.physics import (
    clean_divergence_variational as jax_variational)
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.io.npz import FieldResult

torch.set_num_threads(2)

SIZES = (2, 4)
WORLD = 4
# (cloud, backend): the JAX tests' problem and void-region clouds
GRID_CASES = (("problem", "xla"), ("void21", "xla"), ("problem", "fused"),
              ("void23", "fused"))
BLOCK = (2, 8, 8)
# the mirror of tests/test_sharding.py's cleaning test, and an odd z extent
CLEAN_SHAPES = ((16, 16, 16), (19, 16, 16))
CLEAN_METHODS = ("projection", "variational")


def _checkpoint_result():
    """``tests/test_sharding.py::test_checkpoint_sharded_restore``'s field,
    with an odd z extent so the last slab is padded."""
    rng = np.random.default_rng(3)
    shape = (9, 4, 4)
    return FieldResult(
        x=np.arange(4.0), y=np.arange(4.0), z=np.arange(9.0),
        u=rng.normal(size=shape).astype(np.float32),
        v=rng.normal(size=shape).astype(np.float32),
        w=rng.normal(size=shape).astype(np.float32),
        mask=rng.random(shape) > 0.3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case of the module, run once in one 4-rank gloo world:
    ``{(case name, rank): result}``."""
    from ptv_interpolation_tpu_torch.io.checkpoint import save_checkpoint
    d = tmp_path_factory.mktemp("world")
    ckpt = str(d / "field.pt")
    save_checkpoint(ckpt, _checkpoint_result())
    cases = []
    for n in SIZES:
        for method in ("idw", "sibson"):
            cases.append(dict(name=f"values-{method}-{n}", kind="values",
                              method=method, n=n))
        for cloud, backend in GRID_CASES:
            cases.append(dict(name=f"grid-{cloud}-{backend}-{n}",
                              kind="grid", cloud=cloud, backend=backend, n=n))
        cases.append(dict(name=f"ckpt-{n}", kind="checkpoint", path=ckpt,
                          n=n))
        for shape in CLEAN_SHAPES:
            for method in CLEAN_METHODS:
                cases.append(dict(name=f"clean-{method}-{shape[0]}-{n}",
                                  kind="clean", shape=shape, method=method,
                                  n=n))
        for kind in ("stencils", "vcycle", "step"):
            cases.append(dict(name=f"{kind}-{n}", kind=kind, n=n))
    return workers.run_world(WORLD, str(d), cases)


def _same_on_every_rank(world, name, n, key="got"):
    got = world[(name, 0)][key]
    for rank in range(1, n):
        np.testing.assert_array_equal(world[(name, rank)][key], got)
    for rank in range(n, WORLD):
        assert (name, rank) not in world
    return got


@functools.lru_cache(maxsize=None)
def _jax_values(method, n):
    points, values, queries = workers.problem()
    return np.asarray(jax_sharded_values(points, values, queries,
                                         jax_make_mesh(n), method=method,
                                         k=12, query_tile=32))


@functools.lru_cache(maxsize=None)
def _jax_grid(cloud, backend, n):
    points, values = _cloud(cloud)
    grid = jax_create_grid(((0, 17), (0, 17), (0, 17)), 16)
    return np.asarray(jax_sharded_grid(
        points, values, grid, jax_make_mesh(n), method="sibson", k=12,
        block=BLOCK, backend=backend, interpret=backend == "fused"))


def _cloud(cloud):
    if cloud == "problem":
        return workers.problem()[:2]
    return workers.void_cloud({"void21": 21, "void23": 23}[cloud])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("method", ["idw", "sibson"])
def test_sharded_values_match_jax_and_single_device(world, method, n):
    """Query-sharded IDW and sibson: within the JAX tests' bar of JAX's
    sharded result, and bit for bit the port's single-device result —
    with JAX's query tile of 32 against ``*_interpolate(query_tile=32)``
    and with the default tiles against ``interpolate_values``, by brute
    force and with a cell list — on every rank alike."""
    name = f"values-{method}-{n}"
    got = _same_on_every_rank(world, name, n)
    res = world[(name, 0)]
    np.testing.assert_array_equal(got, res["single"])
    np.testing.assert_array_equal(res["got_default"], res["single_default"])
    np.testing.assert_array_equal(res["got_cells"], res["single_cells"])
    np.testing.assert_allclose(got, _jax_values(method, n), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("cloud,backend", GRID_CASES)
def test_sharded_grid_matches_jax(world, cloud, backend, n):
    """``sharded_grid_interpolate``, fused and 'xla', on the JAX tests'
    problem and void-region clouds against JAX's ``backend='fused',
    interpret=True`` and ``'xla'`` at the same mesh size, and against the
    port's single-device grid path: ≥ 99.9% of values within rtol 1e-3 /
    atol 1e-4 (the JAX tests' bar), every value finite, and the void
    nodes' constant channel > 0.5; the same on every rank."""
    from ptv_interpolation_tpu_torch.interpolate import (
        sibson_grid_interpolate)
    name = f"grid-{cloud}-{backend}-{n}"
    got = _same_on_every_rank(world, name, n)
    assert got.shape == (16, 16, 16, 3)
    assert np.isfinite(got).all()
    assert got[..., 2].min() > 0.5
    points, values = _cloud(cloud)
    single = sibson_grid_interpolate(
        points, values, create_grid(((0, 17), (0, 17), (0, 17)), 16), k=12,
        block=BLOCK, backend=backend, device="cpu").numpy()
    for what, want in (("JAX", _jax_grid(cloud, backend, n)),
                       ("single device", single)):
        close = np.isclose(got, want, rtol=1e-3, atol=1e-4)
        print(f"{name} vs {what}: {close.mean():.6f} close, largest |Δ| "
              f"{np.abs(got - want).max():.3e}")
        assert close.mean() > 0.999, (what, close.mean())
    stats = world[(name, 0)]["stats"]
    assert len(stats["n_loc"]) == n
    assert stats["store_bytes"] < stats["whole_bytes"] + 1024 * 6 * 4
    if backend == "fused":
        assert len(stats["uncovered"]) == n
        assert stats["n_left"] == sum(stats["uncovered"]) - sum(
            stats["repaired"])
    else:
        assert "uncovered" not in stats


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_slab_store_matches_jax_and_shards_memory(n_dev):
    """``build_slab_store`` on ``tests/test_sharding.py``'s tall domain:
    every rank's ``row0``, ``n_loc`` and the capacity ``capW`` equal the
    JAX package's exactly, the window rows equal its gathered windows bit
    for bit, and the memory bound of the JAX test holds — each window ≤
    (total/n + halo)·1.35 rows, ≪ the whole cloud, the windows jointly
    cover it, and the per-rank bytes are under half the whole store's."""
    from ptv_interpolation_tpu_torch.ops.grid_knn import _host_setup
    from ptv_interpolation_tpu_torch.parallel.slab_store import (
        build_slab_store)
    rng = np.random.default_rng(7)
    n = 20_000
    points = rng.uniform([0, 0, 0], [16, 16, 128], size=(n, 3)).astype(
        np.float32)
    values = np.stack([np.sin(points[:, 0]), np.cos(points[:, 1]),
                       np.ones(n)], axis=-1).astype(np.float32)
    bounds = ((0, 17), (0, 17), (0, 129))
    block = (8, 8, 8)
    jgrid = jax_create_grid(bounds, (16, 16, 128))
    jcells, jvs, _, jmargin = jax_host_setup(points, values, jgrid, 12, None,
                                             None, block, 1.45)[:4]
    grid = create_grid(bounds, (16, 16, 128))
    cells, vs, _, margin = _host_setup(points, values, grid, 12, block, 1.45,
                                       device="cpu")[:4]
    assert margin == jmargin
    z_slabs = np.asarray(grid.z, np.float32).reshape(n_dev, -1)
    want = jax_build_slab_store(jcells, jvs, z_slabs, block[0],
                                jgrid.spacing[2], jmargin)
    stores = [build_slab_store(cells, vs, z_slabs, block[0],
                               grid.spacing[2], margin, rank=r)
              for r in range(n_dev)]
    for r, store in enumerate(stores):
        assert store.row0 == int(np.asarray(want.row0)[r, 0])
        assert store.n_loc == int(np.asarray(want.n_loc)[r, 0])
        assert store.capW == want.capW
        np.testing.assert_array_equal(store.n_loc_np, want.n_loc_np)
        np.testing.assert_array_equal(store.points_l.numpy(),
                                      np.asarray(want.points_l)[r])
        np.testing.assert_array_equal(store.values_l.numpy(),
                                      np.asarray(want.values_l)[r])
        assert store.halo == want.halo
    store = stores[0]
    halo_frac = 2 * store.halo / 128.0
    bound = n * (1 / n_dev + halo_frac) * 1.35   # ±35% density fluctuation
    assert store.n_loc_np.max() < bound, (store.n_loc_np, bound)
    assert store.n_loc_np.max() < 0.6 * n
    assert store.n_loc_np.sum() >= n
    repl_bytes = (cells.points_sorted.shape[0] * 3
                  + vs.shape[0] * vs.shape[1]) * 4
    if n_dev > 2:   # at n = 2 half the cloud plus its halo exceed half
        assert store.per_device_bytes() < 0.5 * repl_bytes
    assert all(s.per_device_bytes() == store.per_device_bytes()
               for s in stores)


def test_initialize_distributed_noop_single_process(monkeypatch):
    """With no arguments and no ``torchrun`` environment
    ``initialize_distributed`` does nothing and never calls
    ``init_process_group``; with explicit arguments it forwards them
    (gloo for the CPU); once the group is up a second call does
    nothing."""
    import torch.distributed as dist

    from ptv_interpolation_tpu_torch.parallel import mesh as mesh_mod
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(calls))
    assert mesh_mod.initialize_distributed() is False
    assert calls == []
    assert mesh_mod.initialize_distributed(
        coordinator_address="10.0.0.1:1234", num_processes=2, process_id=0,
        device="cpu") is True
    assert calls == [("gloo", {"init_method": "tcp://10.0.0.1:1234",
                               "world_size": 2, "rank": 0})]
    assert mesh_mod.initialize_distributed(
        coordinator_address="10.0.0.1:1234") is False
    assert len(calls) == 1


def test_single_process_mesh_and_shard_fields():
    """Without a process group ``make_mesh`` gives a one-rank mesh (and
    refuses more ranks); ``shard_fields`` cuts equal z-slabs, the last
    padded with zero planes, as the one-rank slab is the whole field."""
    from ptv_interpolation_tpu_torch.parallel import (make_mesh,
                                                      replicated,
                                                      row_sharded,
                                                      shard_fields)
    from ptv_interpolation_tpu_torch.parallel.mesh import Mesh
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")
    u = np.arange(5 * 2 * 3, dtype=np.float32).reshape(5, 2, 3)
    np.testing.assert_array_equal(shard_fields(mesh, u).numpy(), u)
    assert torch.equal(replicated(mesh).shard(u), torch.as_tensor(u))
    for rank in range(2):
        two = Mesh(None, rank, 2, torch.device("cpu"))
        part, mask = shard_fields(two, u, u > 10)
        want = np.concatenate([u, np.zeros_like(u[:1])])[3 * rank:3 * rank + 3]
        np.testing.assert_array_equal(part.numpy(), want)
        assert mask.dtype == torch.bool
        np.testing.assert_array_equal(mask.numpy(), want > 10)
        assert torch.equal(row_sharded(two).shard(u), part)


@pytest.mark.parametrize("kw", [dict(tau_mode="approx"),
                                dict(recall_target=0.9)])
def test_sharded_grid_approx_selection_matches_jax(kw):
    """``tau_mode='approx'`` and ``recall_target`` on a one-rank mesh,
    served by exact selection as on one device: against JAX's sharded
    path at the same arguments (``approx_min_k``, an exact sort on the
    CPU) at the route tolerance of the one-device tests, and bit for bit
    the port's ``tau_mode='exact'`` (resp. its default)."""
    from ptv_interpolation_tpu_torch.parallel import make_mesh
    from ptv_interpolation_tpu_torch.parallel.sharding import (
        sharded_grid_interpolate)
    points, values = workers.problem()[:2]
    bounds = ((0, 17),) * 3
    mesh = make_mesh(device="cpu")
    got = sharded_grid_interpolate(points, values, create_grid(bounds, 16),
                                   mesh, k=12, block=BLOCK, **kw)
    same = {k: v for k, v in kw.items() if k != "recall_target"}
    if same:
        same["tau_mode"] = "exact"
    base = sharded_grid_interpolate(points, values, create_grid(bounds, 16),
                                    mesh, k=12, block=BLOCK, **same)
    assert torch.equal(got, base)
    want = np.asarray(jax_sharded_grid(
        points, values, jax_create_grid(bounds, 16), jax_make_mesh(1),
        method="sibson", k=12, block=BLOCK, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_checkpoint_restore_onto_mesh(world, n):
    """``load_checkpoint(mesh=...)``: each rank holds its z-slab of u, v,
    w and the mask (equal slabs, the last padded with zeros), bit for bit,
    and the 1D axes whole."""
    res = _checkpoint_result()
    rows = -(-res.u.shape[0] // n)
    for rank in range(n):
        back = world[(f"ckpt-{n}", rank)]
        for name in ("x", "y", "z"):
            np.testing.assert_array_equal(back[name], getattr(res, name))
        for name in ("u", "v", "w", "mask"):
            full = getattr(res, name)
            padded = np.concatenate(
                [full, np.zeros((rows * n - full.shape[0],) + full.shape[1:],
                                full.dtype)])
            np.testing.assert_array_equal(
                back[name], padded[rank * rows:(rank + 1) * rows])
            assert back[name].dtype == full.dtype


# ---------------------------------------------------------------------------
# Z-sharded cleaning and the pipeline step
# ---------------------------------------------------------------------------

def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@functools.lru_cache(maxsize=None)
def _single_clean(shape, method):
    """The port's one-device result of a cleaning case (CPU)."""
    return workers.clean(*workers.clean_problem(shape), method)


@functools.lru_cache(maxsize=None)
def _jax_clean(shape, method):
    mask, u, v, w = workers.clean_problem(shape)
    if method == "projection":
        res = jax_projection(u, v, w, mask, 1., 1., 1., iterations=2)
    else:
        res = jax_variational(u, v, w, mask, 1., 1., 1., lambda_reg=50.0)
    return np.stack([np.asarray(t) for t in res[:3]])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("shape", CLEAN_SHAPES, ids=lambda s: f"nz{s[0]}")
@pytest.mark.parametrize("method", CLEAN_METHODS)
def test_sharded_cleaning_matches_jax_and_single_device(world, method, shape,
                                                        n):
    """``tests/test_sharding.py``'s z-sharded cleaning test (projection
    with 2 iterations, variational at λ = 50, on a 16³ mask with a solid
    column) and the same on an odd z extent, at n = 2 and 4 ranks:
    within JAX's bar (rtol 1e-3 / atol 1e-5) of the JAX package's
    one-device result; within relative L2 1e-5 per component of the
    port's one-device result, with MG-PCG counts within ±2 and both
    converged; the same bits and counts on every rank."""
    name = f"clean-{method}-{shape[0]}-{n}"
    got = _same_on_every_rank(world, name, n, key="uvw")
    for key in ("div", "iterations", "converged"):
        for rank in range(1, n):
            assert world[(name, rank)][key] == world[(name, 0)][key]
    res = world[(name, 0)]
    assert got.shape == (3,) + shape
    np.testing.assert_allclose(got, _jax_clean(shape, method), rtol=1e-3,
                               atol=1e-5)
    single = _single_clean(shape, method)
    for g, s1 in zip(got, single[:3]):
        assert _rel_l2(g, s1.numpy()) <= 1e-5
    assert abs(res["iterations"] - single.cg_iterations) <= 2, (
        res["iterations"], single.cg_iterations)
    assert res["converged"] and single.converged
    np.testing.assert_allclose(res["div"], (float(single.mean_abs_div_initial),
                                            float(single.mean_abs_div_final)),
                               rtol=1e-5)
    mask = workers.clean_problem(shape)[0]
    assert not got[:, ~mask].any()


def _single_stencil(name):
    """The one-device operator ``name`` on ``workers.stencil_problem``,
    as the one-device solvers apply it, as a tuple of arrays."""
    from ptv_interpolation_tpu_torch import physics as tp
    from ptv_interpolation_tpu_torch.ops import stencils as st
    mask, fields, phi, h = workers.stencil_problem()
    mask = torch.as_tensor(mask)
    u, v, w = (torch.as_tensor(f) for f in fields)
    q = torch.as_tensor(phi)
    lam = workers.STENCIL_LAMBDA
    S, _, div_op, div_op_T = tp._woodbury_operators(mask, *h, lam)
    lap = st.laplacian_coeffs(mask, *h)
    maskf = mask.float()
    out = {
        "divergence": lambda: (st.consistent_divergence(u, v, w, mask, *h),),
        "divergence_operator": lambda: (st.consistent_divergence(
            u, v, w, mask, *h, variant="operator"),),
        "neg_lap": lambda: (-st.laplacian_apply_coeffs(q, lap),),
        "jacobi": lambda: (tp._jacobi(lap),),
        "correction": lambda: st.consistent_correction(u, v, w, q, mask, *h),
        "div_op": lambda: (div_op((u, v, w)),),
        "div_op_T": lambda: div_op_T(q),
        "woodbury_S": lambda: (S(q),),
        "direct_A": lambda: tuple(
            x * maskf + lam * y * maskf
            for x, y in zip((u, v, w), div_op_T(div_op((u, v, w))))),
        "dtd_diag": lambda: st.divergence_dtd_diag(mask, *h),
    }[name]()
    return [t.numpy() for t in out]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(workers.STENCIL_UNITS))
def test_slab_stencils_match_single_device(world, name, n):
    """Each operator that reads z ± 1, on this rank's halo-extended slab
    (exchanged between the ranks) and cropped, equals the one-device
    output's planes bit for bit, on a 19×10×12 mask whose fluid touches
    all six faces: the domain-edge terms land on the outer ranks' outer
    planes only, and the composed operators (Woodbury's ``S``, the direct
    ``A``) take a halo of 2 planes. The slabs cover the grid in order."""
    want = _single_stencil(name)
    z = 0
    for rank in range(n):
        (z0, z1), got = world[(f"stencils-{n}", rank)][name]
        assert z0 == z and z1 > z0
        z = z1
        assert len(got) == len(want)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_[z0:z1])
    assert z == workers.stencil_problem()[0].shape[0]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", list(workers.VCYCLE_CASES))
def test_sharded_v_cycle_matches_single_device(world, case, n):
    """The sharded V-cycle (the one-device hierarchy; the fine levels on
    z-slabs with halo exchanges, the coarser ones whole on every rank
    after one all-gather) against the one-device V-cycle on the same
    residual: each rank's slab within 1e-6 relative of the one-device
    result's planes — on two Poisson masks (all levels sharded, and the
    last one whole at n = 4) and the 8 parity sublattices with screening."""
    from ptv_interpolation_tpu_torch.ops.multigrid import (
        make_mg_preconditioner)
    mask, r, kw = workers.vcycle_problem(case)
    want = make_mg_preconditioner(mask, **kw)(r).numpy()
    n_sharded = {world[(f"vcycle-{n}", rank)][case][1] for rank in range(n)}
    assert len(n_sharded) == 1 and n_sharded.pop() >= 1
    parts = []
    for rank in range(n):
        (z0, z1), _, got = world[(f"vcycle-{n}", rank)][case]
        parts.append(got)
        np.testing.assert_array_equal(got.shape, want[..., z0:z1, :, :].shape)
    got = np.concatenate(parts, axis=-3)
    assert _rel_l2(got, want) <= 1e-6


@functools.lru_cache(maxsize=None)
def _single_step():
    from ptv_interpolation_tpu_torch.entry import _tiny_problem
    from ptv_interpolation_tpu_torch.parallel import make_pipeline_step
    grid, points, values, mask = _tiny_problem()
    out = make_pipeline_step(grid, k=8, iterations=1, query_tile=64,
                             device="cpu")(points, values, mask)
    return np.stack([t.numpy() for t in out[:3]]), float(out[3])


@pytest.mark.parametrize("n", SIZES)
def test_sharded_pipeline_step_matches_single_device(world, n):
    """``make_pipeline_step`` over n ranks (IDW with the queries sharded,
    mask zeroing, z-sharded projection cleaning) against the one-device
    step with the same query tile: rtol 1e-3 / atol 1e-5, the same bits
    on every rank."""
    got = _same_on_every_rank(world, f"step-{n}", n, key="uvw")
    want, want_div = _single_step()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(world[(f"step-{n}", 0)]["div"], want_div,
                               rtol=1e-3)


@pytest.mark.parametrize("nz,size,align", [(243, 2, 32), (243, 4, 16),
                                           (19, 4, 2), (16, 4, 2),
                                           (9, 1, 1)])
def test_z_slab_plan(nz, size, align):
    """The slab plan covers the true ``nz`` in rank order, every boundary
    a multiple of ``align``, the slabs whole units within one of each
    other but the last, the short one; ``mg_slab_plan`` aligns to the
    most sharded levels that leave every rank 2 planes on its last
    sharded level."""
    from ptv_interpolation_tpu_torch.parallel.halo import (mg_slab_plan,
                                                           z_slab_plan)
    from ptv_interpolation_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(None, 0, size, torch.device("cpu"))
    bounds = z_slab_plan(nz, mesh, align)
    assert len(bounds) == size and bounds[0][0] == 0 and bounds[-1][1] == nz
    sizes = [z1 - z0 for z0, z1 in bounds]
    for (_, z1), (z0, _) in zip(bounds, bounds[1:]):
        assert z1 == z0 and z0 % align == 0
    # one unit more or less, the last unit cut short at nz
    assert max(sizes) - min(sizes) < 2 * align and sizes[-1] == min(sizes)
    bounds, n_sharded = mg_slab_plan(nz, mesh, 5)
    step = 1 << (n_sharded - 1)
    assert all(z0 % step == 0 for z0, _ in bounds)
    assert min(-(-z1 // step) - z0 // step for z0, z1 in bounds) >= 2
    if n_sharded < 5:
        assert -(-nz // (2 * step)) // size < 2
    with pytest.raises(ValueError):
        mg_slab_plan(3, Mesh(None, 0, 2, torch.device("cpu")), 1)
