"""The port's multi-GPU paths (``ptv_interpolation_tpu_torch/parallel/``)
against the JAX package's, the counterparts of ``tests/test_sharding.py``
but for z-sharded cleaning and the pipeline step (not ported yet).

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
from ptv_interpolation_tpu_torch.grid import create_grid
from ptv_interpolation_tpu_torch.io.npz import FieldResult

torch.set_num_threads(2)

SIZES = (2, 4)
WORLD = 4
# (cloud, backend): the JAX tests' problem and void-region clouds
GRID_CASES = (("problem", "xla"), ("void21", "xla"), ("problem", "fused"),
              ("void23", "fused"))
BLOCK = (2, 8, 8)


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
def test_sharded_grid_approx_selection_raises(kw):
    """``approx_min_k`` selection has no counterpart: as on one device,
    ``tau_mode='approx'`` and ``recall_target`` raise."""
    from ptv_interpolation_tpu_torch.parallel import make_mesh
    from ptv_interpolation_tpu_torch.parallel.sharding import (
        sharded_grid_interpolate)
    points, values = workers.problem()[:2]
    with pytest.raises(NotImplementedError):
        sharded_grid_interpolate(points, values, create_grid(
            ((0, 17),) * 3, 16), make_mesh(device="cpu"), k=12, **kw)


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
