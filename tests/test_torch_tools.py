"""The port's post-hoc tools, alignment and checkpoints
(``cli/tools.py``, ``cli/auto_align.py``, ``cli/pre_viewer.py``,
``align.py``, ``io/checkpoint.py``) against the JAX package's, the
counterparts of ``tests/test_pipeline_e2e.py``'s tool tests,
``tests/test_viz.py::test_pre_viewer`` and
``tests/test_grid_io.py::test_orbax_checkpoint_roundtrip``. Both packages
read the same files: a sphere pack, and the NPZ the port's pipeline
writes from it (IDW with projection cleaning, so it holds both fields)."""

import contextlib
import io
import os

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ptv_interpolation_tpu.cli import tools as jtools  # noqa: E402
from ptv_interpolation_tpu_torch.cli import tools as ttools  # noqa: E402

torch.set_num_threads(2)

# f32 reductions in another order (torch on the device against numpy)
RTOL = 1e-5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """``tests/test_pipeline_e2e.py``'s sphere pack (4 000 points, 48³,
    voxel units) and the NPZ of the port's pipeline on it."""
    from ptv_interpolation_tpu_torch.datasets import sphere_pack
    from ptv_interpolation_tpu_torch.pipeline import (PipelineConfig,
                                                      run_pipeline)
    d = tmp_path_factory.mktemp("sphere_pack")
    csv, tif, npz = (str(d / n) for n in ("pts.csv", "mask.tif", "out.npz"))
    sphere_pack.generate(n_points=4000, size=48, filename=csv, maskname=tif,
                         voxel_units=True)
    run_pipeline(PipelineConfig(
        input=csv, mask=tif, invert_mask=True, method="idw",
        idw_neighbors=20, divergence_free=True, iterations=2,
        output_npz=npz, filter_outliers=True, boundary_particles=True,
        boundary_sampling=10, verbose=False), device="cpu")
    return d, csv, tif, npz


def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn(*a)
    return res, out.getvalue()


def test_view_divergence_matches_jax(dataset):
    """``view_divergence --no-plot``: cleaning lowers the mean |div| and
    both numbers are JAX's at rtol 1e-5."""
    npz = dataset[3]
    (m_init, m_clean), _ = _quiet(ttools.view_divergence,
                                  [npz, "--no-plot", "--device", "cpu"])
    (j_init, j_clean), _ = _quiet(jtools.view_divergence, [npz, "--no-plot"])
    assert m_clean < m_init
    np.testing.assert_allclose([m_init, m_clean], [j_init, j_clean],
                               rtol=RTOL)


def test_plot_flux_matches_jax(dataset, tmp_path):
    """``plot_flux --no-show``: writes the PNG, and each plane's flux mean
    and spread are JAX's — at rtol 1e-5 of the plane's largest |flux|,
    since a mean near zero has no relative scale of its own."""
    from ptv_interpolation_tpu_torch.io import load_velocity_field
    npz = dataset[3]
    png = str(tmp_path / "flux.png")
    stats, _ = _quiet(ttools.plot_flux,
                      [npz, "--no-show", "-o", png, "--device", "cpu"])
    jstats, _ = _quiet(jtools.plot_flux,
                       [npz, "--no-show", "-o", str(tmp_path / "j.png")])
    assert os.path.exists(png)
    assert set(stats) == set(jstats) == {"XY (Z-flux)", "XZ (Y-flux)",
                                         "YZ (X-flux)"}
    f = load_velocity_field(npz)
    dx, dy, dz = f.spacing
    for plane, func, field, h in (
            ("XY (Z-flux)", "calculate_flux_xy", f.w, (dx, dy)),
            ("XZ (Y-flux)", "calculate_flux_xz", f.v, (dx, dz)),
            ("YZ (X-flux)", "calculate_flux_yz", f.u, (dy, dz))):
        flux = getattr(ttools, func)(field, *h, device="cpu")
        want = getattr(jtools, func)(field, *h)
        assert flux.dtype == want.dtype == np.float32
        scale = np.abs(want).max()
        np.testing.assert_allclose(flux, want, rtol=RTOL, atol=RTOL * scale)
        np.testing.assert_allclose(stats[plane], jstats[plane], rtol=RTOL,
                                   atol=RTOL * scale)


def test_compare_results_matches_jax(dataset, tmp_path):
    """PTV-vs-simulation comparator against a 2×-scaled, padded
    "simulation": the mean-speed normalization divides out the factor
    (L2 < 1e-5), and the L2 is JAX's; also with ``--upscale-ptv`` and
    ``--downscale-ref``."""
    from ptv_interpolation_tpu_torch.io import load_velocity_field
    from ptv_interpolation_tpu_torch.io.tiff import write_tiff
    npz = dataset[3]
    f = load_velocity_field(npz)
    for name, arr in (("u", f.u), ("v", f.v), ("w", f.w)):
        big = np.pad(np.asarray(arr, np.float32) * 2.0,
                     ((0, 2), (0, 2), (0, 2)))
        write_tiff(str(tmp_path / f"ref_{name}.tif"), big)
    flags = ["--ptv", npz,
             "--ref-u", str(tmp_path / "ref_u.tif"),
             "--ref-v", str(tmp_path / "ref_v.tif"),
             "--ref-w", str(tmp_path / "ref_w.tif"), "--no-plot"]
    l2, _ = _quiet(ttools.compare_results, flags + ["--device", "cpu"])
    jl2, _ = _quiet(jtools.compare_results, flags)
    assert l2 < 1e-5
    np.testing.assert_allclose(l2, jl2, rtol=RTOL, atol=1e-12)
    for extra in (["--upscale-ptv"], ["--downscale-ref"]):
        l2, _ = _quiet(ttools.compare_results,
                       flags + extra + ["--device", "cpu"])
        jl2, _ = _quiet(jtools.compare_results, flags + extra)
        np.testing.assert_allclose(l2, jl2, rtol=RTOL)


def test_open_results_shows_what_jax_shows(dataset, monkeypatch):
    """``open_results`` hands the viewer the JAX command's fields: the
    cleaned and initial pairs of a dual NPZ, the axes and the mask."""
    import ptv_interpolation_tpu.viz as jviz
    import ptv_interpolation_tpu_torch.viz as tviz
    seen = {}
    monkeypatch.setattr(tviz, "show", lambda *a, **kw: seen.update(t=(a, kw)))
    monkeypatch.setattr(jviz, "show", lambda *a, **kw: seen.update(j=(a, kw)))
    npz = dataset[3]
    _quiet(ttools.open_results, [npz])
    _quiet(jtools.open_results, [npz])
    (ta, tkw), (ja, jkw) = seen["t"], seen["j"]
    assert len(ta) == len(ja) == 6
    for t, j in zip(ta[:3], ja[:3]):
        assert len(t) == len(j) == 2          # (cleaned, initial)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ta[3:], ja[3:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tkw["mask"], jkw["mask"])


def test_open_results_takes_no_device(dataset, monkeypatch):
    """``open_results`` does no device work: like the JAX command it has no
    ``--device`` and starts on a machine without a card."""
    import ptv_interpolation_tpu_torch.viz as tviz
    seen = []
    monkeypatch.setattr(tviz, "show", lambda *a, **kw: seen.append(a))
    _quiet(ttools.open_results, [dataset[3]])
    assert len(seen) == 1
    with pytest.raises(SystemExit):
        _quiet(ttools.open_results, [dataset[3], "--device", "cpu"])


@pytest.mark.parametrize("tool", ["view_divergence", "plot_flux",
                                  "compare_results"])
def test_tools_default_to_cuda(dataset, tool):
    """Each tool's ``--device`` defaults to cuda and never falls back to
    the CPU: without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    npz = dataset[3]
    argv = ({"compare_results": ["--ptv", npz, "--ref-u", npz, "--ref-v",
                                 npz, "--ref-w", npz]}.get(tool, [npz]))
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(ttools, tool)(argv)


def test_entry_stubs_are_the_tools():
    """The four five-line entry modules run the tools' functions."""
    from ptv_interpolation_tpu_torch.cli import (compare_results,
                                                 open_results, plot_flux,
                                                 view_divergence)
    for mod in (compare_results, open_results, plot_flux, view_divergence):
        assert mod.main is getattr(ttools, mod.__name__.rsplit(".", 1)[1])


def _shifted_cloud(dataset):
    from ptv_interpolation_tpu_torch.io import PointCloud, load_ptv_data
    cloud = load_ptv_data(dataset[1])          # voxel units (fixture)
    shift = np.asarray([3.0, -2.0, 4.0], np.float32)
    return PointCloud(cloud.points + shift, cloud.values), shift


def test_find_best_offset_matches_jax(dataset):
    """``find_best_offset`` recovers a planted (3, −2, 4) shift within 2
    voxels, and gives JAX's ``res.x`` and ``res.fun`` on the same
    inputs."""
    from ptv_interpolation_tpu.align import find_best_offset as jfind
    from ptv_interpolation_tpu_torch.align import find_best_offset
    from ptv_interpolation_tpu_torch.io import load_mask
    shifted, shift = _shifted_cloud(dataset)
    fluid = ~np.asarray(load_mask(dataset[2]))
    best, score = find_best_offset(shifted, fluid, initial_offset=(0, 0, 0),
                                   verbose=False)
    jbest, jscore = jfind(shifted, fluid, initial_offset=(0, 0, 0),
                          verbose=False)
    np.testing.assert_allclose(best, -shift, atol=2.0)
    np.testing.assert_array_equal(best, jbest)
    assert score == jscore


def test_auto_align_cli_matches_jax(dataset, tmp_path):
    """``auto_align`` on a shifted CSV, sampled to 2 000 tracks: the same
    report as the JAX command's, and the shift recovered within 2
    voxels."""
    from ptv_interpolation_tpu.cli import auto_align as jauto
    from ptv_interpolation_tpu_torch.cli import auto_align
    from ptv_interpolation_tpu_torch.io import save_ptv_data
    shifted, shift = _shifted_cloud(dataset)
    csv = str(tmp_path / "shifted.csv")
    save_ptv_data(csv, shifted)
    argv = ["-i", csv, "-m", dataset[2], "--sample", "2000"]
    (best, _), out = _quiet(auto_align.main, argv)
    _, jout = _quiet(jauto.main, argv)
    assert out == jout
    np.testing.assert_allclose(best, -shift, atol=2.0)


def test_pre_viewer_matches_jax():
    """``PreViewer`` on ``tests/test_viz.py``'s field: the slice and the
    points in it are JAX's in every plane, and the sliders move the
    offset."""
    from ptv_interpolation_tpu.cli.pre_viewer import PreViewer as JPreViewer
    from ptv_interpolation_tpu.io.csvio import PointCloud as JPointCloud
    from ptv_interpolation_tpu_torch.cli.pre_viewer import PreViewer
    from ptv_interpolation_tpu_torch.io.csvio import PointCloud
    rng = np.random.default_rng(0)
    mask = rng.random((8, 10, 12)) > 0.3
    cols = (np.array([1.0, 5.0, 3.0]), np.array([2.0, 6.0, 4.5]),
            np.array([4.0, 4.0, 4.4]), *(np.zeros(3),) * 3)
    pv = PreViewer(PointCloud.from_arrays(*cols), mask, offset=(1.0, 0.0, 0.0))
    jpv = JPreViewer(JPointCloud.from_arrays(*cols), mask,
                     offset=(1.0, 0.0, 0.0))
    m, h, v = pv.slice_selection()
    assert m.shape == (10, 12)
    for plane in PreViewer.PLANES:
        pv.radio.set_active(PreViewer.PLANES.index(plane))
        jpv.radio.set_active(PreViewer.PLANES.index(plane))
        assert pv.plane == jpv.plane == plane
        for a, b in zip(pv.slice_selection(), jpv.slice_selection()):
            np.testing.assert_array_equal(a, b)
    pv.sliders["x"].set_val(2.0)
    assert pv.offset[0] == 2.0
    matplotlib.pyplot.close("all")


def test_checkpoint_roundtrip(tmp_path):
    """``save_checkpoint`` / ``load_checkpoint``: the same keys as the JAX
    package's tree, the fields back bit for bit on the device as tensors,
    the axes as numpy arrays; with and without the initial fields."""
    from ptv_interpolation_tpu_torch.io.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
    from ptv_interpolation_tpu_torch.io.npz import FieldResult
    rng = np.random.default_rng(11)
    shape = (4, 5, 6)
    fields = {n: rng.normal(size=shape).astype(np.float32)
              for n in ("u", "v", "w", "u_init", "v_init", "w_init")}
    for dual in (False, True):
        res = FieldResult(x=np.arange(6.0), y=np.arange(5.0),
                          z=np.arange(4.0), mask=rng.random(shape) > 0.3,
                          **{n: a for n, a in fields.items()
                             if dual or not n.endswith("_init")})
        p = str(tmp_path / f"ckpt{int(dual)}.pt")
        save_checkpoint(p, res)
        keys = set(torch.load(p, weights_only=True))
        assert keys == ({"x", "y", "z", "u", "v", "w", "mask"}
                        | ({"u_init", "v_init", "w_init"} if dual else set()))
        back = load_checkpoint(p, device="cpu")
        assert back.has_dual is dual
        for name in keys:
            got = getattr(back, name)
            if name in ("x", "y", "z"):
                assert isinstance(got, np.ndarray)
            else:
                assert torch.is_tensor(got) and got.device.type == "cpu"
                got = got.numpy()
            np.testing.assert_array_equal(got, getattr(res, name))
    if not torch.cuda.is_available():   # the default device is cuda
        with pytest.raises(RuntimeError, match="cuda"):
            load_checkpoint(p)
