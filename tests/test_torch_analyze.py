"""The port's ``analyze.py`` and its two CLIs against the JAX package's,
run on the CPU.

``run_analysis`` on the 32³ gyroid field of
``tools/profile_analysis.py::make_field``: the same result keys, fields
at rtol 1e-5 / atol 1e-6 of the field's max, drag entries at rtol 1e-4
of the label's force scale (the JAX package takes the host mesh
extractor off the TPU, the port its device pipeline), the two
permeabilities within 1e-4 of an f64 evaluation of their formula on the
same f32 inputs and within 1e-4 plus JAX's own distance from it of JAX's
value (XLA's sequential f32 mean on the CPU is off by up to ~1e-4 at
32³); the same stats-log lines, text equal between the numbers and each
number at rtol 1e-3 (on the force scale for drag lines); the same files
and NPZ keys. Then both CLIs' parsers against the JAX parsers, the
pipeline CLI followed by the analysis CLI on the sphere-pack dataset,
and the port's new modules imported with JAX blocked.
"""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.analyze import AnalyzeConfig as JaxConfig
from ptv_interpolation_tpu.analyze import run_analysis as jax_run
from ptv_interpolation_tpu.io.npz import FieldResult as JaxField
from ptv_interpolation_tpu_torch.analyze import AnalyzeConfig, run_analysis
from ptv_interpolation_tpu_torch.io import FieldResult

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from profile_analysis import make_field  # noqa: E402

FIELD_RTOL, FIELD_ATOL = 1e-5, 1e-6
SCALAR_RTOL = 1e-4
LOG_RTOL = 1e-3
N = 32


@functools.lru_cache(maxsize=None)
def _field():
    return make_field(N)


def _pore_mask(path):
    """A background pore mask (TIFF) splitting the box at x = N/2."""
    from ptv_interpolation_tpu_torch.io.tiff import write_tiff
    bg = np.zeros((N, N, N), np.uint8)
    bg[:, :, N // 2:] = 1
    write_tiff(path, bg)
    return path


CONFIGS = {
    "default": {},
    "flow_type": dict(flow_type=True),
    "staircase": dict(drag_method="staircase", flow_type=True),
    "pore_mask": dict(pore_mask="pore.tif"),
    "scaling": dict(voxel_size=2e-6, dt=0.05, rho=1000.0,
                    pressure_anchor="inlet"),
}


def _run_both(name, tmp_path):
    kw = dict(CONFIGS[name])
    if "pore_mask" in kw:
        kw["pore_mask"] = _pore_mask(str(tmp_path / kw["pore_mask"]))
    u, v, w, x, y, z, fluid = _field()
    out = {}
    for tag, cfg_cls, field_cls, run, extra in (
            ("jax", JaxConfig, JaxField, jax_run, {}),
            ("port", AnalyzeConfig, FieldResult, run_analysis,
             {"device": "cpu"})):
        base = str(tmp_path / tag / "field")
        os.makedirs(os.path.dirname(base))
        cfg = cfg_cls(input="field.npz", basename=base, verbose=False,
                      output_npz=base + "_analysis.npz", **kw)
        results, log = run(cfg, field=field_cls(x=x, y=y, z=z, u=u, v=v,
                                                w=w, mask=fluid), **extra)
        out[tag] = (results, log, base)
    return out


_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\d+)(?:e[-+]?\d+)?")


def _force_scale(drag):
    return max((abs(val) for r in drag.values() for k, val in r.items()
                if k.startswith("F")), default=0.0)


def _check_log(got, want, drag_scale):
    assert len(got) == len(want)
    in_drag = False
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        in_drag = in_drag or "Interface Drag" in w
        for a, b in zip(_NUMBER.findall(g), _NUMBER.findall(w)):
            a, b = float(a), float(b)
            tol = LOG_RTOL * abs(b)
            if in_drag and "(N)" in w:
                tol = max(tol, LOG_RTOL * drag_scale)
            assert abs(a - b) <= tol, (g, w)


def _f64_permeabilities(cfg_kw, results):
    """k_diss and k_press from their formulas in f64 on the f32 inputs."""
    u, v, w, x, y, z, fluid = _field()
    scale = cfg_kw.get("voxel_size", 1.0) / cfg_kw.get("dt", 1.0)
    h = cfg_kw.get("voxel_size", 1.0)
    uvw = [(np.asarray(a * fluid, np.float64) * scale).astype(np.float32)
           .astype(np.float64) for a in (u, v, w)]
    mu = 0.001
    u0 = np.asarray([a.mean() for a in uvw])
    phi = results["dissipation"].astype(np.float64)
    k_diss = mu * (u0 @ u0) / phi.mean()
    dpz, dpy, dpx = np.gradient(results["pressure"].astype(np.float64),
                                h, h, h)
    g = np.asarray([dpx.mean(), dpy.mean(), dpz.mean()])
    return k_diss, -mu * (u0 @ g) / (g @ g)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_analysis_matches_jax(name, tmp_path):
    both = _run_both(name, tmp_path)
    (want, want_log, want_base), (got, got_log, got_base) = (
        both["jax"], both["port"])
    assert set(got) == set(want)
    scale = _force_scale(want["drag"])
    for k, val in want.items():
        if isinstance(val, np.ndarray):
            assert got[k].shape == val.shape and got[k].dtype == val.dtype
            np.testing.assert_allclose(
                got[k], val, rtol=FIELD_RTOL,
                atol=FIELD_ATOL * max(np.abs(val).max(), 1e-30))
        elif k == "drag":
            assert set(got[k]) == set(val)
            volume = (N * CONFIGS[name].get("voxel_size", 1.0)) ** 3
            for label, r in val.items():
                assert set(got[k][label]) == set(r)
                for q, x in r.items():
                    s = scale / volume if q.startswith("M") else scale
                    tol = (SCALAR_RTOL * abs(r["Area"])
                           if q.startswith("Area") else SCALAR_RTOL * s)
                    assert abs(got[k][label][q] - x) <= tol, (q, x)
        elif k.startswith("permeability"):
            f64 = dict(zip(("permeability_dissipation",
                            "permeability_pressure"),
                           _f64_permeabilities(CONFIGS[name], got)))[k]
            assert abs(got[k] - f64) <= SCALAR_RTOL * abs(f64)
            assert abs(got[k] - val) <= (SCALAR_RTOL * abs(f64)
                                         + abs(val - f64))
        else:
            assert got[k] == val
    # the solid is exactly 0 in every derived field
    fluid = _field()[-1]
    for k in ("strain_rate", "dissipation", "vorticity_magnitude"):
        assert not got[k][~fluid].any()
    _check_log([ln.replace(os.path.dirname(got_base), "D") for ln in got_log],
               [ln.replace(os.path.dirname(want_base), "D")
                for ln in want_log], scale)

    # the same files, with the same NPZ keys
    def files(base):
        d = os.path.dirname(base)
        return sorted(f.replace(os.path.basename(base), "B")
                      for f in os.listdir(d))

    assert files(got_base) == files(want_base)
    with np.load(got_base + "_analysis.npz") as g, \
            np.load(want_base + "_analysis.npz") as w:
        assert sorted(g.files) == sorted(w.files)
    with open(got_base + "_stats.txt") as f:
        assert f.read() == "\n".join(got_log)


def test_run_analysis_without_mask_or_stages(tmp_path):
    """No mask, no pressure, no drag, no TIFFs: only the derivative stage
    and the dissipation permeability run."""
    u, v, w, x, y, z, _ = _field()
    kw = dict(input="f.npz", basename=str(tmp_path / "f"), verbose=False,
              pressure=False, drag=False, save_tiffs=False,
              permeability_pressure=False)
    want, wlog = jax_run(JaxConfig(**kw), field=JaxField(
        x=x, y=y, z=z, u=u, v=v, w=w, mask=None))
    got, glog = run_analysis(AnalyzeConfig(**kw), field=FieldResult(
        x=x, y=y, z=z, u=u, v=v, w=w, mask=None), device="cpu")
    assert set(got) == set(want) and "pressure" not in got
    np.testing.assert_allclose(got["strain_rate"], want["strain_rate"],
                               rtol=FIELD_RTOL,
                               atol=FIELD_ATOL * want["strain_rate"].max())
    _check_log(glog, wlog, 0.0)
    assert sorted(os.listdir(tmp_path)) == ["f_stats.txt"]


# --- the CLIs ---------------------------------------------------------------

PIPELINE_ARGS = [
    ["--input", "a.csv"],
    ["-i", "a.csv", "-m", "m.tif", "-s", "2", "-d", "--iter", "5",
     "--cleaning-method", "variational", "--cleaning-lambda", "200",
     "-o", "o.tif", "--output-npz", "o.npz", "--method", "sibson",
     "--sibson-neighbors", "50", "--boundary-particles",
     "--boundary-sampling", "50", "--boundary-thickness", "2",
     "--filter-outliers", "--filter-neighbors", "30",
     "--filter-threshold", "4", "--filter-max-speed", "5", "--no-plot"],
    ["-i", "a.csv", "--crop", "0", "10", "0", "12", "0", "14", "--method",
     "rbf", "--rbf-neighbors", "12", "--rbf-kernel", "cubic", "--smoothing",
     "0.5", "--invert-mask", "--data-offset", "1", "2", "3", "--swap-xy",
     "--mask-transpose", "2", "1", "0", "--n-jobs", "4", "--tau-mode",
     "exact", "--cubic-fallback", "--tri-cache-dir", "c", "-D"],
    ["-i", "a.csv", "--method", "idw", "--idw-power", "3",
     "--idw-neighbors", "20"],
]

ANALYZE_ARGS = [
    [],
    ["--input", "f.npz", "--no-interactive", "--no-drag"],
    ["-i", "f.npz", "--no-strain-rate", "--no-dissipation", "--no-vorticity",
     "--no-permeability_dissipation", "--no-permeability_pressure",
     "--no-pressure", "--no-tiffs", "--no-output-npz", "--no-log-scale"],
    ["-i", "f.npz", "--pressure-wall-bc", "inhomogeneous",
     "--pressure-anchor", "none", "--viscosity", "0.002", "--rho", "998",
     "--flow-direction", "negative", "--drag-labels", "1", "2",
     "--drag-method", "staircase", "--drag-mesh-step", "2", "--pore-mask",
     "p.tif", "--voxel-size", "1e-6", "--dt", "0.1", "--output-npz", "o.npz",
     "--output-tif-strain", "s.tif", "--output-tif-dissipation", "d.tif",
     "--output-tif-vorticity", "v.tif", "--output-tif-pressure", "p2.tif",
     "--plot-strain", "--plot-flowtype", "--no-plot-velocity", "--daemon"],
    ["-i", "f.npz", "--strain-rate", "--dissipation", "--pressure", "--drag",
     "--plot-pressure", "--no-plot-pressure", "--interactive", "--log-scale"],
]


@pytest.mark.parametrize("cli,args", [("main", a) for a in PIPELINE_ARGS]
                         + [("analyze_flow", a) for a in ANALYZE_ARGS])
def test_parsers_match_jax(cli, args):
    import importlib
    jax_cli = importlib.import_module(f"ptv_interpolation_tpu.cli.{cli}")
    port_cli = importlib.import_module(
        f"ptv_interpolation_tpu_torch.cli.{cli}")
    want = vars(jax_cli.build_parser().parse_args(args))
    got = vars(port_cli.build_parser().parse_args(args))
    assert got.pop("device") == "cuda"
    assert got == want
    got = vars(port_cli.build_parser().parse_args(args + ["--device", "cpu"]))
    assert got.pop("device") == "cpu" and got == want


def _recipe(cli_pkg, workdir, extra):
    """The verify recipe: the pipeline CLI (IDW, divergence cleaning, NPZ
    and TIFF) then the analysis CLI without drag; returns the files."""
    import importlib
    main = importlib.import_module(f"{cli_pkg}.cli.main")
    analyze = importlib.import_module(f"{cli_pkg}.cli.analyze_flow")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        main.main(["--input", "spheres_ptv.csv", "--mask", "spheres_mask.tif",
                   "--invert-mask", "--method", "idw", "--divergence-free",
                   "--output-npz", "out.npz", "--output-tif", "out.tif",
                   "--no-plot"] + extra)
        analyze.main(["--input", "out.npz", "--no-interactive",
                      "--no-drag"] + extra)
    finally:
        os.chdir(cwd)
    return sorted(os.listdir(workdir))


def test_cli_recipe_writes_the_jax_files(tmp_path, capsys):
    from ptv_interpolation_tpu_torch.datasets import sphere_pack
    dirs = {t: tmp_path / t for t in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
        sphere_pack.generate(size=32, filename=str(d / "spheres_ptv.csv"),
                             maskname=str(d / "spheres_mask.tif"))
    want = _recipe("ptv_interpolation_tpu", dirs["jax"], [])
    got = _recipe("ptv_interpolation_tpu_torch", dirs["port"],
                  ["--device", "cpu"])
    assert got == want
    assert {"out.npz", "out.tif", "out_analysis.npz", "out_stats.txt",
            "out_strain.tif", "out_pressure.tif"} <= set(got)
    for f in ("out.npz", "out_analysis.npz"):
        with np.load(dirs["port"] / f) as g, np.load(dirs["jax"] / f) as w:
            assert sorted(g.files) == sorted(w.files)
    with np.load(dirs["port"] / "out_analysis.npz") as g:
        assert np.isfinite(g["pressure"]).all()
    assert capsys.readouterr().out.rstrip().endswith("Done.")


def test_daemon_flag_runs_inline(tmp_path, capsys, monkeypatch):
    """``-D`` with a daemon that cannot start: the stderr line, then the
    inline run (``tests/test_daemon.py``'s fallback)."""
    from ptv_interpolation_tpu_torch import daemon
    from ptv_interpolation_tpu_torch.cli import analyze_flow
    monkeypatch.setenv("PTV_DAEMON_DIR", str(tmp_path / "nosock"))
    monkeypatch.setattr(daemon, "_spawn", lambda *a, **k: False)
    u, v, w, x, y, z, fluid = _field()
    from ptv_interpolation_tpu_torch.io import save_field_npz
    path = str(tmp_path / "f.npz")
    save_field_npz(path, FieldResult(x=x, y=y, z=z, u=u, v=v, w=w,
                                     mask=fluid))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        analyze_flow.main(["-i", path, "-D", "--no-drag", "--no-pressure",
                           "--no-tiffs", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert "daemon unavailable; running inline" in capsys.readouterr().err
    assert (tmp_path / "f_analysis.npz").exists()


NEW_MODULES = (
    "ptv_interpolation_tpu_torch",
    "ptv_interpolation_tpu_torch.ops.sampling",
    "ptv_interpolation_tpu_torch.analysis",
    "ptv_interpolation_tpu_torch.surface",
    "ptv_interpolation_tpu_torch.drag",
    "ptv_interpolation_tpu_torch.analyze",
    "ptv_interpolation_tpu_torch.viz",
    "ptv_interpolation_tpu_torch.viz.scalar",
    "ptv_interpolation_tpu_torch.viz.slices",
    "ptv_interpolation_tpu_torch.cli",
    "ptv_interpolation_tpu_torch.cli.main",
    "ptv_interpolation_tpu_torch.cli.analyze_flow",
    "ptv_interpolation_tpu_torch.daemon",
)


def test_new_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ptv_interpolation_tpu'] = None\n"
        "import importlib\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from ptv_interpolation_tpu_torch.cli import analyze_flow, main\n"
        "analyze_flow.build_parser(); main.build_parser()\n"
        "print('ok')\n")
    env = {k: val for k, val in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
