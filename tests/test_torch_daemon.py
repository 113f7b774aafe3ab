"""The port's serving daemon (``ptv_interpolation_tpu_torch/daemon.py``),
the counterpart of ``tests/test_daemon.py``: a real server subprocess on
the CPU (``PTV_DAEMON_PLATFORM=cpu``, ``--device cpu`` in every job),
its protocol and control commands as the JAX package's, and its NPZ
against an inline run of the port and the JAX CLI's. Every wait on the
socket is bounded, and every server started here is stopped (and, if it
does not stop, killed) in teardown."""

import concurrent.futures
import os
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu import daemon as jax_daemon
from ptv_interpolation_tpu.datasets import sphere_pack
from ptv_interpolation_tpu_torch import daemon

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 180.0          # bound on any one request or control command
# the port's pipeline tolerance (tests/test_torch_pipeline.py)
RTOL, ATOL = 1e-5, 1e-6


def _bounded(fn, *args, timeout=WAIT_S, **kwargs):
    """``fn(*args, **kwargs)`` on a worker thread, failing the test if it
    takes longer than ``timeout``: a request whose server hangs cannot
    hang the test run."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(fn, *args, **kwargs).result(timeout=timeout)
    finally:
        pool.shutdown(wait=False)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_daemon_data")
    csv = str(d / "pts.csv")
    tif = str(d / "mask.tif")
    sphere_pack.generate(n_points=1500, size=32, filename=csv, maskname=tif,
                         voxel_units=True)
    return d, csv, tif


def _argv(csv, tif, npz, *extra):
    return ["--input", csv, "--mask", tif, "--invert-mask", "--method",
            "sibson", "--sibson-neighbors", "15", "--filter-outliers",
            "--output-npz", npz, "--no-plot", *extra]


@pytest.fixture()
def daemon_env(tmp_path, monkeypatch):
    """The server's environment, and every server process spawned during
    the test, stopped in teardown."""
    monkeypatch.setenv("PTV_DAEMON_DIR", str(tmp_path / "sock"))
    monkeypatch.setenv("PTV_DAEMON_PLATFORM", "cpu")
    monkeypatch.setenv("PTV_DAEMON_IDLE_S", "300")
    monkeypatch.setenv("PYTHONPATH",
                       REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.delenv("PTV_IN_DAEMON", raising=False)
    spawned = []
    popen = subprocess.Popen

    def record(args, *a, **kw):
        proc = popen(args, *a, **kw)
        if "ptv_interpolation_tpu_torch.daemon" in args:
            spawned.append(proc)
        return proc

    monkeypatch.setattr(daemon.subprocess, "Popen", record)
    yield spawned
    try:
        _bounded(daemon.main, ["stop"], timeout=30)
    finally:
        for proc in spawned:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)


def _fields(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_dispatch_twice_matches_inline_and_jax(dataset, daemon_env, capsys,
                                               monkeypatch):
    """Two jobs on one warm server give the same NPZ bit for bit, equal to
    an inline run of the port's CLI and, at the pipeline tolerance, to
    the JAX package's CLI; the output streams back; a bad argv returns a
    nonzero rc and the server stays up; ``analyze`` is served too, in the
    caller's directory."""
    d, csv, tif = dataset
    monkeypatch.chdir(d)
    assert daemon.main(["status"]) == 1
    npz = [str(d / f"d{i}.npz") for i in (1, 2)]
    for path in npz:
        rc = _bounded(daemon.dispatch, "interpolate",
                      _argv(csv, tif, path, "--device", "cpu"))
        assert rc == 0
        assert "Done." in capsys.readouterr().out
    assert len(daemon_env) == 1               # one server served both
    assert daemon.main(["status"]) == 0
    first, second = _fields(npz[0]), _fields(npz[1])
    assert sorted(first) == sorted(second)
    for k in first:
        np.testing.assert_array_equal(second[k], first[k])

    from ptv_interpolation_tpu.cli.main import main as jax_main
    from ptv_interpolation_tpu_torch.cli.main import main as port_main
    inline = str(d / "inline.npz")
    port_main(_argv(csv, tif, inline, "--device", "cpu"))
    for k, v in _fields(inline).items():
        np.testing.assert_array_equal(first[k], v)
    jax_npz = str(d / "jax.npz")
    jax_main(_argv(csv, tif, jax_npz))
    want = _fields(jax_npz)
    assert sorted(want) == sorted(first)
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(first[k], want[k], rtol=RTOL, atol=ATOL)

    rc = _bounded(daemon.dispatch, "analyze",
                  ["--input", npz[0], "--no-drag", "--no-tiffs",
                   "--output-npz", str(d / "a.npz"), "--device", "cpu"])
    assert rc == 0
    with np.load(d / "a.npz") as a:
        assert np.isfinite(a["pressure"]).all()
    assert (d / "d1_stats.txt").exists()

    rc = _bounded(daemon.dispatch, "interpolate", ["--definitely-not-a-flag"])
    assert rc not in (0, None)
    assert daemon.main(["status"]) == 0
    assert len(daemon_env) == 1


def test_cli_flags_dispatch_to_the_daemon(dataset, daemon_env, monkeypatch,
                                          capsys):
    """``--daemon`` and ``PTV_DAEMON=1`` send both CLIs to the server
    (``--no-plot`` / ``--no-interactive`` forced): the rc is the daemon's,
    and no inline line is printed."""
    from ptv_interpolation_tpu_torch.cli import analyze_flow
    from ptv_interpolation_tpu_torch.cli.main import main as port_main
    d, csv, tif = dataset
    monkeypatch.chdir(d)
    npz = str(d / "flag.npz")
    argv = [a for a in _argv(csv, tif, npz, "--device", "cpu", "-D")
            if a != "--no-plot"]
    assert _bounded(port_main, argv) == 0
    monkeypatch.setenv("PTV_DAEMON", "1")
    assert _bounded(analyze_flow.main,
                    ["--input", npz, "--no-drag", "--no-tiffs",
                     "--no-output-npz", "--device", "cpu"]) == 0
    assert len(daemon_env) == 1
    captured = capsys.readouterr()
    assert "running inline" not in captured.err
    assert os.path.exists(npz)


def test_control_commands_match_jax(daemon_env, capsys):
    """``status``, ``start``, ``stop`` as the JAX package's: start twice
    spawns once, stop removes the socket, stop with none running is 0."""
    path = daemon.socket_path()
    assert daemon.main(["status"]) == 1
    assert "no daemon running" in capsys.readouterr().out
    assert _bounded(daemon.main, ["start"]) == 0
    assert "daemon started at" in capsys.readouterr().out
    assert _bounded(daemon.main, ["start"]) == 0
    assert "already running" in capsys.readouterr().out
    assert len(daemon_env) == 1
    assert daemon.main(["status"]) == 0
    assert _bounded(daemon.main, ["stop"], timeout=30) == 0
    assert not os.path.exists(path)
    assert daemon.main(["status"]) == 1
    assert daemon.main(["stop"]) == 0
    assert "no daemon running" in capsys.readouterr().out
    assert daemon.main(["bogus"]) == 2


def test_failed_spawn_runs_inline(dataset, tmp_path, monkeypatch, capsys):
    """``--daemon`` with a server that cannot start: the JAX package's
    stderr line, then the inline run on ``--device``."""
    from ptv_interpolation_tpu_torch.cli.main import main as port_main
    d, csv, tif = dataset
    monkeypatch.setenv("PTV_DAEMON_DIR", str(tmp_path / "nosock"))
    monkeypatch.delenv("PTV_IN_DAEMON", raising=False)
    monkeypatch.setattr(daemon, "_spawn", lambda *a, **k: False)
    npz = str(tmp_path / "inline.npz")
    rc = port_main(_argv(csv, tif, npz, "--device", "cpu", "--daemon"))
    assert rc in (0, None)
    assert "daemon unavailable; running inline" in capsys.readouterr().err
    assert os.path.exists(npz)


def test_cli_tau_mode_approx_matches_jax(dataset):
    """``--tau-mode approx`` runs: served by exact selection, its NPZ is
    bit for bit that of ``--tau-mode exact``, and within the pipeline
    tolerance of the JAX CLI's ``approx_min_k`` run (an exact sort on
    the CPU)."""
    from ptv_interpolation_tpu.cli.main import main as jax_main
    from ptv_interpolation_tpu_torch.cli.main import main as port_main
    d, csv, tif = dataset
    out = {m: str(d / f"tau_{m}.npz") for m in ("approx", "exact", "jax")}
    for m in ("approx", "exact"):
        port_main(_argv(csv, tif, out[m], "--tau-mode", m, "--device",
                        "cpu"))
    jax_main(_argv(csv, tif, out["jax"], "--tau-mode", "approx"))
    got, exact, want = (_fields(out[m]) for m in ("approx", "exact", "jax"))
    for k in got:
        np.testing.assert_array_equal(got[k], exact[k])
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


def test_socket_path_differs_from_jax(tmp_path, monkeypatch):
    """Under one ``PTV_DAEMON_DIR`` (and under the default) the port's
    socket is not the JAX package's, in the same directory."""
    for env in (str(tmp_path), None):
        if env is None:
            monkeypatch.delenv("PTV_DAEMON_DIR", raising=False)
        else:
            monkeypatch.setenv("PTV_DAEMON_DIR", env)
        mine, theirs = daemon.socket_path(), jax_daemon.socket_path()
        assert mine != theirs
        assert os.path.dirname(mine) == os.path.dirname(theirs)


def _serve_in_thread(path):
    t = threading.Thread(target=daemon.serve, args=(path, 60.0), daemon=True)
    t.start()
    deadline = time.time() + 30
    while not os.path.exists(path):
        assert time.time() < deadline, "server did not bind its socket"
        time.sleep(0.02)
    return t


@pytest.mark.parametrize("error,exits", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (RuntimeError("fused_grid_knn kernel launch failed: invalid argument "
                  "(cudaError 1)"), True),
    (ValueError("not a device fault"), False),
])
def test_cuda_error_ends_the_server(tmp_path, monkeypatch, error, exits):
    """A job that fails with a CUDA error gets rc 1 and the server exits
    (its context is unusable; the next dispatch spawns a fresh one);
    another exception leaves it serving, as in the JAX package."""
    monkeypatch.setenv("PTV_DAEMON_DIR", str(tmp_path / "sock"))
    monkeypatch.setenv("PTV_DAEMON_PLATFORM", "cpu")

    def fail(entry, argv):
        raise error

    monkeypatch.setattr(daemon, "_run_entry", fail)
    path = daemon.socket_path()
    server = _serve_in_thread(path)
    try:
        rc = _bounded(daemon.dispatch, "interpolate", [], spawn=False,
                      timeout=30)
        assert rc == 1
        server.join(timeout=10 if exits else 0.5)
        assert server.is_alive() != exits
        assert os.path.exists(path) != exits
        if not exits:
            assert _bounded(daemon.main, ["status"], timeout=30) == 0
    finally:
        if server.is_alive():
            _bounded(daemon.main, ["stop"], timeout=30)
            server.join(timeout=10)
    assert not server.is_alive()


def test_serve_refuses_to_start_without_a_card(tmp_path, monkeypatch):
    """Without ``PTV_DAEMON_PLATFORM=cpu`` the server warms the card, and
    with no card it fails to start rather than serve cold."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the warm-up would succeed")
    monkeypatch.delenv("PTV_DAEMON_PLATFORM", raising=False)
    path = str(tmp_path / "sock" / "torch-daemon.sock")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        daemon.serve(path, idle_s=5.0)
    assert not os.path.exists(path)
